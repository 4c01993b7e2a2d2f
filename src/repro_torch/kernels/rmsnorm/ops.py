"""Public wrapper: any leading dims (no row padding: the kernel takes any
number of rows, and the wrapper any leading shape, without a reshape), and
a gradient through the backward kernel on the card."""
from __future__ import annotations

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm

__all__ = ["rmsnorm"]
