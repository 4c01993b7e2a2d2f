"""Public wrapper: any leading dims (no row padding: the kernel takes any
number of rows, and the wrapper any leading shape, without a reshape)."""
from __future__ import annotations

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda as rmsnorm

__all__ = ["rmsnorm"]
