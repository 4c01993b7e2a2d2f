"""Public wrapper: any leading dims (no row padding: the kernel takes any
number of rows)."""
from __future__ import annotations

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda


def rmsnorm(x, scale, eps=1e-5):
    """x (..., D), scale (D,) -> (..., D): the kernel on a CUDA tensor, its
    plain version on a CPU tensor."""
    shape = x.shape
    return rmsnorm_cuda(x.reshape(-1, shape[-1]), scale, eps).reshape(shape)
