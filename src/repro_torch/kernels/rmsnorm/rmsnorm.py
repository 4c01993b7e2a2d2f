"""RMSNorm over the last dimension, port of ``repro.kernels.rmsnorm.rmsnorm``
(``rmsnorm_pallas``).

  * :func:`rmsnorm_cuda` — the hand-written kernel (``csrc/rmsnorm.cu``):
    x (R, D) and scale (D,), both bf16 or both f32, any R and D. It takes
    its plain version for a CPU tensor and launches the kernel for a CUDA
    tensor; anything else raises.
  * :func:`rmsnorm_ref` — the plain version, the same function: the mean
    of squares, the normalisation and the scale in f32, one rounding to
    x's type (the TPU kernel's body, ``rmsnorm.py:14-19``).

The JAX model stack's own ``layers.rmsnorm`` rounds to x's type before it
multiplies by the scale; that equals this function when the scale is 1
(every norm scale at init) and otherwise differs by at most one rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """Plain version: ``(x * rsqrt(mean(x^2) + eps)) * scale`` in f32,
    rounded once to x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """x (R, D), scale (D,) -> (R, D) in x's type."""
    if not on_cuda(x):
        return rmsnorm_ref(x, scale, eps)
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise TypeError(f"x: expected 2-d bf16 or f32, got {x.dim()}-d "
                        f"{x.dtype}")
    r, d = x.shape
    if (scale.dim() != 1 or scale.shape[0] != d or scale.dtype != x.dtype
            or scale.device != x.device):
        raise TypeError(f"scale: expected ({d},) {x.dtype} on {x.device}, got "
                        f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    if r == 0 or d == 0:
        return out
    if d >= 2**31:
        raise ValueError(f"D = {d} exceeds int32")
    per_vec = 16 // x.element_size()
    vec = d % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, out))
    lib = build.library()
    with torch.cuda.device(x.device):
        build.count_launch("rmsnorm")
        build.check(lib.repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), r, d,
            ctypes.c_float(eps), DTYPES[x.dtype], int(vec),
            build.stream_of(x),
        ), "rmsnorm")
    return out
