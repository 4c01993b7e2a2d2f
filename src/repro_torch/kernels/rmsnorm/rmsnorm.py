"""RMSNorm over the last dimension, port of ``repro.kernels.rmsnorm.rmsnorm``
(``rmsnorm_pallas``).

  * :func:`rmsnorm_cuda` — the hand-written kernel (``csrc/rmsnorm.cu``):
    x (..., D) bf16 or f32 and scale (D,) bf16 or f32, of either type
    whatever x's (the TPU kernel casts any scale to f32), any number of
    rows and any D. It takes its plain version for a CPU tensor and
    launches the kernel for a CUDA tensor; anything else raises.
  * :func:`rmsnorm_ref` — the plain version, the same function: the mean
    of squares, the normalisation and the scale in f32, one rounding to
    x's type (the TPU kernel's body, ``rmsnorm.py:14-19``).

The JAX model stack's own ``layers.rmsnorm`` rounds to x's type before it
multiplies by the scale; that equals this function when the scale is 1
(every norm scale at init) and otherwise differs by at most one rounding.

The decode step calls the wrapper 97 times, so its host time counts: it
checks with cheap tensor queries, copies only what is not contiguous, and
launches through :func:`build.launch`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

#: kernel types -> the C entry's type flag (1 = bf16, 0 = f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the C entry ``repro_rmsnorm``, bound at the first launch
_kernel = None


def _bind():
    global _kernel
    _kernel = build.library().repro_rmsnorm
    return _kernel


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """Plain version: ``(x * rsqrt(mean(x^2) + eps)) * scale`` in f32,
    rounded once to x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """x (..., D), scale (D,) -> x's shape in x's type."""
    if not (x.is_cuda or on_cuda(x)):
        return rmsnorm_ref(x, scale, eps)
    xt, st = DTYPES.get(x.dtype), DTYPES.get(scale.dtype)
    if xt is None or x.dim() == 0:
        raise TypeError(f"x: expected bf16 or f32 with a last dimension, got "
                        f"{x.dim()}-d {x.dtype}")
    d = x.size(-1)
    dev = x.get_device()
    if (st is None or scale.dim() != 1 or scale.size(0) != d
            or scale.get_device() != dev):
        raise TypeError(f"scale: expected ({d},) bf16 or f32 on {x.device}, "
                        f"got {tuple(scale.shape)} {scale.dtype} on "
                        f"{scale.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    if d >= 2**31:
        raise ValueError(f"D = {d} exceeds int32")
    build.launch("rmsnorm", _kernel or _bind(), dev, x.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), rows, d, eps, xt, st)
    return out
