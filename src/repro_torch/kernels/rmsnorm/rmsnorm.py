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

The gradient (the port's own: the JAX package differentiates its jnp norm
and has no backward kernel):

  * :func:`rmsnorm_bwd_cuda` — the hand-written backward (``csrc/rmsnorm.cu``,
    ``repro_rmsnorm_bwd``): x, scale, dy -> (dx in x's type, dscale in
    scale's type), the dscale column sums in a fixed order (no atomics).
    Its plain version for a CPU tensor, the kernel for a CUDA tensor.
  * :func:`rmsnorm_bwd_ref` — its plain version, from the formulas.
  * :class:`RMSNormFn` — the ``torch.autograd.Function`` whose two
    directions are the two kernels; :func:`rmsnorm` (what the model calls)
    goes through it on a CUDA tensor when a gradient is wanted, straight to
    the forward kernel otherwise, and takes the plain version (which
    autograd differentiates) on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counting
from repro_torch.kernels.dispatch import on_cuda

#: kernel types -> the C entry's type flag (1 = bf16, 0 = f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the C entry ``repro_rmsnorm``, bound at the first launch
_kernel = None
#: the C entry ``repro_rmsnorm_bwd`` and its most partial-sum rows, bound at
#: the first launch of the backward
_bwd = None
_bwd_ctas = 0
#: widest row the backward takes (its column sums live in shared memory)
MAX_BWD_D = 49152


def _bind():
    global _kernel
    _kernel = build.library().repro_rmsnorm
    return _kernel


def _bind_bwd():
    global _bwd, _bwd_ctas
    lib = build.library()
    _bwd_ctas = lib.repro_rmsnorm_bwd_ctas()
    _bwd = lib.repro_rmsnorm_bwd
    return _bwd


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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """Plain version of the backward, in f32: with r = rsqrt(mean(x^2) +
    eps), x^ = x r and g = dy scale, ``dx = r (g - x^ mean(g x^))`` in x's
    type and ``dscale = sum over rows of dy x^`` in scale's type."""
    xf, g = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xh = xf * r
    gs = g * scale.float()
    mean = (gs * xh).mean(dim=-1, keepdim=True)
    dx = r * (gs - xh * mean)
    dscale = (g * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5):
    """x (..., D), scale (D,), dy like x -> (dx like x, dscale like scale)."""
    if not on_cuda(x):
        return rmsnorm_bwd_ref(x, scale, dy, eps)
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
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"dy: expected {tuple(x.shape)} {x.dtype} on "
                        f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                        f"{dy.device}")
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(scale)
    if d > MAX_BWD_D:
        raise ValueError(f"D = {d}: the backward takes rows up to "
                         f"{MAX_BWD_D} wide")
    fn = _bwd or _bind_bwd()
    dscale = torch.empty_like(scale)
    partial = torch.empty((min(rows, _bwd_ctas), d), dtype=torch.float32,
                          device=x.device)
    build.launch("rmsnorm_bwd", fn, dev, x.data_ptr(), scale.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 partial.data_ptr(), rows, d, eps, xt, st)
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with both directions on the card: the forward kernel, and
    the backward kernel on the saved x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm_cost(x: torch.Tensor, scale: torch.Tensor, backward=False):
    """(FLOPs, bytes) of one launch on x's rows: the forward reads x and
    the scale and writes the output, 4 operations an element; the backward
    reads x, dy and the scale and writes dx and dscale, 10 an element."""
    d = x.shape[-1]
    r = x.numel() // d if d else 0
    es, ss = x.element_size(), scale.element_size()
    if backward:
        return 10.0 * r * d, 3.0 * r * d * es + 2.0 * d * ss
    return 4.0 * r * d, 2.0 * r * d * es + d * ss


class _CountedRMSNorm(torch.autograd.Function):
    """The dry run's stand-in (``kernels.counting``): charges the forward
    and the backward kernel, launches nothing."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xl, sl = counting.local(x), counting.local(scale)
        counting.active().charge("rmsnorm", *rmsnorm_cost(xl, sl))
        ctx.save_for_backward(x, scale)
        return counting.like(x, xl.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xl, sl = counting.local(x), counting.local(scale)
        counting.active().charge("rmsnorm_bwd",
                                 *rmsnorm_cost(xl, sl, backward=True))
        dscale = counting.like(
            scale, sl.shape, placements=(counting.reduced_placements(
                x, scale) if hasattr(x, "placements") else None))
        return counting.like(x, xl.shape), dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """What the model calls: on a CPU tensor the plain version (autograd
    differentiates it); on a CUDA tensor the kernel, through
    :class:`RMSNormFn` when autograd records and x or the scale wants a
    gradient, so that the backward is the backward kernel. While the dry
    run counts (``kernels.counting``), the kernels' charge."""
    if counting.active() is not None:
        return _CountedRMSNorm.apply(x, scale, eps)
    if not on_cuda(x):
        return rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return rmsnorm_cuda(x, scale, eps)
