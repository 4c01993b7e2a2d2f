"""Causal grouped-query attention with an online softmax, port of
``repro.kernels.flash_attention.flash_attention`` (``flash_attention_bhsd``
and the GQA wrapper of ``ops.py``).

  * :func:`flash_attention_cuda` — the hand-written kernel
    (``csrc/flash_attention.cu``): q (B, Sq, H, D), k and v (B, Sk, KV, D),
    read at their strides with head h reading KV head h // (H / KV), so
    the repeat and the transposes of the reference's wrapper are never
    materialised. Any Sq and Sk; D a multiple of 8 up to 256. bf16 runs on
    the tensor cores (wgmma, TMA) and rounds the softmax weights to bf16
    before the weighted sum, as the TPU kernel's MXU does; f32 runs on the
    CUDA cores. ``window`` w > 0 also drops key j for query i where
    j <= i - w (the JAX model's ``_sdpa``), and the kernel skips the key
    tiles wholly before a q tile's window. It takes its plain version for
    a CPU tensor and launches the kernel for a CUDA tensor; anything else
    raises.
  * :func:`flash_attention_ref` — the plain version, the same function:
    f32 scores scaled by D^-1/2, the start-aligned causal mask
    ``q_pos >= k_pos`` (positions from 0, also when Sq != Sk) and the
    window's ``k_pos > q_pos - window``, an f32 softmax and an f32 weighted
    sum, rounded once to q's type (the reference's ``ref.py:attention_ref``
    with the GQA mapping).

The forward can also return each row's log-sum-exp of its scaled scores
(``return_lse=True``: (B, H, Sq) f32, natural log; -inf for a row with no
key), which the backward reads. The gradient is the port's own (the JAX
package differentiates jnp attention and has no backward kernel):

  * :func:`flash_attention_bwd_cuda` — the hand-written backward
    (``csrc/flash_attention_bwd.cu``): q, k, v, out, dout, lse -> dq
    (B, Sq, H, D), dk and dv (B, Sk, KV, D) summed over each KV head's
    query heads, the same masks, D and types as the forward, P recomputed
    from the lse, no atomics. bf16 runs on the tensor cores (wgmma, TMA),
    rounds P to bf16 for dV's product and gives dS to dK's and dQ's as two
    bf16 terms; f32 runs on the CUDA cores. Its plain version for a CPU
    tensor, the kernels for a CUDA tensor.
  * :func:`flash_attention_bwd_ref` — its plain version, from the formulas.
  * :class:`FlashAttentionFn` — the ``torch.autograd.Function`` whose two
    directions are the two kernels (``ops.flash_attention`` goes through it
    on a CUDA tensor when a gradient is wanted).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counting
from repro_torch.kernels.dispatch import on_cuda

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _mask(sq, sk, causal, window, device):
    """(Sq, Sk) bool of the keys each query keeps, or None for all."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = qpos >= kpos if causal else None
    if window:
        near = kpos > qpos - window
        mask = near if mask is None else mask & near
    return mask


def _scores(q, k, causal, window):
    """f32 scaled scores (B, KV, G, Sq, Sk), masked keys at -inf."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    mask = _mask(sq, k.shape[1], causal, window, q.device)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0):
    """Plain version: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    w = torch.softmax(_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True, window: int = 0):
    """Plain version of the forward's lse: (B, H, Sq) f32 log-sum-exp of
    each row's scaled scores over the keys it keeps."""
    b, sq, h, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal, window), dim=-1).reshape(
        b, h, sq)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, causal: bool = True,
                            window: int = 0):
    """Plain version of the backward, from the formulas, in f32: P =
    exp(S scale - lse) recomputed, dP = dO V^T, delta = rowsum(P o dP) (the
    softmax's own row sum: ``out`` is not read), dS = P (dP - delta); dV =
    P^T dO, dK = dS^T Q scale, dQ = dS K scale, dK and dV summed over each
    KV head's query heads. Returns (dq, dk, dv) in q's type."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5
    qf = q.float().reshape(b, sq, kv, g, d)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, kv, g, d)
    row_lse = lse.float().reshape(b, kv, g, sq)[..., None]
    p = torch.exp(torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale - row_lse)
    mask = _mask(sq, sk, causal, window, q.device)
    keep = torch.isfinite(row_lse) if mask is None else mask & torch.isfinite(
        row_lse)
    p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, h, d) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise TypeError("expected q (B, Sq, H, D) and k, v (B, Sk, KV, D)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"expected bf16 or f32 alike, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise TypeError("q, k and v must lie on one device")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} heads are not a multiple of {kv} KV heads")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if max(b, h) > 65535 or max(sq, k.shape[1]) >= 2**31:
        raise ValueError(f"B = {b}, H = {h} or S exceed the launch grid")
    if not 0 <= window < 2**31:
        raise ValueError(f"window {window}: expected 0 (none) or a positive "
                         "int32")


def tma_readable(t: torch.Tensor) -> bool:
    """Whether TMA can read the (B, S, heads, D) tensor ``t`` where it lies:
    the last dimension contiguous, the base address 16-byte aligned and
    each outer stride a multiple of 16 bytes (dimensions of size 1 are
    never stepped over and do not count)."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * es % 16 == 0
                    for i in range(3) if t.shape[i] > 1))


def kernel_strides(t: torch.Tensor):
    """Element strides (batch, row, head) of ``t`` for the kernel; a
    dimension of size 1 takes the stride it would have if ``t`` were
    contiguous, since the kernel never steps over it and a tensor map
    checks every stride."""
    packed = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
              t.shape[3])
    return [t.stride(i) if t.shape[i] > 1 else packed[i] for i in range(3)]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's type, and
    with ``return_lse`` also the (B, H, Sq) f32 log-sum-exp of each row.

    Inputs are read where they lie, at their strides. A bf16 input that TMA
    cannot read there (:func:`tma_readable`: a base address not 16-byte
    aligned, or an outer stride not a multiple of 8 elements) is first
    copied to fresh contiguous memory; an f32 input only when its last
    dimension is not contiguous."""
    if not on_cuda(q):
        out = flash_attention_ref(q, k, v, causal, window)
        if return_lse:
            return out, flash_attention_lse_ref(q, k, causal, window)
        return out
    _check(q, k, v, window)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_readable(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 9)(*(
        st for t in (q, k, v) for st in kernel_strides(t)))
    lib = build.library()
    with torch.cuda.device(q.device):
        build.count_launch("flash_attention")
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, sk, h, kv, d, ctypes.addressof(strides), int(causal),
            int(window), DTYPES[q.dtype], build.stream_of(q),
        ), "flash_attention")
    return (out, lse) if return_lse else out


#: bf16 operands of the backward that TMA could not read where they lay
#: and that :func:`flash_attention_bwd_cuda` copied first (autograd's
#: ``dout`` may be such a view)
BWD_COPIES = {"flash_attention_bwd": 0}


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` where TMA can read it, else a contiguous copy (counted)."""
    if tma_readable(t):
        return t
    BWD_COPIES["flash_attention_bwd"] += 1
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal: bool = True,
                             window: int = 0):
    """The gradient of :func:`flash_attention_cuda` at (q, k, v): ``out``
    its output, ``dout`` the output's gradient (both (B, Sq, H, D) in q's
    type), ``lse`` its (B, H, Sq) f32 log-sum-exp -> (dq, dk, dv), fresh
    contiguous tensors in q's type. Read at their strides: a bf16 q, k, v or
    dout that TMA cannot read (:func:`tma_readable`) is copied first and
    counted in :data:`BWD_COPIES`; otherwise only a last dimension that is
    not contiguous is copied. The f32 route takes delta = dO . out, the bf16
    route the softmax's own row sum of P o dP (``out`` unread)."""
    if not on_cuda(q):
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, causal,
                                       window)
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: expected {tuple(q.shape)} {q.dtype} on "
                            f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                            f"{t.device}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise TypeError(f"lse: expected ({b}, {h}, {sq}) f32 on {q.device}, "
                        f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if q.dtype == torch.bfloat16:
        q, k, v, dout = (_tma_operand(t) for t in (q, k, v, dout))
    else:
        q, k, v, out, dout = (t if t.stride(-1) == 1 else t.contiguous()
                              for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    if min(b, sq, sk, h) == 0:
        return (torch.zeros((b, sq, h, d), dtype=q.dtype, device=q.device),
                torch.zeros((b, sk, kv, d), dtype=q.dtype, device=q.device),
                torch.zeros((b, sk, kv, d), dtype=q.dtype, device=q.device))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(
        st for t in (q, k, v, out, dout) for st in kernel_strides(t)))
    lib = build.library()
    with torch.cuda.device(q.device):
        build.count_launch("flash_attention_bwd")
        build.check(lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kv, d,
            ctypes.addressof(strides), int(causal), int(window),
            DTYPES[q.dtype], build.stream_of(q),
        ), "flash_attention_bwd")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with both directions on the card: the forward kernel
    (which also writes the lse), and the backward kernels on the saved q,
    k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal, window,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def kept_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the masks keep: start-aligned causal, and the
    window's last ``window`` keys (exact for Sq == Sk)."""
    if not causal and not window:
        return sq * sk
    m = min(sk, window) if window else sk
    if sq <= m:
        return sq * (sq + 1) // 2
    return m * (m + 1) // 2 + (sq - m) * m


def flash_cost(q, k, v, causal: bool, window: int = 0, backward=False):
    """(FLOPs, bytes) of one launch: the forward does 4 D operations a kept
    pair (S = Q K^T and P V) and reads q, k, v and writes the output once;
    the backward does 10 D a kept pair and reads q, k, v, out, dout and
    the lse and writes dq, dk, dv once. No (Sq, Sk) scores."""
    b, sq, h, d = q.shape
    pairs = kept_pairs(sq, k.shape[1], causal, window)
    es = q.element_size()
    if backward:
        return (10.0 * d * pairs * b * h,
                (4.0 * q.numel() + 2 * k.numel() + 2 * v.numel()) * es
                + 4.0 * b * h * sq)
    return 4.0 * d * pairs * b * h, (2.0 * q.numel() + k.numel()
                                     + v.numel()) * es


class CountedFlashAttention(torch.autograd.Function):
    """The dry run's stand-in (``kernels.counting``): charges the forward
    and the backward kernels on the local shards, launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ql, kl, vl = (counting.local(t) for t in (q, k, v))
        counting.active().charge("flash_attention",
                                 *flash_cost(ql, kl, vl, causal, window))
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        # the lse the backward reads: (B, H, Sq) f32 a device
        ctx.lse = counting.like(q, (ql.shape[0], ql.shape[2], ql.shape[1]),
                                torch.float32)
        return counting.like(q, ql.shape[:-1] + (vl.shape[-1],))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        ql, kl, vl = (counting.local(t) for t in (q, k, v))
        counting.active().charge("flash_attention_bwd", *flash_cost(
            ql, kl, vl, ctx.causal, ctx.window, backward=True))
        return (counting.like(q, ql.shape), counting.like(k, kl.shape),
                counting.like(v, vl.shape), None, None)
