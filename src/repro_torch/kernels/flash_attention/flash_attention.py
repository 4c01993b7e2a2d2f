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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0):
    """Plain version: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = qpos >= kpos if causal else None
    if window:
        near = kpos > qpos - window
        mask = near if mask is None else mask & near
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


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
                         causal: bool = True, window: int = 0):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's type.

    Inputs are read where they lie, at their strides. A bf16 input that TMA
    cannot read there (:func:`tma_readable`: a base address not 16-byte
    aligned, or an outer stride not a multiple of 8 elements) is first
    copied to fresh contiguous memory; an f32 input only when its last
    dimension is not contiguous."""
    if not on_cuda(q):
        return flash_attention_ref(q, k, v, causal, window)
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
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*(
        st for t in (q, k, v) for st in kernel_strides(t)))
    lib = build.library()
    with torch.cuda.device(q.device):
        build.count_launch("flash_attention")
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kv, d, ctypes.addressof(strides), int(causal),
            int(window), DTYPES[q.dtype], build.stream_of(q),
        ), "flash_attention")
    return out
