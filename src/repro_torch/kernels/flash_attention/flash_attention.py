"""Causal grouped-query attention with an online softmax, port of
``repro.kernels.flash_attention.flash_attention`` (``flash_attention_bhsd``
and the GQA wrapper of ``ops.py``).

  * :func:`flash_attention_cuda` — the hand-written kernel
    (``csrc/flash_attention.cu``): q (B, Sq, H, D), k and v (B, Sk, KV, D),
    read at their strides with head h reading KV head h // (H / KV), so
    the repeat and the transposes of the reference's wrapper are never
    materialised. Any Sq and Sk; D a multiple of 8 up to 256; bf16 or f32.
    It takes its plain version for a CPU tensor and launches the kernel for
    a CUDA tensor; anything else raises.
  * :func:`flash_attention_ref` — the plain version, the same function:
    f32 scores scaled by D^-1/2, the start-aligned causal mask
    ``q_pos >= k_pos`` (positions from 0, also when Sq != Sk), an f32
    softmax and an f32 weighted sum, rounded once to q's type (the
    reference's ``ref.py:attention_ref`` with the GQA mapping).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """Plain version: q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _check(q, k, v):
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's type."""
    if not on_cuda(q):
        return flash_attention_ref(q, k, v, causal)
    _check(q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*(
        t.stride(i) for t in (q, k, v) for i in (0, 1, 2)))
    lib = build.library()
    with torch.cuda.device(q.device):
        build.count_launch("flash_attention")
        build.check(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kv, d, ctypes.addressof(strides), int(causal),
            DTYPES[q.dtype], build.stream_of(q),
        ), "flash_attention")
    return out
