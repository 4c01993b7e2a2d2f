"""Public wrapper: the (B, S, H, D) layout with grouped KV heads, which the
kernel reads directly (no repeat, no transposes), and a gradient through
the backward kernels on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import counting
from repro_torch.kernels.dispatch import on_cuda
from repro_torch.kernels.flash_attention.flash_attention import (
    CountedFlashAttention,
    FlashAttentionFn,
    flash_attention_cuda,
    flash_attention_ref,
)


def flash_attention(q, k, v, causal=True, window=0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) with H a multiple of KV;
    ``window`` > 0 keeps key j for query i only where j > i - window.
    Returns (B, Sq, H, D): on a CPU tensor the plain version (autograd
    differentiates it); on a CUDA tensor the kernel, through
    :class:`FlashAttentionFn` when autograd records and an input wants a
    gradient, so that the backward is the backward kernels. While the dry
    run counts (``kernels.counting``), the kernels' charge."""
    if counting.active() is not None:
        return CountedFlashAttention.apply(q, k, v, causal, window)
    if not on_cuda(q):
        return flash_attention_ref(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal, window)
