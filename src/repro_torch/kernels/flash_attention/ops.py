"""Public wrapper: the (B, S, H, D) layout with grouped KV heads, which the
kernel reads directly (no repeat, no transposes)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)


def flash_attention(q, k, v, causal=True, window=0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) with H a multiple of KV;
    ``window`` > 0 keeps key j for query i only where j > i - window.
    Returns (B, Sq, H, D): the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    return flash_attention_cuda(q, k, v, causal, window)
