"""Dense bitset utilities (32-bit words) used for O(1) adjacency queries.

Port of ``repro.core.bitset``. The packed words are built as uint32 on the
host (:func:`pack_bool_matrix`) and live on the device as int32 with the
same bits: PyTorch has no ``>>`` for uint32, and ``(word >> s) & 1`` on an
int32 word gives bit ``s`` for every ``s`` in 0..31.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def n_words(n_bits: int) -> int:
    return (int(n_bits) + WORD_BITS - 1) // WORD_BITS


def pack_bool_matrix(dense: np.ndarray) -> np.ndarray:
    """Pack a (R, N) bool matrix into (R, ceil(N/32)) uint32, LSB-first."""
    dense = np.asarray(dense, dtype=bool)
    r, n = dense.shape
    w = n_words(n)
    padded = np.zeros((r, w * WORD_BITS), dtype=bool)
    padded[:, :n] = dense
    bits = padded.reshape(r, w, WORD_BITS)
    weights = (1 << np.arange(WORD_BITS, dtype=np.uint64)).astype(np.uint64)
    return (bits.astype(np.uint64) * weights).sum(axis=2).astype(np.uint32)


def test_bit(words: torch.Tensor, row, col) -> torch.Tensor:
    """Query bit (row, col) of a packed (R, W) int32 matrix.

    ``row``/``col`` are broadcastable integer tensors. Negative indices
    return False; indices past the table are clamped into it, as the JAX
    gather clamps them."""
    r_max, w_max = words.shape[0] - 1, words.shape[1] - 1
    ok = (row >= 0) & (col >= 0)
    r = row.clamp(0, r_max)
    c = col.clamp(min=0)
    word = words[r, (c // WORD_BITS).clamp(max=w_max)]
    bit = (word >> (c % WORD_BITS).to(word.dtype)) & 1
    return ok & (bit == 1)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of 32-bit words (SWAR, in int64 so the
    unsigned arithmetic of the reference is exact)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def count_bits(words: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Total set bits along ``dim`` of packed 32-bit words."""
    return popcount_u32(words).sum(dim=dim)
