"""The plain version of the port's flash-attention kernel (what its
wrapper runs on a CPU tensor) against the JAX package's oracle
(``flash_attention/ref.py:attention_ref``), and a tile-by-tile emulation
of the bf16 tensor-core kernel's arithmetic held to the same bound, on
inputs made with numpy from a seed.

Tolerances: f32 2e-5 (the JAX package's own kernel-test bound: the same
f32 arithmetic summed in another order); bf16 the JAX package's own 2e-2.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_ref,
)

from test_torch_model_kernels import _bhsd, _both, _f32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bh,sq,sk,d,causal",
    [
        (2, 128, 128, 64, True),
        (2, 256, 256, 64, True),
        (1, 128, 256, 128, False),
        (3, 256, 256, 128, True),
        (2, 200, 200, 16, True),      # ragged: no multiple of any tile
        (1, 77, 130, 40, True),       # Sq != Sk, start-aligned mask
    ],
)
def test_flash_plain_version_matches_reference_oracle(bh, sq, sk, d, causal,
                                                      dtype):
    rng = np.random.default_rng(0)
    # the reference's (B*H, S, D) as one batch of B*H heads, H = KV
    q = rng.standard_normal((1, sq, bh, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, bh, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, bh, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = _f32(attention_ref(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=causal))
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_bhsd(_f32(got)), want, atol=tol, rtol=tol)


def _tiled_bf16_flash(q, k, v, causal=True, block_k=128):
    """Tile-by-tile emulation of the card kernel's bf16 arithmetic
    (``csrc/flash_attention.cu``, ``flash_attention_tc``): q (B, Sq, H, D),
    k/v (B, Sk, KV, D) in bf16; per ``block_k``-row K/V tile the f32 scores
    Q K^T, the causal and ragged mask, an f32 running max and sum with the
    scale and log2 e folded into one exp2, P rounded to bf16 before an f32
    PV, then one division by the sum and one rounding to bf16."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)
    kh, vh = (t.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        s = qh @ kh[:, :, k0:k0 + block_k].transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, min(k0 + block_k, sk))[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m == float("-inf"), 0.0,
                            torch.exp2((m - m_new) * scale_log2))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new * scale_log2)
        p = torch.exp2(s * scale_log2 - shift)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vh[:, :, k0:k0 + block_k]
        m = m_new
    out = torch.where(l > 0, o / l, 0.0)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def test_bf16_tile_arithmetic_holds_the_kernel_bound():
    """The card kernel's bf16 design (P rounded to bf16 per 128-row K tile,
    f32 running max and sum), emulated on the CPU, stays within the JAX
    package's bf16 bound for this kernel (2e-2) of the plain version and of
    the reference oracle, at B=1, S=300, 4 over 2 heads of 64. Head 0's row
    250 is steered onto key 200, so its scores span more than 30 units and
    its running max jumps in the second tile."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 1, 300, 4, 2, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    q[0, 250, 0] = 45.0 * k[0, 200, 0] / np.linalg.norm(k[0, 200, 0])
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in (q, k, v))
    scores = (qt[0, 250, 0].float() @ kt[0, :251, 0].float().T) / math.sqrt(d)
    assert float(scores.max() - scores.min()) >= 30
    got = _tiled_bf16_flash(qt, kt, vt)
    assert got.shape == qt.shape and got.dtype == torch.bfloat16
    want = flash_attention_ref(qt, kt, vt)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    kk = jnp.repeat(kj, h // kv, axis=2)
    vv = jnp.repeat(vj, h // kv, axis=2)
    oracle = attention_ref(_bhsd(qj), _bhsd(kk), _bhsd(vv))
    oracle = _f32(oracle).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), oracle, atol=2e-2, rtol=2e-2)
