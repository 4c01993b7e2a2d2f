"""The port's attention variants on the CPU against the JAX package: the
GQA mapping of ``ops.py`` (head h reads KV head h // (H / KV)), the
window of the model's ``_sdpa`` and MLA's narrow-v route against the
blocked attention, on inputs made with numpy from a seed.

Tolerances: f32 2e-5 (the JAX package's own kernel-test bound); bf16 the
JAX package's own 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
    flash_attention_ref,
)
from repro_torch.models.layers import attention_narrow_v

from test_torch_model_kernels import _bhsd, _f32


@pytest.mark.parametrize("b,s,h,kv,d", [(2, 128, 8, 2, 64), (1, 50, 9, 3, 64),
                                        (2, 33, 5, 1, 128)])
def test_flash_gqa_mapping_matches_reference(b, s, h, kv, d):
    """Head h reads KV head h // (H / KV): the reference wrapper's
    ``jnp.repeat`` of the KV heads, rebuilt around its oracle."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    kk = jnp.repeat(jnp.asarray(k), h // kv, axis=2)
    vv = jnp.repeat(jnp.asarray(v), h // kv, axis=2)
    want = attention_ref(_bhsd(jnp.asarray(q)), _bhsd(kk), _bhsd(vv))
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    got = flash_attention_cuda(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(
        got.numpy(),
        flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v))).numpy())


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 1, 40, 40),            # each query keeps only itself
    (True, 5, 40, 40),
    (True, 64, 200, 200),         # past a 128-row tile: the kernel skips tiles
    (False, 7, 30, 30),           # a window without the causal mask
    (True, 6, 20, 33),            # Sq != Sk, start-aligned
])
def test_flash_window_matches_reference_sdpa(causal, window, sq, sk):
    """The window of the plain version (the wrapper's CPU route) against
    the reference's ``_sdpa``, which masks k_pos <= q_pos - window, with
    GQA (4 heads over 2), f32 at the JAX package's 2e-5."""
    rng = np.random.default_rng(4)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    pos = lambda s: jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = JL._sdpa(jnp.asarray(q).reshape(b, sq, kv, h // kv, d),
                    jnp.asarray(k), jnp.asarray(v), pos(sq), pos(sk),
                    d ** -0.5, causal, window)
    want = _f32(want).reshape(b, sq, h, d)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=2e-5)
    if window < sk:
        full = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal)
        assert np.abs(_f32(full) - _f32(got)).max() > 1e-2   # the window acts


@pytest.mark.parametrize("s,dk,dv", [(40, 24, 16), (1024, 192, 128)])
def test_mla_narrow_v_route_matches_blocked_attention(s, dk, dv):
    """MLA's route through the flash kernel (v zero-padded to the q/k head
    dim, the output sliced back) against the reference's
    ``blocked_attention`` with Dk != Dv (at S = 1,024 over its 512-query
    blocks), the scale Dk^-1/2 in both; f32 at 2e-5."""
    rng = np.random.default_rng(5)
    b, h = 1, 3
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = JL.blocked_attention(jnp.asarray(q)[:, :, :, None, :],
                                jnp.asarray(k), jnp.asarray(v), pos,
                                dk ** -0.5)
    want = _f32(want).reshape(b, s, h, dv)
    got = attention_narrow_v(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=2e-5)
