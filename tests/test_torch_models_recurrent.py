"""The port's recurrent and encoder-decoder models (``zamba2-2.7b``: Mamba2
blocks and one shared attention block; ``xlstm-1.3b``: mLSTM and sLSTM
blocks; ``whisper-base``: a bidirectional encoder and a decoder with
cross-attention) against the JAX package on the CPU, reduced configs, the
JAX weights carried across by ``model_from_numpy``: weights leaf for leaf,
the layers, forward plus decode, and greedy generation.

Tolerances, each with its reason:

  * f32 weights, whole model: 1e-3 for whisper (the same f32 function);
    1e-2 for zamba2 and xlstm, whose reference casts to bf16 inside the f32
    model (Mamba2's ``dt``, the mLSTM's output and the sLSTM's hidden
    state, ``DTYPE``): a last-bit difference upstream can flip one such
    rounding, 2^-8 relative (measured ≤ 4.5e-3).
  * bf16 weights, whole model: no worse than the JAX package's own bf16
    against the f32 logits (mean ≤ 1.25x, largest ≤ 2x).
  * one block, f32 weights (the algorithm): 1e-4 for the chunked scan on
    f32 inputs (sums in another order); 2e-2 for a whole Mamba2, mLSTM or
    sLSTM block, by the same bf16 casts as above; whisper's encoder and
    cross-attention 1e-4.
  * the f32 decode states after 8 steps of the whole model: the logits'
    tolerance, by the same bf16 casts (the Mamba2 state sums B x dt x,
    whose dt was rounded to bf16; measured ≤ 5e-3); a block's states from
    the same input to 1e-3.
  * greedy tokens (f32 weights) while the reference's top-2 margin
    exceeds 3e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from model_parity import (Pair, check_forward_and_decode, check_generate,
                          check_weights_carried, f32, tokens)
from repro.models import ssm as JS
from repro_torch.models import ssm as TS

ARCHS = ["whisper-base", "xlstm-1.3b", "zamba2-2.7b"]
F32_TOL = {"whisper-base": 1e-3, "xlstm-1.3b": 1e-2, "zamba2-2.7b": 1e-2}
BLOCK_TOL = 2e-2


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_model_from_numpy_carries_every_weight(pair):
    check_weights_carried(pair)
    cfg, m = pair.tcfg, pair.tm
    if cfg.family == "hybrid":
        assert len(m.blocks) * len(m.blocks[0].mamba) == cfg.n_layers
    elif cfg.family == "ssm":
        assert len(m.blocks) * (len(m.blocks[0].mlstm) + 1) == cfg.n_layers
    else:
        assert (len(m.enc_layers), len(m.dec_layers)) == (
            cfg.encoder_layers, cfg.n_layers)


def _rand(shape, seed, lo=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a if lo is None else lo + (1 - lo) / (1 + np.exp(-a))


def _scan_case(per_head, seed):
    """The chunked scan on f32 inputs, q/k shared or per head."""
    b, s, h, n, p, chunk = 2, 32, 3, 8, 5, 8
    qk = (b, s, h, n) if per_head else (b, s, n)
    q, k = _rand(qk, seed), _rand(qk, seed + 1)
    v, a = _rand((b, s, h, p), seed + 2), _rand((b, s, h), seed + 3, lo=0.5)
    with torch_parity.quick_compiles():
        want = f32(JS.chunked_linear_attention(
            *(jnp.asarray(x) for x in (q, k, v, a)), chunk))
    got = TS.chunked_linear_attention(
        *(torch.from_numpy(x) for x in (q, k, v, a)), chunk)
    np.testing.assert_allclose(f32(got), want, atol=1e-4, rtol=1e-4)


def _blocks(pair):
    """Block 0's parameters in both packages (f32 weights)."""
    sp = jax.tree.map(lambda a: a[0], pair.params32["blocks"])
    return sp, pair.tm32.blocks[0]


def _check_block(fwd, dec, jp, tp, cfg, tcfg, states):
    """A block's forward on (2, 32, d) f32 input, then 8 decode steps from
    zero states (``states``: (JAX, torch) pairs), against the reference."""
    x = _rand((2, 32, cfg.d_model), 9)
    with torch_parity.quick_compiles():
        want = f32(getattr(JS, fwd)(cfg, jp, jnp.asarray(x)))
    got = getattr(TS, fwd)(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), want, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    jstates = [j for j, _ in states]
    tstates = [t for _, t in states]
    for t in range(8):
        xt = x[:, t:t + 1]
        with torch_parity.quick_compiles():
            wy, *jstates = getattr(JS, dec)(cfg, jp, jnp.asarray(xt), *jstates)
        ty, *back = getattr(TS, dec)(tcfg, tp, torch.from_numpy(xt), *tstates)
        assert all(a is b for a, b in zip(back, tstates))   # in place
        np.testing.assert_allclose(f32(ty), f32(wy), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)
    for j, t in zip(jstates, tstates):
        np.testing.assert_allclose(f32(t), f32(j), atol=1e-3, rtol=1e-3)


def _check_zamba2(pair):
    cfg, tcfg = pair.cfg, pair.tcfg
    _scan_case(False, 1)
    sp, tsp = _blocks(pair)
    jp = jax.tree.map(lambda a: a[0], sp["mamba"])["m"]
    d_inner, h, n = JS.mamba_dims(cfg)
    st = np.zeros((2, h, n, JS.MAMBA_HEADDIM), np.float32)
    cv = np.zeros((2, JS.MAMBA_CONV - 1, d_inner + 2 * n), np.float32)
    _check_block("mamba2_forward", "mamba2_decode", jp, tsp.mamba[0].m, cfg,
                 tcfg, [(jnp.asarray(a), torch.from_numpy(a.copy()))
                        for a in (st, cv)])


def _check_xlstm(pair):
    cfg, tcfg = pair.cfg, pair.tcfg
    _scan_case(True, 5)
    sp, tsp = _blocks(pair)
    jp = jax.tree.map(lambda a: a[0], sp["mlstm"])["m"]
    d_inner, h, dqk, dv = JS.xlstm_dims(cfg)
    C = np.zeros((2, h, dqk, dv), np.float32)
    N = np.zeros((2, h, dqk), np.float32)
    _check_block("mlstm_forward", "mlstm_decode", jp, tsp.mlstm[0].m, cfg,
                 tcfg, [(jnp.asarray(a), torch.from_numpy(a.copy()))
                        for a in (C, N)])
    dh = cfg.d_model // cfg.n_heads
    c = np.zeros((2, cfg.n_heads, dh), np.float32)
    hid = np.zeros((2, cfg.n_heads, dh), np.float32)
    _check_block("slstm_forward", "slstm_decode", sp["slstm"], tsp.slstm, cfg,
                 tcfg, [(jnp.asarray(c), torch.from_numpy(c.copy())),
                        (jnp.asarray(hid, jnp.bfloat16),
                         torch.from_numpy(hid).to(torch.bfloat16))])


def _check_whisper(pair):
    """The encoder (non-causal attention over the frames) and layer 0's
    cross-attention (Sq != Sk) with f32 weights."""
    cfg = pair.cfg
    jx, tx = pair.extra(2, 4)
    with torch_parity.quick_compiles():
        enc = pair.jm.impl.encode(pair.params32, *jx)
        lp = jax.tree.map(lambda a: a[0], pair.params32["dec_layers"])
        x = jnp.asarray(_rand((2, 5, cfg.d_model), 8))
        want = f32(pair.jm.impl._cross_attn(lp, x, enc))
    tenc = pair.tm32.encode(*tx.values())
    np.testing.assert_allclose(f32(tenc), f32(enc), atol=1e-4, rtol=1e-4)
    got = pair.tm32._cross_attn(pair.tm32.dec_layers[0],
                                torch.from_numpy(np.asarray(x)), tenc)
    assert got.shape == (2, 5, cfg.d_model)
    np.testing.assert_allclose(f32(got), want, atol=1e-4, rtol=1e-4)


def test_layers_match_reference(pair):
    {"hybrid": _check_zamba2, "ssm": _check_xlstm,
     "encdec": _check_whisper}[pair.cfg.family](pair)


def test_forward_and_decode_match_reference(pair):
    """Forward and decode; the hybrid's forward also with the shared
    attention's sliding window of 5 keys (the flash kernel's window)."""
    tol = F32_TOL[pair.name]
    jc, tc = check_forward_and_decode(pair, tol)
    for name in ("ssm", "mC", "mN", "sc"):     # the f32 recurrent states
        if name in jc:
            np.testing.assert_allclose(f32(tc[name]), f32(jc[name]),
                                       atol=tol, rtol=tol)
    if pair.cfg.family == "hybrid":
        toks = tokens(pair.cfg, 2, 16, 4)
        want = pair.jax_forward(pair.params32, toks, (), window=5)
        got = f32(pair.tm32.forward(torch.from_numpy(toks), window=5))
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        assert np.abs(got - f32(pair.tm32.forward(
            torch.from_numpy(toks)))).max() > 10 * tol   # the window acts


@pytest.mark.parametrize("pair", ["zamba2-2.7b"], indirect=True)
def test_hybrid_decode_clamps_past_65536(pair):
    """Past 65,536 positions the hybrid's shared attention keeps
    ``sliding_window_long`` cache slots and writes and attends at the last
    one (the reference's clamp): decode steps on both sides of it, f32
    weights, from the same random attention cache, against the
    reference."""
    b, s = 2, 65537
    jcache = pair.jm.init_cache(b, s)
    tcache = pair.tm32.init_cache(b, s)
    w = tcache["attn"]["k"].shape[2]
    assert w == pair.cfg.sliding_window_long < s
    rng = np.random.default_rng(7)
    for name in ("k", "v"):
        a = rng.standard_normal(tcache["attn"][name].shape).astype(np.float32)
        jcache["attn"][name] = jnp.asarray(a, jnp.bfloat16)
        tcache["attn"][name].copy_(torch.from_numpy(a))
    toks = tokens(pair.cfg, b, 4, 8)
    tol = F32_TOL[pair.name]
    with torch_parity.quick_compiles():
        step = jax.jit(pair.jm.decode_step)
        for i, pos in enumerate((w - 2, w - 1, w, s + 3)):
            want, jcache = step(pair.params32, jcache,
                                jnp.asarray(toks[:, i:i + 1]), jnp.int32(pos))
            got, tcache = pair.tm32.decode_step(
                tcache, torch.from_numpy(toks[:, i:i + 1].copy()), pos)
            np.testing.assert_allclose(f32(got), f32(want), atol=tol,
                                       rtol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(tcache["attn"][name]),
                                   f32(jcache["attn"][name]), atol=tol,
                                   rtol=tol)


def test_generate_matches_reference(pair):
    check_generate(pair)
