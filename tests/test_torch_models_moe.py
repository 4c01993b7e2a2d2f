"""The port's MoE and VLM decoders (``deepseek-v2-236b``: MLA and MoE with a
leading dense layer; ``llama4-maverick-400b-a17b``: GQA and top-1 MoE with a
shared expert; ``internvl2-26b``: GQA over prepended patch embeddings)
against the JAX package on the CPU, reduced configs, the JAX weights carried
across by ``model_from_numpy``: weights leaf for leaf, the layers, forward
plus decode, and greedy generation.

Tolerances, each with its reason:

  * f32 weights, whole model: 1e-3 for internvl2 (the same f32 function);
    2e-2 for the MoE archs, whose reference hard-codes bf16 dispatch and
    combine buffers (``DTYPE``), so an f32 model rounds its expert inputs
    and outputs to bf16: a last-bit difference upstream can flip one such
    rounding, 2^-8 relative (measured ≤ 9.7e-3).
  * bf16 weights, whole model: no worse than the JAX package's own bf16
    against the f32 logits (mean ≤ 1.25x, largest ≤ 2x; see
    ``model_parity.no_worse_than_reference``). For the MoE archs per
    position, since a differing upstream rounding can flip one token's
    routing in either package: median ≤ 1.25x, and at most one more
    outlying position than the JAX package has.
  * one layer in bf16: 3e-2, the bound of the JAX package's own
    decode-vs-forward test; MLA's absorbed decode against its own at the
    same 3e-2.
  * MoE routing (f32 weights, the same input): identical expert choice,
    slots and kept assignments; routing weights to 1e-6 (f32 softmax);
    the layer's output at 2^-7 relative (one bf16 rounding of the combine
    buffer) plus 1e-6.
  * greedy tokens (f32 weights) while the reference's top-2 margin
    exceeds 3e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from model_parity import (TOL, Pair, check_forward_and_decode,
                          check_generate, check_weights_carried, f32)
from repro.models import layers as JL
from repro_torch.models import layers as TL

ARCHS = ["deepseek-v2-236b", "internvl2-26b", "llama4-maverick-400b-a17b"]
F32_TOL = {"deepseek-v2-236b": 2e-2, "llama4-maverick-400b-a17b": 2e-2,
           "internvl2-26b": 1e-3}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_model_from_numpy_carries_every_weight(pair):
    check_weights_carried(pair)
    cfg = pair.tcfg
    m = pair.tm
    if cfg.first_dense_layers:
        assert len(m.first) == cfg.first_dense_layers
        assert m.first[0].mlp.w_in.w.shape == (cfg.d_model, cfg.dense_d_ff)
    assert hasattr(m, "patch_proj") == (cfg.family == "vlm")
    assert len(m.layers) == cfg.n_layers - cfg.first_dense_layers


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _check_moe(pair):
    """Layer 0's MoE with f32 weights on the same input: the grouped
    routing (the reference's vmapped ``_moe_one_group``) is identical,
    then the whole layer."""
    cfg = pair.cfg
    lp = jax.tree.map(lambda a: a[0], pair.params32["layers"])["moe"]
    tp = pair.tm32.layers[0].moe
    b, s = 2, 12
    x = _x(cfg, b, s, 4)
    g = TL._moe_groups(b * s)
    assert g == JL._moe_groups(b * s) == 8
    tg = b * s // g
    cap = TL._moe_cap(cfg, tg)
    assert cap == JL._moe_cap(cfg, tg)
    with torch_parity.quick_compiles():
        jdisp, jmeta = jax.vmap(lambda xg: JL._moe_one_group(cfg, lp, xg, cap))(
            jnp.asarray(x).reshape(g, tg, cfg.d_model))
        want = f32(JL.moe(cfg, lp, jnp.asarray(x)))
    tdisp, tmeta = TL._moe_dispatch(cfg, tp, torch.from_numpy(x).reshape(
        g, tg, cfg.d_model), cap)
    for name, j, t in zip(("se", "st", "sw", "keep", "pos_in_e"), jmeta,
                          tmeta):
        if name == "sw":
            np.testing.assert_allclose(f32(t), f32(j), atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    assert tdisp.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(tdisp), f32(jdisp))
    got = TL.moe(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), want, atol=1e-6, rtol=2 ** -7)


def _check_mla(pair):
    """Layer 1's MLA (the first MoE layer's; layer 0 of ``first`` is the
    dense one) in bf16: the prefill through the flash route with v padded,
    and the absorbed decode writing its latent cache in place."""
    cfg = pair.cfg
    lp = jax.tree.map(lambda a: a[0], pair.params["layers"])["attn"]
    tp = pair.tm.layers[0].attn
    b, s = 2, 12
    x = _x(cfg, b, s, 5)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    with torch_parity.quick_compiles():
        want = f32(JL.mla_attention(cfg, lp, xj, jnp.asarray(pos)))
    got = TL.mla_attention(pair.tcfg, tp, xt, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)

    rng = np.random.default_rng(6)
    ckv = rng.standard_normal((b, s, cfg.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((b, s, cfg.rope_head_dim)).astype(np.float32)
    tc, tk = (torch.from_numpy(a).to(torch.bfloat16) for a in (ckv, kr))
    p = 5
    with torch_parity.quick_compiles():
        wo, wc, wk = JL.mla_decode(cfg, lp, xj[:, :1],
                                   jnp.asarray(ckv, jnp.bfloat16),
                                   jnp.asarray(kr, jnp.bfloat16), jnp.int32(p))
    to, tc2, tk2 = TL.mla_decode(pair.tcfg, tp, xt[:, :1], tc, tk, p)
    assert tc2 is tc and tk2 is tk            # updated in place
    np.testing.assert_allclose(f32(to), f32(wo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(f32(tc), f32(wc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(f32(tk), f32(wk), atol=TOL, rtol=TOL)


def _check_patches(pair):
    """The patch projection and the GQA attention of layer 0 in bf16."""
    cfg = pair.cfg
    lp = jax.tree.map(lambda a: a[0], pair.params["layers"])
    blk = pair.tm.layers[0]
    b, s = 2, 12
    x = _x(cfg, b, s, 7)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    with torch_parity.quick_compiles():
        want = f32(JL.gqa_attention(cfg, lp["attn"], xj, jnp.asarray(pos)))
        proj = f32(xj @ pair.params["patch_proj"]["w"])
    got = TL.gqa_attention(pair.tcfg, blk.attn, xt, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(f32(got), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(f32(TL.matmul(xt, pair.tm.patch_proj.w)), proj,
                               atol=TOL, rtol=TOL)


def test_layers_match_reference(pair):
    if pair.cfg.use_mla:
        _check_mla(pair)
    if pair.cfg.family == "moe":
        _check_moe(pair)
    else:
        _check_patches(pair)


def test_forward_and_decode_match_reference(pair):
    jc, tc = check_forward_and_decode(pair, F32_TOL[pair.name],
                                      routed=pair.cfg.family == "moe")
    for name in jc["layers"]:             # MLA: ckv/krope; GQA: k/v
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        np.testing.assert_allclose(f32(tc["layers"][name]),
                                   f32(jc["layers"][name]),
                                   atol=F32_TOL[pair.name], rtol=2 ** -7)


def test_generate_matches_reference(pair):
    check_generate(pair)
