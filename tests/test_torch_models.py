"""The port's dense decoder (``repro_torch.models``, ``repro_torch.launch``)
against the JAX package's on the CPU: layers, whole forward, decode
through the KV cache and greedy generation, on the reduced configs of the
three dense archs, with the JAX weights carried across by
``model_from_numpy``; and every other family of the registry (held to the
JAX package in ``test_torch_models_{moe,recurrent}.py``) builds and decodes
on the CPU.

Tolerances, each with its reason:

  * f32 weights (the algorithm): logits agree to 1e-3 (absolute and
    relative). Both packages compute the same function; the forwards agree
    to ~1e-5, and decode rounds k/v into a bf16 cache in both, where a
    sum-order difference can flip one rounding (measured ≤ 4e-4).
  * bf16 weights (the configured type): two bf16 computations that round
    at different places do not agree elementwise to 3e-2 (XLA rounds SiLU's
    internals in bf16; the port's attention keeps the softmax weights in
    f32 where the reference's ``_sdpa`` rounds them). So each is held to
    the f32 logits of the same weights: the port's mean absolute error may
    be at most 1.25x the JAX package's own and its largest at most 2x
    (measured 0.92-1.05x and 0.7-1.3x). Lower precision anywhere in the
    port would raise both.
  * one layer in bf16 (attention, decode attention, MLP): 3e-2, the bound
    of the JAX package's own decode-vs-forward test; over a whole model the
    differences compound past it, hence the bullet above.
  * greedy tokens (f32 weights) are compared while the reference's top-2
    logit margin exceeds 3e-2; past the first closer step the two may
    rightly diverge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs.registry import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import build_model, lm, make_batch, model_from_numpy
from repro_torch.models import layers as TL

DENSE = ["qwen2.5-14b", "smollm-135m", "stablelm-1.6b"]
TOL = 3e-2          # one bf16 layer; the greedy margin
F32_TOL = 1e-3      # f32 weights, bf16 KV cache


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


class Pair:
    """A reduced dense arch in both packages with the same weights: bf16
    (as initialised) and the same values in f32."""

    def __init__(self, name, seed=0):
        self.cfg = dataclasses.replace(JARCHS[name].reduced(), remat=False)
        self.jm = jbuild(self.cfg)
        self.params = self.jm.init(jax.random.PRNGKey(seed))
        tree = jax.tree.map(np.asarray, self.params)
        tree32 = jax.tree.map(lambda a: a.astype(np.float32), tree)
        self.params32 = jax.tree.map(jnp.asarray, tree32)
        tcfg = ARCHS[name].reduced()
        self.tm = model_from_numpy(tcfg, tree, device="cpu")
        self.tm32 = model_from_numpy(tcfg, tree32, device="cpu")


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return Pair(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def test_model_from_numpy_carries_every_weight(pair):
    params, tm = pair.params, pair.tm
    tree = jax.tree.map(np.asarray, params)
    got = {k: v.float().numpy() for k, v in tm.state_dict().items()}
    want = {}
    for k in ("embed", "ln_f", "unembed"):
        want[k] = tree[k]
    flat = jax.tree_util.tree_flatten_with_path(tree["layers"])[0]
    for path, leaf in flat:
        name = ".".join(p.key for p in path)
        for i in range(leaf.shape[0]):
            want[f"layers.{i}.{name}"] = leaf[i]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), k)
    assert tm.unembed.dtype == torch.bfloat16
    assert tm.n_params() == sum(x.size for x in jax.tree.leaves(tree))


def test_layers_match_reference(pair):
    """gqa_attention, gqa_decode and mlp of layer 0 on the same bf16 input
    (one layer: bf16 rounding differences stay within 3e-2)."""
    cfg, params, tm = pair.cfg, pair.params, pair.tm
    tcfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s = 2, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    blk = tm.layers[0]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))

    want = JL.gqa_attention(cfg, lp["attn"], xj, jnp.asarray(pos))
    got = TL.gqa_attention(tcfg, blk.attn, xt, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)

    np.testing.assert_allclose(_f32(TL.mlp(blk.mlp, xt)),
                               _f32(JL.mlp(lp["mlp"], xj)), atol=TOL, rtol=TOL)

    cache = rng.standard_normal((2, b, s, cfg.n_kv_heads, cfg.head_dim))
    ck, cv = (jnp.asarray(c, jnp.bfloat16) for c in cache.astype(np.float32))
    tk, tv = (torch.from_numpy(c).to(torch.bfloat16)
              for c in cache.astype(np.float32))
    p = 5
    wo, wk, wv = JL.gqa_decode(cfg, lp["attn"], xj[:, :1], ck, cv, jnp.int32(p))
    to, tk2, tv2 = TL.gqa_decode(tcfg, blk.attn, xt[:, :1], tk, tv, p)
    np.testing.assert_allclose(_f32(to), _f32(wo), atol=TOL, rtol=TOL)
    assert tk2 is tk and tv2 is tv            # updated in place
    np.testing.assert_allclose(_f32(tk), _f32(wk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_f32(tv), _f32(wv), atol=TOL, rtol=TOL)


def _decode(step, cache, toks):
    """Logits of decoding ``toks`` token by token: (B, T, V) f32."""
    out = []
    for t in range(toks.shape[1]):
        logits, cache = step(cache, toks[:, t:t + 1], t)
        out.append(_f32(logits[:, 0]))
    return np.stack(out, 1), cache


def test_forward_and_decode_match_reference(pair):
    """Whole forward (B=2, S=16), then 8 decode steps through the cache:
    f32 weights against the reference, bf16 weights against the f32
    logits (the decode-vs-forward check of serving follows from both)."""
    cfg, jm = pair.cfg, pair.jm
    toks = _tokens(cfg, 2, 16, 2)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    ref = _f32(jm.impl.forward(pair.params32, jt))
    np.testing.assert_allclose(_f32(pair.tm32.forward(tt)), ref,
                               atol=F32_TOL, rtol=F32_TOL)
    got = pair.tm.forward(tt)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.bfloat16
    _no_worse_than_reference(_f32(got), _f32(jm.impl.forward(pair.params, jt)),
                             ref)

    jstep = jax.jit(jm.decode_step)

    def jax_step(params):
        return lambda c, tok, t: jstep(params, c, jnp.asarray(tok),
                                       jnp.int32(t))

    tc = pair.tm32.init_cache(2, 8)
    assert {k: tuple(v.shape) for k, v in tc["layers"].items()} == {
        k: v.shape for k, v in jm.init_cache(2, 8)["layers"].items()}
    ref, jc = _decode(jax_step(pair.params32), jm.init_cache(2, 8), toks[:, :8])
    dec32, tc = _decode(pair.tm32.decode_step, tc, tt[:, :8])
    np.testing.assert_allclose(dec32, ref, atol=F32_TOL, rtol=F32_TOL)
    for k in ("k", "v"):          # bf16 entries: one rounding step apart
        np.testing.assert_allclose(_f32(tc["layers"][k]),
                                   _f32(jc["layers"][k]), atol=0, rtol=2**-7)
    jdec, _ = _decode(jax_step(pair.params), jm.init_cache(2, 8), toks[:, :8])
    dec, _ = _decode(pair.tm.decode_step, pair.tm.init_cache(2, 8), tt[:, :8])
    _no_worse_than_reference(dec, jdec, ref)


def _no_worse_than_reference(port, jax_bf16, ref32):
    """The port's bf16 logits are as close to the f32 logits as the JAX
    package's own bf16 logits are (see the module docstring)."""
    ep, ej = np.abs(port - ref32), np.abs(jax_bf16 - ref32)
    assert ep.mean() <= 1.25 * ej.mean(), (ep.mean(), ej.mean())
    assert ep.max() <= 2 * ej.max(), (ep.max(), ej.max())


def _reference_generate(jm, params, prompt, gen):
    """The reference launcher's greedy loop; returns tokens and the top-2
    margin of the logits each token was taken from."""
    b, p = prompt.shape
    total = p + gen
    cache = jm.init_cache(b, total)
    step = jax.jit(jm.decode_step)
    tok = jnp.asarray(prompt[:, :1])
    toks, margins = [], []
    for t in range(total - 1):
        logits, cache = step(params, cache, tok, jnp.int32(t))
        if t + 1 < p:
            tok = jnp.asarray(prompt[:, t + 1:t + 2])
        else:
            lf = np.asarray(logits[:, -1], np.float32)
            top = np.sort(lf, axis=-1)
            margins.append(top[:, -1] - top[:, -2])
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
    return np.concatenate(toks, 1), np.stack(margins, 1)


def test_generate_matches_reference(pair):
    """Greedy decoding with f32 weights (bf16 KV cache in both)."""
    cfg = pair.cfg
    prompt = _tokens(cfg, 3, 6, 3)
    want, margin = _reference_generate(pair.jm, pair.params32, prompt, 10)
    got = serve.generate(pair.tm32, torch.from_numpy(prompt), 10)
    assert got.shape == (3, 10) and got.dtype == torch.int32
    compared = 0
    for r in range(3):
        close = np.nonzero(margin[r] <= TOL)[0]
        n = close[0] if close.size else margin.shape[1]
        np.testing.assert_array_equal(got[r, :n].numpy(), want[r, :n])
        compared += n
    assert compared >= 10        # most steps are decided by a clear margin


def _family_cfg(name):
    """A reduced arch of the registry, or ``"mla"``: the reduced dense
    qwen2.5-14b with DeepSeek-V2's latent attention."""
    if name == "mla":
        return dataclasses.replace(ARCHS["qwen2.5-14b"], use_mla=True,
                                   kv_lora=512, q_lora=1536).reduced()
    return ARCHS[name].reduced()


@pytest.mark.parametrize("name", sorted(n for n in ARCHS
                                        if ARCHS[n].family != "dense")
                         + ["mla"])
def test_every_family_builds_and_decodes_on_the_cpu(name):
    """Every family the registry holds beside the dense one, and MLA on a
    dense decoder: built on the CPU, one forward (with the family's patch
    embeddings or audio frames) and one decode step through a fresh cache,
    each of the expected shape, finite, under inference mode."""
    cfg = _family_cfg(name)
    m = build_model(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    s = 16                  # a multiple of the reduced ssm_chunk
    batch = make_batch(cfg, ShapeConfig("t", s, 2, "train"), gen)
    extra = {k: v for k, v in batch.items()
             if k in ("patch_embeds", "frames")}
    assert set(extra) == {"vlm": {"patch_embeds"}, "encdec": {"frames"}}.get(
        cfg.family, set())
    logits = m.forward(batch["tokens"], **extra)
    n = cfg.n_patches if cfg.family == "vlm" else 0
    assert logits.shape == (2, s + n, cfg.vocab)
    assert logits.dtype == torch.bfloat16 and logits.is_inference()
    assert bool(torch.isfinite(logits.float()).all())
    cache = m.init_cache(2, s)
    step, cache2 = m.decode_step(cache, batch["tokens"][:, :1], 0)
    assert cache2 is cache
    assert step.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(step.float()).all())


def test_build_model_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["smollm-135m"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    m = build_model(cfg, device="cpu", seed=3)
    assert m.device == torch.device("cpu")
    # the same seed gives the same weights; init follows the reference's
    # distributions (unit norms, zero biases, N(0, 1/d_in) projections)
    m2 = build_model(cfg, device="cpu", seed=3)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    blk = m.layers[0]
    assert torch.equal(blk.ln1, torch.ones_like(blk.ln1))
    w = blk.attn.wq.w.float()
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    q = build_model(ARCHS["qwen2.5-14b"].reduced(), device="cpu")
    assert torch.equal(q.layers[0].attn.wk.b,
                       torch.zeros_like(q.layers[0].attn.wk.b))


def test_decode_step_writes_only_its_cache_slot():
    """decode_step(cache, token, pos) writes slot ``pos`` of every layer's
    k/v in place and nothing else, and runs under inference mode."""
    cfg = ARCHS["smollm-135m"].reduced()
    m = build_model(cfg, device="cpu", seed=4)
    cache = m.init_cache(2, 6)
    k, v = cache["layers"]["k"], cache["layers"]["v"]
    assert k.shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.head_dim)
    assert k.dtype == v.dtype == torch.bfloat16
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    for pos in (0, 3):
        before_k, before_v = k.clone(), v.clone()
        logits, out = m.decode_step(cache, tok, pos)
        assert out is cache and out["layers"]["k"] is k
        assert logits.shape == (2, 1, cfg.vocab) and logits.is_inference()
        other = [i for i in range(6) if i != pos]
        assert torch.equal(k[:, :, other], before_k[:, :, other])
        assert torch.equal(v[:, :, other], before_v[:, :, other])
        assert (k[:, :, pos] != 0).any() and (v[:, :, pos] != 0).any()
    assert m.forward(tok).is_inference()


def test_serve_cli_runs_on_the_cpu(capsys):
    tokens = serve.main(["--arch", "smollm-135m", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "4", "--gen", "5"])
    assert tokens.shape == (2, 5)
    assert ((tokens >= 0) & (tokens < ARCHS["smollm-135m"].reduced().vocab)).all()
    assert "generated (2, 5) tokens" in capsys.readouterr().out


def test_decode_and_forward_modules_have_reference_names():
    m = build_model(ARCHS["qwen2.5-14b"].reduced(), device="cpu")
    names = set(dict(m.named_parameters()))
    for n in ("embed", "ln_f", "unembed", "layers.0.ln1", "layers.0.ln2",
              "layers.0.attn.wq.w", "layers.0.attn.wq.b", "layers.0.attn.wo.w",
              "layers.0.mlp.w_gate.w", "layers.0.mlp.w_in.w",
              "layers.0.mlp.w_out.w"):
        assert n in names, n
    assert "layers.0.attn.wo.b" not in names
    assert isinstance(m, lm.DecoderLM) and len(m.layers) == 4
