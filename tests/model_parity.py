"""Shared helpers of the model zoo's parity tests (``test_torch_models*.py``):
one reduced arch in both packages with the same weights, the inputs of
each family made with numpy from a seed, the JAX package's forward, decode
and greedy loop (compiled under ``torch_parity.quick_compiles``), and the
bf16 rule that holds the port's logits to the f32 logits no worse than the
JAX package's own bf16 logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity
from repro.configs.registry import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import model_from_numpy

#: one bf16 layer; the greedy margin
TOL = 3e-2


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


class Pair:
    """A reduced arch in both packages with the same weights: bf16 (as
    initialised) and the same values in f32; ``extra(b, seed)`` makes the
    family's other forward inputs (patch embeddings, audio frames)."""

    def __init__(self, name, seed=0):
        self.name = name
        self.cfg = dataclasses.replace(JARCHS[name].reduced(), remat=False)
        self.jm = jbuild(self.cfg)
        with torch_parity.quick_compiles():
            self.params = self.jm.init(jax.random.PRNGKey(seed))
        self.tree = jax.tree.map(np.asarray, self.params)
        tree32 = jax.tree.map(lambda a: a.astype(np.float32), self.tree)
        self.params32 = jax.tree.map(jnp.asarray, tree32)
        self.tcfg = ARCHS[name].reduced()
        self.tm = model_from_numpy(self.tcfg, self.tree, device="cpu")
        self.tm32 = model_from_numpy(self.tcfg, tree32, device="cpu")

    def extra(self, b, seed):
        """The forward's other inputs as (JAX arrays, torch tensors), both
        the same bf16 values."""
        cfg = self.cfg
        n = {"vlm": cfg.n_patches, "encdec": cfg.encoder_seq}.get(cfg.family)
        if n is None:
            return (), {}
        name = "patch_embeds" if cfg.family == "vlm" else "frames"
        a = np.random.default_rng(seed).standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
        return ((jnp.asarray(a, jnp.bfloat16),),
                {name: torch.from_numpy(a).to(torch.bfloat16)})

    def jax_forward(self, params, toks, jextra, **kw):
        with torch_parity.quick_compiles():
            return f32(self.jm.impl.forward(params, jnp.asarray(toks),
                                            *jextra, **kw))

    def jax_decode(self, params, toks):
        """Logits of decoding ``toks`` token by token: (B, T, V) f32, and
        the final cache."""
        b, t = toks.shape
        with torch_parity.quick_compiles():
            step = jax.jit(self.jm.decode_step)
            cache = self.jm.init_cache(b, t)
            out = []
            for i in range(t):
                logits, cache = step(params, cache,
                                     jnp.asarray(toks[:, i:i + 1]),
                                     jnp.int32(i))
                out.append(f32(logits[:, 0]))
        return np.stack(out, 1), cache


def port_decode(model, toks):
    b, t = toks.shape
    cache = model.init_cache(b, t)
    out = []
    for i in range(t):
        logits, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, i:i + 1].copy()), i)
        out.append(f32(logits[:, 0]))
    return np.stack(out, 1), cache


def no_worse_than_reference(port, jax_bf16, ref32, routed=False):
    """The port's bf16 logits are as close to the f32 logits as the JAX
    package's own bf16 logits are: mean absolute error at most 1.25x, the
    largest at most 2x (``tests/test_torch_models.py``'s scheme).

    ``routed`` (the MoE archs): a bf16 rounding upstream that differs from
    the f32 run's can send a token to another expert, which moves that
    position's logits by 0.1-1 where the rest move by ~0.01; each package
    meets such flips at positions of its own (the routing itself is held
    identical on the same input by the layer test). So per position (the
    mean over the vocabulary): the median at most 1.25x the JAX package's,
    and the positions above 4x its median at most one more than its own.
    (``chip_smoke.card_rule_holds`` compares recorded routes instead; the
    JAX package's, inside its compiled model, cannot be recorded.)"""
    ep, ej = np.abs(port - ref32), np.abs(jax_bf16 - ref32)
    if not routed:
        assert ep.mean() <= 1.25 * ej.mean(), (ep.mean(), ej.mean())
        assert ep.max() <= 2 * ej.max(), (ep.max(), ej.max())
        return
    pp, pj = ep.mean(-1).ravel(), ej.mean(-1).ravel()
    mj = np.median(pj)
    assert np.median(pp) <= 1.25 * mj, (np.median(pp), mj)
    assert (pp > 4 * mj).sum() <= (pj > 4 * mj).sum() + 1, (pp, pj)


def check_forward_and_decode(pair, f32_tol, b=2, s=16, steps=8, routed=False,
                             **kw):
    """Whole forward (B=2, S=16), then ``steps`` decode steps through the
    cache: f32 weights against the reference within ``f32_tol``, bf16
    weights against the f32 logits by :func:`no_worse_than_reference`.
    Returns the two packages' f32 decode caches."""
    cfg = pair.cfg
    toks = tokens(cfg, b, s, 2)
    jx, tx = pair.extra(b, 3)
    tt = torch.from_numpy(toks)
    ref = pair.jax_forward(pair.params32, toks, jx, **kw)
    np.testing.assert_allclose(f32(pair.tm32.forward(tt, **tx, **kw)), ref,
                               atol=f32_tol, rtol=f32_tol)
    got = pair.tm.forward(tt, **tx, **kw)
    n_extra = sum(v.shape[1] for v in tx.values()) if cfg.family == "vlm" else 0
    assert got.shape == (b, s + n_extra, cfg.vocab)
    assert got.dtype == torch.bfloat16
    no_worse_than_reference(f32(got), pair.jax_forward(pair.params, toks, jx,
                                                       **kw), ref, routed)

    ref, jcache = pair.jax_decode(pair.params32, toks[:, :steps])
    dec32, tcache = port_decode(pair.tm32, toks[:, :steps])
    np.testing.assert_allclose(dec32, ref, atol=f32_tol, rtol=f32_tol)
    jdec, _ = pair.jax_decode(pair.params, toks[:, :steps])
    dec, _ = port_decode(pair.tm, toks[:, :steps])
    no_worse_than_reference(dec, jdec, ref, routed)
    return jcache, tcache


def reference_generate(pair, params, prompt, gen):
    """The reference launcher's greedy loop; returns tokens and the top-2
    margin of the logits each token was taken from."""
    jm = pair.jm
    b, p = prompt.shape
    total = p + gen
    toks, margins = [], []
    with torch_parity.quick_compiles():
        cache = jm.init_cache(b, total)
        step = jax.jit(jm.decode_step)
        tok = jnp.asarray(prompt[:, :1])
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


def check_generate(pair, margin_tol=TOL):
    """Greedy decoding with f32 weights: the tokens agree while the
    reference's top-2 logit margin exceeds ``margin_tol``; past the first
    closer step the two may rightly diverge."""
    prompt = tokens(pair.cfg, 3, 6, 3)
    want, margin = reference_generate(pair, pair.params32, prompt, 10)
    got = serve.generate(pair.tm32, torch.from_numpy(prompt), 10)
    assert got.shape == (3, 10) and got.dtype == torch.int32
    compared = 0
    for r in range(3):
        close = np.nonzero(margin[r] <= margin_tol)[0]
        n = close[0] if close.size else margin.shape[1]
        np.testing.assert_array_equal(got[r, :n].numpy(), want[r, :n])
        compared += n
    assert compared >= 10        # most steps are decided by a clear margin


def check_weights_carried(pair):
    """Every leaf of the reference's tree is one parameter of the port's
    model, with its value, under :func:`flatten_params`' name."""
    from repro_torch.models.lm import flatten_params
    got = {k: v.float().numpy() for k, v in pair.tm.state_dict().items()}
    want = flatten_params(pair.tree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), k)
    assert all(p.dtype == torch.bfloat16 for p in pair.tm.parameters())
    assert pair.tm.n_params() == sum(x.size for x in
                                     jax.tree.leaves(pair.tree))
