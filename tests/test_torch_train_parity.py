"""The port's training path against the JAX package's on the CPU: per
family (dense, MoE with MLA, the Mamba2 hybrid, xLSTM, Whisper, the VLM),
reduced, with the JAX package's f32 weights carried across by
``model_from_numpy``, the loss and every gradient leaf against
``jax.value_and_grad(model.loss)``, then one step of ``make_train_step``
against the reference's; and the plain versions of the two backward
kernels against ``jax.grad`` of the reference's oracles.

Bounds, each with its reason:

  * loss: 1e-4 relative (the same f32 function, summed in another order;
    measured <= 5e-6).
  * gradient leaves, relative RMS: 1e-3 (measured 1.8e-6 for the dense,
    Whisper and VLM models, 2.6e-4 for the hybrid). The MoE and xLSTM
    leaves get 1e-2: their gradients pass through the reference's explicit
    bf16 casts (the routing weights, the mLSTM's input gate), which both
    frameworks keep in the f32 model, so the cotangent there is rounded to
    bf16 (2^-8 relative) from f32 values that differ in their last bits
    (measured 1.4e-3 and 6.6e-3).
  * weights after one AdamW step, relative RMS a leaf: 1e-4 (measured
    <= 5.4e-6), 1e-3 for the hybrid and 1e-2 for the MoE and xLSTM
    (measured 1.4e-4, 7.8e-4, 4.3e-3). Step 1 moves each weight by about
    lr sign(g): a gradient element near zero whose last bits differ can
    change sign and move its weight by 2 lr, and the families whose
    gradients carry bf16 roundings have more such elements.
  * the plain backward versions against ``jax.grad``: f32, 1e-5 relative
    to each output's largest value (summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from model_parity import Pair
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jrmsnorm
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_opt_state as jinit
from repro.training.train_step import make_train_step as jmake_step
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_ref
from repro_torch.models.lm import flatten_params
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

#: family -> (arch, gradient bound, bound on the weights after one step)
FAMILIES = {
    "dense": ("smollm-135m", 1e-3, 1e-4),
    "moe": ("deepseek-v2-236b", 1e-2, 1e-2),
    "hybrid": ("zamba2-2.7b", 1e-3, 1e-3),
    "ssm": ("xlstm-1.3b", 1e-2, 1e-2),
    "encdec": ("whisper-base", 1e-3, 1e-4),
    "vlm": ("internvl2-26b", 1e-3, 1e-4),
}
LOSS_TOL = 1e-4


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _batches(pair, b=2, s=32):
    cfg = pair.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jx, tx = pair.extra(b, 3)
    for key, val in tx.items():
        jb[key] = jx[0].astype(jnp.float32)
        tb[key] = val.float()
    return jb, tb


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_grads_and_step_match_reference(family):
    name, grad_tol, step_tol = FAMILIES[family]
    pair = Pair(name)
    jb, tb = _batches(pair)
    with torch_parity.quick_compiles():
        jloss, jgrads = jax.value_and_grad(pair.jm.loss)(pair.params32, jb)
    model = pair.tm32
    params = dict(model.named_parameters())
    loss = model.loss(tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = flatten_params(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(params)
    worst = max(_rel_rms(g.numpy(), want[n]) for n, g in zip(params, grads))
    assert worst <= grad_tol, (name, worst)

    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    with torch_parity.quick_compiles():
        jstep = jax.jit(jmake_step(pair.jm, JAdamWConfig(**cfg)))
        jparams, _, jmetrics = jstep(pair.params32, jinit(pair.params32), jb)
    state, metrics = make_train_step(model, AdamWConfig(**cfg))(
        init_opt_state(params), tb)
    assert int(metrics["skipped"]) == 0 == int(jmetrics["skipped"])
    assert abs(metrics["grad_norm"].item() - float(jmetrics["grad_norm"])) \
        <= grad_tol * float(jmetrics["grad_norm"])
    want = flatten_params(jax.tree.map(np.asarray, jparams))
    worst = max(_rel_rms(p.detach().numpy(), want[n])
                for n, p in model.named_parameters())
    assert worst <= step_tol, (name, worst)
    assert int(state.step) == 1


def test_rmsnorm_bwd_ref_matches_jax_grad():
    """``rmsnorm_bwd_ref`` against ``jax.vjp`` of the reference's norm
    (``repro.kernels.rmsnorm.ref``), f32, with a scale away from 1."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: jrmsnorm(a, s, 1e-5), jnp.asarray(x),
                     jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    dx, ds = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(dy))
    for got, want in ((dx, want_dx), (ds, want_ds)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_ref_matches_jax_grad(causal):
    """``flash_attention_bwd_ref`` (with ``flash_attention_lse_ref``'s lse
    and the plain forward's output) against ``jax.vjp`` of the reference's
    ``attention_ref``, f32, grouped heads (the JAX side repeats each KV
    head over its group, so its k and v gradients sum over the group), Sq
    != Sk without the mask."""
    rng = np.random.default_rng(1)
    b, sq, h, kv, d = 2, 24, 6, 2, 16
    sk = sq if causal else 40
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def ref(q, k, v):
        g = h // kv
        bh = lambda t: jnp.transpose(t, (0, 2, 1, 3)).reshape(
            b * h, t.shape[1], d)
        o = attention_ref(bh(q), bh(jnp.repeat(k, g, axis=2)),
                          bh(jnp.repeat(v, g, axis=2)), causal=causal)
        return jnp.transpose(o.reshape(b, h, sq, d), (0, 2, 1, 3))

    _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    out = flash_attention_ref(tq, tk, tv, causal)
    lse = flash_attention_lse_ref(tq, tk, causal)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0.0, 4.0])
def test_flash_bwd_ref_on_rounded_out_holds_the_rule(offset, causal):
    """``flash_attention_bwd_ref`` on bf16 inputs and the forward's rounded
    output, against ``jax.vjp`` of the reference's ``attention_ref`` in f32
    on the same values: each gradient's largest error at most twice that
    of autograd through the plain bf16 forward plus one bf16 step of its
    largest value (chip_smoke.py 13a's rule). q and k rows share a vector a
    head ``offset`` times their own scale, as trained activations do; dS
    sums to zero along each query row, so the keys' common part cancels
    from dq in exact arithmetic, and a delta taken as dO . out (the rounded
    output) instead of rowsum(P o dP) misses the rule at offset 4."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 1, 256, 4, 2, 64
    q = (rng.standard_normal((b, s, h, d))
         + offset * rng.standard_normal((b, 1, h, d)))
    k = (rng.standard_normal((b, s, kv, d))
         + offset * rng.standard_normal((b, 1, kv, d)))
    v = rng.standard_normal((b, s, kv, d))
    dout = rng.standard_normal((b, s, h, d))
    tq, tk, tv, tdo = (torch.from_numpy(t.astype(np.float32)).bfloat16()
                       for t in (q, k, v, dout))

    def ref(q, k, v):
        g = h // kv
        bh = lambda t: jnp.transpose(t, (0, 2, 1, 3)).reshape(
            b * h, t.shape[1], d)
        o = attention_ref(bh(q), bh(jnp.repeat(k, g, axis=2)),
                          bh(jnp.repeat(v, g, axis=2)), causal=causal)
        return jnp.transpose(o.reshape(b, h, s, d), (0, 2, 1, 3))

    _, vjp = jax.vjp(ref, *(jnp.asarray(t.float().numpy())
                           for t in (tq, tk, tv)))
    want = vjp(jnp.asarray(tdo.float().numpy()))
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    plain = torch.autograd.grad(flash_attention_ref(*leaves, causal), leaves,
                                tdo)
    out = flash_attention_ref(tq, tk, tv, causal)
    lse = flash_attention_lse_ref(tq, tk, causal)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        w = np.asarray(w)
        top = np.abs(w).max()
        err = np.abs(g.float().numpy() - w).max()
        perr = np.abs(p.float().numpy() - w).max()
        assert g.dtype == torch.bfloat16, name
        assert err <= 2 * perr + 2 ** -8 * top, (name, err, perr, top)

