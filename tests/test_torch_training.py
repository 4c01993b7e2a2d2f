"""The port's training substrate (``repro_torch.training``,
``repro_torch.launch.train``) on the CPU: AdamW and its schedule against
the JAX package's ``apply_update`` and ``lr_at``, the NaN-step skip,
descent, checkpoints (round trip, resume, atomicity, restore onto another
dtype and device, a resumed run equal to the uninterrupted one), the token
pipeline bit for bit against the reference's, and the launchers.

Bounds: AdamW on random f32 trees 1e-6 relative (the global norm sums the
leaves in another order; everything else is the same f32 arithmetic in the
same order); the schedule 1e-6; tokens, checkpoints and resumed losses
exact."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.training import data as jdata
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import apply_update as japply
from repro.training.optimizer import init_opt_state as jinit
from repro.training.optimizer import lr_at as jlr_at
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, global_batch, shard_batch
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, apply_update, init_opt_state, lr_at)
from repro_torch.training.train_step import TrainLoop, make_train_step

CFG = ARCHS["smollm-135m"].reduced()


def _setup(seed=0):
    model = build_model(CFG, device="cpu", seed=seed)
    dc = DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=4, seed=1)
    return model, dc


def _tree(rng):
    shapes = {"a.w": (6, 5), "b": (7,), "c.w": (2, 3, 4), "d": (1,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_adamw_matches_reference():
    """Three AdamW steps on a random f32 tree (a rank-1 leaf without decay,
    gradients large enough to be clipped in one step) against the JAX
    package's ``apply_update``: weights, master, moments, step, grad norm
    and learning rate."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = init_opt_state(tp)
    for step in range(3):
        grads = {k: (0.05 + 0.5 * step) * rng.standard_normal(v.shape).astype(
            np.float32) for k, v in params.items()}
        jp, js, jm = japply(JAdamWConfig(**cfg), jp,
                            {k: jnp.asarray(g) for k, g in grads.items()}, js)
        tp, ts, tm = apply_update(AdamWConfig(**cfg), tp,
                                  {k: torch.from_numpy(g) for k, g in
                                   grads.items()}, ts)
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.master[k], js.master[k]),
                              (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                _close(got.numpy(), want, 1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        _close(tm["grad_norm"].item(), jm["grad_norm"], 1e-6)
        _close(tm["lr"].item(), jm["lr"], 1e-6)


def test_lr_schedule_matches_reference():
    oc = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    joc = JAdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        _close(lr_at(oc, float(step)).item(),
               float(jlr_at(joc, jnp.float32(step))), 1e-6)
    assert lr_at(oc, 5.0).item() == pytest.approx(0.5)
    assert lr_at(oc, 110.0).item() == pytest.approx(0.0, abs=1e-6)


def test_nan_step_skipped():
    """Poisoned weights give a NaN loss: the step keeps the old weights and
    state (``torch.where``) and reports ``skipped``; a clean step right
    after it is taken."""
    model, dc = _setup()
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for p in params.values():
            p.mul_(float("nan"))
    poisoned = {k: p.detach().clone() for k, p in params.items()}
    state = init_opt_state(params)
    state2, metrics = step_fn(state, global_batch(dc, 0))
    assert int(metrics["skipped"]) == 1 and int(state2.step) == 0
    for k, p in params.items():
        assert torch.equal(p.isnan(), poisoned[k].isnan()), k
    clean, _ = _setup()
    step_fn = make_train_step(clean, AdamWConfig(lr=1e-3))
    state = init_opt_state(dict(clean.named_parameters()))
    state, metrics = step_fn(state, global_batch(dc, 0))
    assert int(metrics["skipped"]) == 0 and int(state.step) == 1


def test_adamw_descends():
    model, dc = _setup()
    loop = TrainLoop(model, AdamWConfig(lr=3e-3, warmup_steps=2,
                                        total_steps=50))
    _, hist = loop.run(global_batch(dc, s) for s in range(12))
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first - 0.2, (first, last)
    assert not any(h["skipped"] for h in hist)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Ten steps checkpointed every five; a new loop on a fresh model
    resumes at step 10 (the weights and state restored exactly) and
    continues to step 13; the reference's layout on disk."""
    model, dc = _setup()
    loop = TrainLoop(model, AdamWConfig(lr=1e-3), ckpt_dir=str(tmp_path),
                     ckpt_every=5)
    state, _ = loop.run(global_batch(dc, s) for s in range(10))
    assert ckpt.latest_step(str(tmp_path)) == 10
    path = tmp_path / "step_00000010"
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    assert leaves["params.embed"]["dtype"] == "bfloat16"
    assert leaves["opt.master.embed"]["dtype"] == "float32"
    assert leaves["opt.step"]["shape"] == []
    with np.load(path / "shard_0.npz") as data:
        assert data["params.embed"].dtype == np.uint16

    fresh, _ = _setup(seed=3)
    loop2 = TrainLoop(fresh, AdamWConfig(lr=1e-3), ckpt_dir=str(tmp_path),
                      ckpt_every=5)
    restored = ckpt.restore(str(tmp_path), 10, {
        "params": dict(fresh.named_parameters()), "opt": state})
    for k, p in model.named_parameters():
        assert torch.equal(restored["params"][k], p.detach()), k
        assert torch.equal(restored["opt"].master[k], state.master[k]), k
    state2, hist2 = loop2.run(global_batch(dc, s) for s in range(10, 13))
    assert hist2[0]["step"] == 10
    assert int(state2.step) == 13


def test_resumed_run_equals_uninterrupted(tmp_path):
    """Six steps in one run against three, a checkpoint, and three resumed
    by a new loop on a fresh model: the last three losses and the final
    weights are the same bits."""
    model, dc = _setup()
    _, hist = TrainLoop(model, AdamWConfig(lr=1e-3)).run(
        global_batch(dc, s) for s in range(6))
    first, _ = _setup()
    TrainLoop(first, AdamWConfig(lr=1e-3), ckpt_dir=str(tmp_path),
              ckpt_every=3).run(global_batch(dc, s) for s in range(3))
    second, _ = _setup(seed=5)
    _, hist2 = TrainLoop(second, AdamWConfig(lr=1e-3),
                         ckpt_dir=str(tmp_path), ckpt_every=3).run(
        global_batch(dc, s) for s in range(3, 6))
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[3:]]
    for (k, p), q in zip(model.named_parameters(), second.parameters()):
        assert torch.equal(p, q), k


def test_checkpoint_atomicity_and_retain(tmp_path):
    model, _ = _setup()
    params = dict(model.named_parameters())
    state = init_opt_state(params)
    ckpt.save(str(tmp_path), 7, {"params": params, "opt": state})
    # a stale .tmp from a crashed writer must be invisible
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 7
    tree = ckpt.restore(str(tmp_path), 7, {"params": params, "opt": state})
    for k, p in params.items():
        assert torch.equal(tree["params"][k], p.detach()), k
    for s in (8, 10, 12):
        ckpt.save(str(tmp_path), s, {"params": params})
    ckpt.retain(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert sorted(d for d in os.listdir(tmp_path)
                  if not d.endswith(".tmp")) == ["step_00000010",
                                                 "step_00000012"]


def test_restore_onto_another_dtype_and_device(tmp_path):
    """A bf16 and f32 tree restores into an f32 like-tree (the bf16 values
    widened exactly) and into bf16 (the f32 values rounded as ``.to``
    rounds), on the like-tree's device ("meta" here: the device is the
    like leaf's, not the file's)."""
    model, _ = _setup()
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = init_opt_state(params)
    ckpt.save(str(tmp_path), 1, {"params": params, "opt": state})
    like = {"params": {k: torch.empty(p.shape, dtype=torch.float32)
                       for k, p in params.items()},
            "opt": state._replace(master={k: torch.empty(
                v.shape, dtype=torch.bfloat16) for k, v in
                state.master.items()})}
    tree = ckpt.restore(str(tmp_path), 1, like)
    assert isinstance(tree["opt"], OptState)
    for k, p in params.items():
        assert tree["params"][k].dtype == torch.float32
        assert torch.equal(tree["params"][k], p.float()), k
        assert torch.equal(tree["opt"].master[k],
                           state.master[k].to(torch.bfloat16)), k
    meta = ckpt.restore(str(tmp_path), 1, {"params": {
        k: torch.empty(p.shape, dtype=p.dtype, device="meta")
        for k, p in params.items()}})
    assert all(t.device.type == "meta" for t in meta["params"].values())


def test_data_pipeline_matches_reference():
    dc = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    jdc = jdata.DataConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    for step in (0, 5):
        got, want = global_batch(dc, step), jdata.global_batch(jdc, step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for s in range(4):
            np.testing.assert_array_equal(
                shard_batch(dc, step, s, 4)["tokens"],
                jdata.shard_batch(jdc, step, s, 4)["tokens"])
    parts = [shard_batch(dc, 5, s, 4)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts),
                                  global_batch(dc, 5)["tokens"])


def test_launch_train_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --device cpu`` trains the
    reduced arch and prints its losses; ``--steps`` counts from step 0, so
    a rerun on the same checkpoint directory trains what is left; without
    ``--device`` and without a card the launcher refuses to start."""
    argv = ["--arch", "whisper-base", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = launch_train.main(argv)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in capsys.readouterr().out
    argv[argv.index("--steps") + 1] = "6"
    assert [h["step"] for h in launch_train.main(argv)] == [4, 5]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "smollm-135m", "--steps", "1"])


def test_train_lm_example_on_the_cpu():
    from repro_torch.examples import train_lm
    hist = train_lm.main(["--steps", "3", "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
