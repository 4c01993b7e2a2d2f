"""``repro_torch.core.run`` vs the JAX package's ``run``: patterns,
embeddings and the per-step ``StepStats`` counters must be identical
(tolerance 0) for motifs and cliques, on the graphs of
``tests/test_apps_vs_oracle.py`` and a labeled MiCo-shaped graph. The JAX
side pins ``cost_model="off"`` (its jnp routes on the CPU); the port runs
on the CPU with the kernel knobs on, so every kernel wrapper takes its
plain version. The pipeline modes are in ``test_torch_pipeline.py``."""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig, graph as JG
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro.core.apps.cliques import maximal_cliques as jmaximal
from repro_torch.core import FaultPlan, RunConfig, graph as TG, run
from repro_torch.core.apps import CliquesApp, MotifsApp
from repro_torch.core.apps.cliques import maximal_cliques
from torch_parity import KERNELS_ON, assert_same_run, graph_pair, jax_run

MOTIF_GRAPHS = [(3, 60, 150, 3), (5, 30, 60, 1), (11, 45, 100, 5)]


@pytest.mark.parametrize("seed,n,m,labels", MOTIF_GRAPHS)
def test_motifs_match_reference(seed, n, m, labels):
    jg, tg = graph_pair(
        lambda G: G.random_labeled(n, m, n_labels=labels, seed=seed))
    base = dict(chunk_size=2048, initial_capacity=2048)
    size = 4 if seed == 3 else 3
    jres = jax_run(jg, JMotifs(max_size=size),
                   EngineConfig(cost_model="off", **base))
    tres = run(tg, MotifsApp(max_size=size),
               RunConfig(fused_expand=seed == 3, **KERNELS_ON, **base),
               device="cpu")
    assert_same_run(jres, tres)


@pytest.mark.parametrize("seed", [0, 7])
def test_cliques_match_reference(seed):
    jg, tg = graph_pair(
        lambda G: G.random_labeled(50, 180, n_labels=1, seed=seed))
    base = dict(chunk_size=2048, initial_capacity=2048)
    jres = jax_run(jg, JCliques(max_size=4),
                   EngineConfig(cost_model="off", **base))
    tres = run(tg, CliquesApp(max_size=4),
               RunConfig(fused_expand=seed == 7, **KERNELS_ON, **base),
               device="cpu")
    assert_same_run(jres, tres)
    jmax = jmaximal(jres, JG.to_device(jg))
    tmax = maximal_cliques(tres, TG.to_device(tg, "cpu"))
    assert sorted(tmax) == sorted(jmax)
    for size in jmax:
        np.testing.assert_array_equal(tmax[size], np.asarray(jmax[size]))


def test_labeled_mico_motifs_cross_agg_qcap():
    """mico_like(0.005): ~37k size-3 quick patterns, far past the default
    agg_qcap (4096), so the carried partials overflow and the step re-folds
    from the frontier wave — in both packages, with the same counters."""
    jg, tg = graph_pair(lambda G: G.mico_like(0.005))
    jres = jax_run(jg, JMotifs(max_size=3), EngineConfig(cost_model="off"))
    # 5,401 edges: "auto" would calibrate, and the counters follow the
    # placement it picks
    tres = run(tg, MotifsApp(max_size=3),
               RunConfig(cost_model="off", **KERNELS_ON), device="cpu")
    assert_same_run(jres, tres)
    assert tres.stats.steps[-1].n_quick_patterns > 4096


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(TG.triangle_plus_tail(), MotifsApp(max_size=3))
    res = run(TG.triangle_plus_tail(), MotifsApp(max_size=3), device="cpu")
    assert sum(res.patterns.values()) > 0


@pytest.mark.parametrize("knob", [
    dict(checkpoint_dir="ckpt"), dict(log_every=1),
    dict(trace=True), dict(faults=()),
])
def test_unported_paths_raise(knob, tmp_path):
    """The knobs whose paths were not ported raised ``NotImplementedError``;
    checkpoints, the progress log, tracing and fault plans are ported now,
    so each runs and gives the default run's patterns."""
    if "checkpoint_dir" in knob:
        knob = dict(checkpoint_dir=str(tmp_path / knob["checkpoint_dir"]))
    if "faults" in knob:
        knob = dict(faults=FaultPlan(knob["faults"]))
    g = TG.triangle_plus_tail()
    res = run(g, MotifsApp(max_size=3), RunConfig(**knob), device="cpu")
    ref = run(g, MotifsApp(max_size=3), device="cpu")
    assert res.patterns == ref.patterns


def test_unknown_store_kind_raises():
    """``make_store`` takes "raw" and "odag", as the reference's does: a
    spill store comes from ``device_budget_bytes``, not from ``store``."""
    with pytest.raises(ValueError, match="spill"):
        run(TG.triangle_plus_tail(), MotifsApp(max_size=3),
            RunConfig(store="spill"), device="cpu")


@pytest.mark.parametrize("knob", [
    dict(canonical_placement="device"), dict(canonical_placement="host_async"),
    dict(aggregate_bin="radix"), dict(cost_model="force_device"),
    dict(graph_partition=2),
])
def test_level2_placements_and_radix_bin_run(knob):
    """The knobs of the radix bin, the level-2 placements and the
    partitioned layout run and give the default run's patterns (parity with
    the JAX package: ``test_torch_level2.py``,
    ``test_torch_partition_runs.py``)."""
    g = TG.triangle_plus_tail()
    want = run(g, MotifsApp(max_size=3), device="cpu").patterns
    res = run(g, MotifsApp(max_size=3), RunConfig(**knob), device="cpu")
    assert res.patterns == want

