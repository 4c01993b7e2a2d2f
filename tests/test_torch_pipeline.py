"""The port's superstep pipeline modes vs the JAX package's, run by run:
fused and chunk-loop dispatch, device and host level 1, the plain routes,
the forced cost-model tables, pattern-granular alpha pruning, and one
superstep expanded from a shared frontier. Small chunks, capacities and
``agg_qcap`` make every step span several chunks, capacity retries and
overflowing partials. Tolerance 0."""
import dataclasses

import numpy as np
import pytest

from repro.core import EngineConfig, graph as JG
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro.core.runtime import RunConfig as JRunConfig
from repro.core.runtime import SerialBackend as JSerial
from repro.core.stats import StepStats as JStepStats
from repro.core.store import RawStore as JRawStore
from repro_torch.core import RunConfig, graph as TG, run
from repro_torch.core.apps import CliquesApp, MotifsApp
from repro_torch.core.runtime import SerialBackend
from repro_torch.core.stats import StepStats
from repro_torch.core.store import store_from_numpy
from torch_parity import (
    COUNTERS, KERNELS_ON, assert_same_run, graph_pair, jax_run,
)

PIPELINE = dict(chunk_size=32, initial_capacity=16, agg_qcap=8)


def _pipeline_graphs():
    return graph_pair(lambda G: G.random_labeled(30, 80, n_labels=2,
                                                   seed=21))


def _apps(app):
    if app == "motifs":
        return JMotifs(max_size=3), MotifsApp(max_size=3)
    return JCliques(max_size=4), CliquesApp(max_size=4)


@pytest.mark.parametrize("app,async_chunks,device_aggregate", [
    ("motifs", True, True), ("motifs", True, False),
    ("motifs", False, True), ("motifs", False, False),
    # cliques aggregate no patterns: device_aggregate does not apply
    ("cliques", True, True), ("cliques", False, True),
])
def test_pipeline_modes_match_reference(app, async_chunks, device_aggregate):
    """Small chunks and capacities so a superstep spans several chunks,
    capacity retries, overflowing partials and (fused) drains."""
    jg, tg = _pipeline_graphs()
    knobs = dict(async_chunks=async_chunks, device_aggregate=device_aggregate,
                 **PIPELINE)
    japp, tapp = _apps(app)
    jres = jax_run(jg, japp, EngineConfig(cost_model="off", **knobs))
    tres = run(tg, tapp, RunConfig(**KERNELS_ON, **knobs), device="cpu")
    assert_same_run(jres, tres)


@pytest.mark.parametrize("mode", ["off", "force_host"])
def test_plain_routes_and_forced_tables_match_reference(mode):
    """The port's plain routes (kernel knobs off) and the forced host
    table against the same JAX cost-model mode."""
    jg, tg = _pipeline_graphs()
    japp, tapp = _apps("motifs")
    jres = jax_run(jg, japp, EngineConfig(cost_model=mode, **PIPELINE))
    for cfg in (RunConfig(cost_model=mode, **PIPELINE),
                RunConfig(cost_model=mode, **KERNELS_ON, **PIPELINE)):
        assert_same_run(jres, run(tg, tapp, cfg, device="cpu"))


def _prune_app(base):
    """``base`` (a MotifsApp class) with a pattern-granular alpha: only
    patterns seen at least 4 times survive a step."""

    @dataclasses.dataclass
    class PruneApp(base):
        max_size: int = 4

        def pattern_filter(self, agg):
            return np.asarray(agg.counts) >= 4

    return PruneApp()


@pytest.mark.parametrize("device_aggregate", [True, False])
def test_pattern_alpha_prunes_like_reference(device_aggregate):
    """Pruning on patterns: per-row alpha masks gathered through the
    device slot ids (``alpha_rows``) or the host canonical slots."""
    jg, tg = _pipeline_graphs()
    knobs = dict(device_aggregate=device_aggregate, **PIPELINE)
    jres = jax_run(jg, _prune_app(JMotifs),
                   EngineConfig(cost_model="off", **knobs))
    tres = run(tg, _prune_app(MotifsApp), RunConfig(**KERNELS_ON, **knobs),
               device="cpu")
    assert_same_run(jres, tres)
    # pruning fired: some step had patterns below the threshold, and only
    # patterns at or above it were recorded
    assert any((a.counts < 4).any() for a in tres.aggregates)
    assert min(tres.patterns.values()) >= 4


def test_serial_backend_expands_one_frontier_identically():
    """Both backends start from the same sealed frontier (a raw-store
    state) and expand one superstep: same children, counters, and carried
    level-1 totals."""
    jg, tg = _pipeline_graphs()
    japp, tapp = _apps("motifs")
    jres = jax_run(jg, JMotifs(max_size=2, collect_embeddings=True),
                   EngineConfig(cost_model="off"))
    state = {"kind": "raw", "meta": {"size": 2},
             "arrays": {"frontier": np.asarray(jres.embeddings[2])}}

    knobs = dict(PIPELINE, agg_qcap=4096)
    jb = JSerial()
    jstore = jb.bind(JG.to_device(jg), japp,
                     JRunConfig(cost_model="off", **knobs))
    jstore.from_state_dict(state)
    assert isinstance(jstore, JRawStore)
    tb = SerialBackend()
    tb.bind(TG.to_device(tg, "cpu"), tapp, RunConfig(**KERNELS_ON, **knobs))
    tstore = store_from_numpy(state)
    out = []
    for b, store, st in ((jb, jstore, JStepStats(step=2, size=2)),
                         (tb, tstore, StepStats(step=2, size=2))):
        blocks = b.begin_step(store, st)
        carried = b.expand(store, blocks, 2, st)
        store.seal(3)
        out.append((store.materialize(), st, carried.finish()))
    (jrows, jst, jfin), (trows, tst, tfin) = out
    np.testing.assert_array_equal(trows, jrows)
    for f in COUNTERS:
        assert getattr(tst, f) == getattr(jst, f), f
    for a, b in zip(tfin, jfin):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
