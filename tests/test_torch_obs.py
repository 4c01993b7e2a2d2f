"""The port's observability (``repro_torch.core.obs``, DESIGN.md §12)
against the JAX package's: the tracer's contracts (nesting, thread ids, the
disabled span as one shared no-op, fences only under ``trace_sync``), the
metrics write path's arithmetic, traced runs bit-identical to untraced ones
with the same host syncs per step, the port's Chrome trace held to the
reference's own ``validate_chrome_trace`` and ``phase_coverage``, the
progress line held to the reference's ``step_log_line`` string, the
observer's abort path, and the ``trace_sync`` gather probe, mirroring
``tests/test_obs.py``'s serial cases. Tolerance 0."""
import dataclasses
import json
import threading

import pytest
import torch

from repro.core import obs as jobs
from repro.core.stats import StepStats as JStepStats
from repro_torch.core import FaultPlan, RunConfig, SuperstepRuntime, obs
from repro_torch.core import graph as TG
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.obs import metrics as metrics_lib
from repro_torch.core.obs import tracer as tracer_lib
from repro_torch.core.stats import StepStats

APPS = [
    lambda: MotifsApp(max_size=3),
    lambda: CliquesApp(max_size=4),
    lambda: FSMApp(support=3, max_size=3),
]
#: per-step counters that must be identical traced vs untraced
COUNTER_STATS = (
    "n_frontier", "n_children", "n_chunks", "n_host_syncs",
    "bytes_to_host", "collective_bytes", "n_generated", "n_canonical",
    "n_quick_patterns", "n_canonical_patterns", "n_iso_checks",
)


def _graph():
    return TG.random_labeled(40, 200, n_labels=3, seed=4)


def _run(app, **kw):
    rt = SuperstepRuntime(_graph(), app, RunConfig(**kw), device="cpu")
    return rt.run()


# ---------------------------------------------------------------------------
# tracer and metrics units
# ---------------------------------------------------------------------------

def test_span_nesting_and_thread_ids():
    tr = tracer_lib.Tracer()
    tracer_lib.install(tr)
    try:
        with obs.span("superstep", step=1):
            with obs.span("expand", step=1):
                pass
            with obs.span("seal"):
                pass

        def worker():
            with obs.span("canonicalize"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    finally:
        tracer_lib.install(None)
    by = {sp.name: sp for sp in tr.spans}
    assert [sp.name for sp in tr.spans[:3]] == ["expand", "seal", "superstep"]
    assert by["expand"].parent == "superstep" and by["expand"].depth == 1
    assert by["superstep"].parent is None and by["superstep"].depth == 0
    assert by["expand"].ts >= by["superstep"].ts
    assert by["superstep"].dur >= by["expand"].dur + by["seal"].dur
    assert by["expand"].args == {"step": 1}
    assert by["canonicalize"].tid != by["superstep"].tid
    assert by["canonicalize"].depth == 0


def test_disabled_paths_and_fences():
    """No tracer: one shared no-op span, no profiler range, no fence. A
    fence counts only under ``sync=True``; None leaves are skipped."""
    assert tracer_lib.current() is None
    assert obs.span("a", step=9) is obs.span("b")
    assert obs.annotate("x") is obs.span("c")
    x = torch.arange(8)
    obs.fence(x)
    for sync in (False, True):
        tr = tracer_lib.Tracer(sync=sync)
        tracer_lib.install(tr)
        try:
            assert obs.sync_active() is sync
            assert isinstance(obs.annotate("expand"),
                              torch.profiler.record_function)
            obs.fence(x, None)
            obs.fence(None)
            assert tr.n_fences == int(sync)
        finally:
            tracer_lib.install(None)
    assert obs.probe_time(lambda a: a + 1, x) >= 0.0


def test_count_and_set_stat_arithmetic():
    a, b = StepStats(step=1, size=1), StepStats(step=1, size=1)
    reg = metrics_lib.MetricsRegistry()
    metrics_lib.install(reg)
    try:
        for v in (3, 5, 7):
            obs.count(a, "bytes_to_host", v)
            b.bytes_to_host += v
        obs.count(a, "t_expand", 0.1)
        obs.count(a, "t_expand", 0.2)
        b.t_expand += 0.1
        b.t_expand += 0.2
        obs.set_stat(a, "n_quick_patterns", 11)
        b.n_quick_patterns = 11
        obs.gauge("device_bytes_in_use", 5, step=1)
    finally:
        metrics_lib.install(None)
    assert a == b
    snap = reg.snapshot()
    assert snap["counters"]["bytes_to_host"] == 15.0
    assert snap["gauges"]["n_quick_patterns"] == 11.0
    assert reg.by_step["bytes_to_host"] == [(1, 3.0), (1, 5.0), (1, 7.0)]
    assert metrics_lib.sample_device_memory(torch.device("cpu")) is None
    assert metrics_lib.sample_device_memory() is None
    obs.count(a, "n_chunks", 1)                 # no registry: plain add
    assert a.n_chunks == 1


# ---------------------------------------------------------------------------
# traced runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [
    dict(store="raw"), dict(store="odag"),
    dict(store="raw", device_budget_bytes=4096),
], ids=["raw", "odag", "spill"])
def test_traced_run_bit_identical(store, tmp_path):
    for i, mk in enumerate(APPS):
        ref = _run(mk(), **store)
        traced = _run(mk(), trace=True, trace_dir=str(tmp_path / str(i)),
                      **store)
        assert traced.patterns == ref.patterns
        assert ref.trace_path is None and traced.trace_path is not None
        assert len(ref.stats.steps) == len(traced.stats.steps)
        for a, b in zip(ref.stats.steps, traced.stats.steps):
            for k in COUNTER_STATS:
                assert getattr(a, k) == getattr(b, k), (i, k)
        assert tracer_lib.current() is None
        assert metrics_lib.current() is None
        doc = json.load(open(traced.trace_path))
        assert obs.validate_chrome_trace(doc) == []


def test_chrome_trace_passes_the_reference(tmp_path):
    """The port's exported trace passes the reference's schema check, and
    the reference's coverage arithmetic gives the port's number."""
    res = _run(MotifsApp(max_size=3), trace=True, trace_dir=str(tmp_path))
    doc = json.load(open(res.trace_path))
    assert jobs.validate_chrome_trace(doc) == []
    assert obs.phase_coverage(doc) == jobs.phase_coverage(doc)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(obs.PHASES) - {"checkpoint"} <= names
    assert {"superstep", "cost_model"} <= names
    assert obs.PHASES == jobs.PHASES
    other = doc["otherData"]
    assert other["backend"] == "serial"
    assert other["metrics"]["counters"]["n_host_syncs"] >= 1
    # the same checks on a document made to fail them
    bad = {"traceEvents": [{"ph": "X", "name": "superstep", "ts": 0,
                            "dur": -1, "pid": 1}, {"ph": "Q"}]}
    assert obs.validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)
    assert obs.phase_coverage(bad) == jobs.phase_coverage(bad)


def test_step_log_line_matches_reference():
    kw = dict(step=3, size=3, n_frontier=471, n_children=1234, n_chunks=2,
              n_host_syncs=3, frontier_bytes=5652, odag_bytes=1000,
              bytes_to_host=676, collective_bytes=0, t_storage=0.00012,
              t_aggregate=0.123456, t_expand=1.5, t_gather=0.25,
              t_exchange=0.0, t_checkpoint=0.004, n_retries=1,
              t_recovery=0.07)
    assert obs.step_log_line(StepStats(**kw)) == \
        jobs.step_log_line(JStepStats(**kw))
    assert [f.name for f in dataclasses.fields(StepStats)] == \
        [f.name for f in dataclasses.fields(JStepStats)]


def test_log_every_and_jsonl(tmp_path, capsys):
    res = _run(MotifsApp(max_size=3), log_every=1)
    out = capsys.readouterr().out
    assert res.trace_path is None and tracer_lib.current() is None
    lines = [ln for ln in out.splitlines() if ln.startswith("[obs] ")]
    assert lines == [f"[obs] {obs.step_log_line(s)}" for s in res.stats.steps]
    res = _run(MotifsApp(max_size=3), trace=True, trace_dir=str(tmp_path))
    jsonl = res.trace_path.replace(".trace.json", ".events.jsonl")
    records = [json.loads(ln) for ln in open(jsonl)]
    assert {r["event"] for r in records} == {"span", "superstep"}
    assert [r["step"] for r in records if r["event"] == "superstep"] == \
        [s.step for s in res.stats.steps]


def test_observer_uninstalls_and_flushes_on_abort(tmp_path):
    class Boom(MotifsApp):
        def pattern_filter(self, agg):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        _run(Boom(max_size=3), trace=True)
    assert tracer_lib.current() is None and metrics_lib.current() is None
    plan = FaultPlan([("expand", 2, "crash")])
    rt = SuperstepRuntime(_graph(), MotifsApp(max_size=3), RunConfig(
        trace=True, trace_dir=str(tmp_path), faults=plan), device="cpu")
    with pytest.raises(Exception, match="injected"):
        rt.run()
    assert rt.failed_phase == "expand"
    assert tracer_lib.current() is None and metrics_lib.current() is None
    doc = json.load(open(rt.observer.trace_path))
    assert doc["otherData"]["aborted"] is True
    assert jobs.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"expand", "superstep"} <= names
    jsonl = rt.observer.trace_path.replace(".trace.json", ".events.jsonl")
    records = [json.loads(ln) for ln in open(jsonl)]
    assert records[-1]["event"] == "aborted"
    assert any(r["event"] == "span" and r["name"] == "expand"
               for r in records)


def test_trace_sync_times_the_tile_gather():
    ref = _run(MotifsApp(max_size=3))
    res = _run(MotifsApp(max_size=3), trace=True, trace_sync=True,
               graph_partition=2)
    assert res.patterns == ref.patterns
    assert any(s.t_gather > 0 for s in res.stats.steps)
    assert [s.n_host_syncs for s in res.stats.steps] == \
        [s.n_host_syncs for s in ref.stats.steps]
    plain = _run(MotifsApp(max_size=3), graph_partition=2)
    assert all(s.t_gather == 0 for s in plain.stats.steps)
    traced = _run(MotifsApp(max_size=3), trace=True, graph_partition=2)
    assert all(s.t_gather == 0 for s in traced.stats.steps)
