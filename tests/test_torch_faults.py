"""The port's fault tolerance (``repro_torch.core.runtime.faults`` and
``run_supervised``, DESIGN.md §13) against the JAX package's: the fault
plan's budgets, ``classify_failure`` (with the port's fatal class for a
kernel build error and a CUDA runtime error, and ``torch.OutOfMemoryError``
as an OOM), the degradation ladder held rung for rung to the reference's
over a grid of configs, checkpoint corruption and rollback, and supervised
recovery bit-identical to the clean run, mirroring ``tests/test_faults.py``'s
serial cases. Tolerance 0: patterns, events and reports are exact."""
import itertools
import json
import os
import weakref

import pytest
import torch

from repro.core.runtime import RunConfig as JRunConfig
from repro.core.runtime import faults as jfaults
from repro_torch.core import FaultPlan, FaultSpec, RunConfig, graph as TG
from repro_torch.core import run, run_supervised
from repro_torch.core.apps import FSMApp, MotifsApp
from repro_torch.core.runtime import checkpoint as ckpt_lib
from repro_torch.core.runtime import faults as faults_lib
from repro_torch.core.runtime.serial import SerialBackend
from repro_torch.kernels.build import KernelCompileError

SMALL = dict(chunk_size=64, initial_capacity=64)


def _graph():
    return TG.random_labeled(40, 90, n_labels=3, seed=3)


_CLEAN = {}


def _clean(app):
    key = repr(app)
    if key not in _CLEAN:
        _CLEAN[key] = run(_graph(), app, RunConfig(**SMALL), device="cpu")
    return _CLEAN[key]


def _supervised(app, **kw):
    return run_supervised(_graph(), app, RunConfig(**SMALL, **kw),
                          device="cpu")


# ---------------------------------------------------------------------------
# the injection layer and the classes of failure
# ---------------------------------------------------------------------------

def test_fault_plan_budget_and_benign_takes():
    with pytest.raises(ValueError, match="phase"):
        FaultSpec("nowhere", 1)
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("expand", 1, "meteor")
    plan = FaultPlan([("expand", 2, "crash", 2), FaultSpec("seal", 3, "oom")])
    plan.trip("expand", 1)                      # wrong step: nothing
    for _ in range(2):
        with pytest.raises(faults_lib.InjectedCrash):
            plan.trip("expand", 2)
    plan.trip("expand", 2)                      # budget spent
    with pytest.raises(faults_lib.InjectedOOM):
        plan.trip("seal", 3)
    assert plan.fired == [("expand", 2, "crash")] * 2 + [("seal", 3, "oom")]
    assert plan.exhausted
    # benign kinds never raise at a trip; the simulating site takes them
    plan = FaultPlan([("checkpoint", 2, "corrupt"),
                      ("aggregate", 2, "saturate")])
    plan.trip("checkpoint", 2)
    plan.trip("aggregate", 2)
    assert plan.fired == []
    assert faults_lib.take(plan, "checkpoint", 2, "corrupt")
    assert not faults_lib.take(plan, "checkpoint", 2, "corrupt")
    assert not faults_lib.take(None, "aggregate", 2, "saturate")
    with pytest.raises(ValueError, match="benign"):
        plan.take("aggregate", 2, "crash")
    faults_lib.trip(None, "expand", 2)
    with pytest.raises(faults_lib.InjectedHaloFailure):
        FaultPlan([("halo", 1, "halo")]).trip("halo", 1)


def test_classify_failure():
    same = [
        faults_lib.InjectedOOM("x"), faults_lib.InjectedHaloFailure("x"),
        faults_lib.InjectedCrash("x"), RuntimeError("RESOURCE_EXHAUSTED: y"),
        MemoryError("Out of memory while allocating"), ValueError("bad"),
    ]
    jsame = [
        jfaults.InjectedOOM("x"), jfaults.InjectedHaloFailure("x"),
        jfaults.InjectedCrash("x"), RuntimeError("RESOURCE_EXHAUSTED: y"),
        MemoryError("Out of memory while allocating"), ValueError("bad"),
    ]
    assert [faults_lib.classify_failure(e) for e in same] == \
        [jfaults.classify_failure(e) for e in jsame] == \
        ["oom", "halo", "crash", "oom", "oom", "crash"]
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
    assert faults_lib.classify_failure(oom) == "oom"
    fatal = [
        KernelCompileError("kernel build failed (radix_sort.cu)"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        RuntimeError("stream_compact kernel launch failed: cudaError 700"),
    ]
    if hasattr(torch, "AcceleratorError"):
        fatal.append(torch.AcceleratorError("device-side assert triggered"))
    for e in fatal:
        assert faults_lib.classify_failure(e) == faults_lib.FATAL, e
        assert faults_lib.is_fatal(e)
    assert not faults_lib.is_fatal(oom)
    assert not faults_lib.is_fatal(ValueError("CUDA error in a message"))


#: knob values of the degradation grid (both packages' RunConfig has them)
GRID = dict(
    device_budget_bytes=[None, 1 << 20, 1 << 16],
    async_chunks=[None, True, False],
    use_pallas=[None, True, False],
    compact_kernel=[None, False],
    fused_expand=[False, True],
    device_aggregate=[None, False],
    aggregate_kernel=[None, True, False],
    aggregate_bin=[None, "radix", "sort"],
    canonical_placement=[None, "device", "host_async", "host"],
)


def test_apply_degradation_matches_reference():
    """Every phase and kind, over every combination of the grid's knobs:
    the same event and the same knob values after the rung (a pure
    function, the halo rung included). On the card (``on_card=True``) the
    ladder is the same except that it ends where the reference would take
    a rung to the plain versions or the host."""
    names = list(GRID)
    n = n_stopped = 0
    for values in itertools.product(*GRID.values()):
        kw = dict(zip(names, values))
        cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
        for phase in faults_lib.FAULT_PHASES:
            for kind in ("crash", "oom", "halo"):
                got, ev = faults_lib.apply_degradation(cfg, phase, kind)
                card = faults_lib.apply_degradation(cfg, phase, kind,
                                                    on_card=True)
                want, jev = jfaults.apply_degradation(jcfg, phase, kind)
                assert ev == jev, (kw, phase, kind)
                for k in names:
                    assert getattr(got, k) == getattr(want, k), (kw, k)
                if ev in faults_lib.CPU_ONLY_RUNGS:
                    assert card == (cfg, None), (kw, phase, kind)
                    n_stopped += 1
                else:
                    assert card == (got, ev), (kw, phase, kind)
                n += 1
    for halo in (None, "alltoall", "gather"):
        cfg, jcfg = RunConfig(halo=halo), JRunConfig(halo=halo)
        for phase in faults_lib.FAULT_PHASES:
            got, ev = faults_lib.apply_degradation(cfg, phase, "halo")
            want, jev = jfaults.apply_degradation(jcfg, phase, "halo")
            assert ev == jev and got.halo == want.halo, (halo, phase)
            assert faults_lib.apply_degradation(
                cfg, phase, "halo", on_card=True) == (got, ev)
    assert n > 10000 and n_stopped > 1000
    assert RunConfig().async_chunks is None     # inputs never mutated


# ---------------------------------------------------------------------------
# checkpoint integrity
# ---------------------------------------------------------------------------

def test_corruption_detected_and_rolled_back(tmp_path):
    g, app = _graph(), MotifsApp(max_size=4)
    dg = TG.to_device(g, "cpu")
    for mode in ("payload", "truncate"):
        td = tmp_path / mode
        run(g, app, RunConfig(**SMALL, checkpoint_dir=str(td),
                              keep_checkpoints=2), device="cpu")
        paths = ckpt_lib.list_checkpoints(str(td))
        assert len(paths) == 2                  # keep-last-K retention
        ckpt_lib.verify(paths[0])
        faults_lib.corrupt_checkpoint(paths[0], mode=mode)
        with pytest.raises(ckpt_lib.CheckpointCorruptError):
            ckpt_lib.verify(paths[0])
        state, path, skipped = ckpt_lib.load_latest_valid(str(td), dg, app)
        assert skipped == [paths[0]] and path == paths[1]
        assert state.step == int(os.path.basename(paths[1])[9:13])
        # a fingerprint mismatch is a config error, not a cut to skip
        with pytest.raises(ValueError, match="different app"):
            ckpt_lib.load_latest_valid(str(td), dg, MotifsApp(max_size=3))


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

SUPERVISED = {
    "crash": (lambda: MotifsApp(max_size=3),
              [("expand", 2, "crash")], {}, [], 2),
    "oom": (lambda: MotifsApp(max_size=3), [("expand", 2, "oom")], {},
            [f"budget_capped:{faults_lib._BUDGET_SEED}"], 2),
    "canon": (lambda: MotifsApp(max_size=3),
              [("aggregate", 2, "crash", 2)],
              dict(canonical_placement="device"), ["canon_host"], 2),
    "corrupt": (lambda: MotifsApp(max_size=4),
                [("checkpoint", 2, "corrupt"), ("expand", 3, "crash")], {},
                [], 2),
    "fsm": (lambda: FSMApp(support=3, max_size=3),
            [("aggregate", 2, "crash")], {}, [], 2),
    # a repeated expand failure of an ordinary class takes the reference's
    # last rung on the CPU: the kernels' plain routes (on the card the
    # ladder ends before it, test_retry_budget_reraises)
    "pallas": (lambda: MotifsApp(max_size=3), [("expand", 2, "crash", 3)],
               dict(use_pallas=True, max_retries=5),
               ["fused_off", "pallas_off"], 2),
}


@pytest.mark.parametrize("case", sorted(SUPERVISED))
def test_supervised_recovery(case):
    """Each injected fault recovers bit-identically: the retry is stamped
    on its first re-executed step and the degradations are the
    reference's rungs. The run under ``crash`` also takes a ``saturate``
    (the wide re-fold) on its first attempt."""
    mk, specs, kw, rungs, step = SUPERVISED[case]
    if case == "crash":
        specs = specs + [("aggregate", 2, "saturate")]
    plan = FaultPlan(specs)
    res = _supervised(mk(), faults=plan, **{"max_retries": 3, **kw})
    clean = _clean(mk())
    assert res.patterns == clean.patterns
    assert [s.n_children for s in res.stats.steps] == \
        [s.n_children for s in clean.stats.steps]
    assert sorted(plan.fired) == sorted(
        (p, s, k) for p, s, k, *times in specs
        for _ in range(times[0] if times else 1))
    assert res.recovery["degradations"] == rungs
    assert res.recovery["n_retries"] == len(
        [f for f in plan.fired if f[2] not in ("corrupt", "saturate")])
    marked = [s for s in res.stats.steps if s.n_retries]
    assert [s.step for s in marked] == [step]
    assert marked[0].t_recovery > 0
    if case == "corrupt":
        assert res.recovery["rolled_back"] == 1
        assert res.recovery["resumed_step"] == 2


def test_retry_budget_reraises(monkeypatch):
    """The last failure re-raises once ``max_retries`` retries are spent.
    On the card (the ladder told so, as the supervisor tells it for a run
    on a CUDA device) a repeated expand failure takes ``fused_off`` and
    then no rung to the plain versions: it re-raises instead."""
    plan = FaultPlan([("expand", 2, "crash", 99)])
    with pytest.raises(faults_lib.InjectedCrash):
        _supervised(MotifsApp(max_size=3), faults=plan, max_retries=2)
    assert len(plan.fired) == 3                 # 1 attempt + 2 retries

    ladder, rungs = faults_lib.apply_degradation, []

    def on_card(config, phase, kind, on_card=False):
        assert on_card is False                 # the run is on the CPU
        got = ladder(config, phase, kind, on_card=True)
        rungs.append((got[1], got[0].use_pallas, got[0].compact_kernel))
        return got

    monkeypatch.setattr(faults_lib, "apply_degradation", on_card)
    plan = FaultPlan([("expand", 2, "crash", 99)])
    with pytest.raises(faults_lib.InjectedCrash):
        _supervised(MotifsApp(max_size=3), faults=plan, max_retries=4,
                    use_pallas=True, compact_kernel=True)
    assert len(plan.fired) == 5
    # failures 2-4 consult the ladder; the fifth spends the budget
    assert rungs == [("fused_off", True, True)] + [(None, True, True)] * 2


def test_fatal_failure_is_not_retried(monkeypatch):
    """A kernel build error or a CUDA runtime error re-raises at once: no
    retry in a poisoned context, no rung down to the plain routes."""
    for error in (
        KernelCompileError("kernel build failed (link)"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
    ):
        calls = []

        def failing(self, *a, **k):
            calls.append(1)
            raise error

        monkeypatch.setattr(SerialBackend, "expand", failing)
        with pytest.raises(type(error), match=str(error)[:12]):
            _supervised(MotifsApp(max_size=3), max_retries=5)
        assert len(calls) == 1


def test_failed_attempt_released_before_the_retry_binds(monkeypatch):
    """The failed attempt's runtime (its store and level-1 tables) is
    garbage before the next attempt's backend binds."""
    stores = []
    bind = SerialBackend.bind

    def spying(self, g, app, config):
        assert all(ref() is None for ref in stores), "attempt still alive"
        store = bind(self, g, app, config)
        stores.append(weakref.ref(store))
        return store

    monkeypatch.setattr(SerialBackend, "bind", spying)
    plan = FaultPlan([("expand", 2, "crash"), ("aggregate", 3, "crash")])
    res = _supervised(MotifsApp(max_size=4), faults=plan)
    assert res.recovery["n_retries"] == 2 and len(stores) == 3


def test_recovery_span_in_trace(tmp_path):
    plan = FaultPlan([("expand", 2, "oom")])
    res = _supervised(MotifsApp(max_size=3), faults=plan, trace=True,
                      trace_dir=str(tmp_path))
    assert res.patterns == _clean(MotifsApp(max_size=3)).patterns
    doc = json.load(open(res.trace_path))
    rec = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e["name"] == "recovery"]
    assert len(rec) == 1
    assert rec[0]["args"]["n_retries"] == 1
    assert rec[0]["args"]["degradations"] == [
        f"budget_capped:{faults_lib._BUDGET_SEED}"]
    # the crashed attempt exported its own partial trace, marked aborted
    others = [json.load(open(tmp_path / f)) for f in sorted(os.listdir(tmp_path))
              if f.endswith(".trace.json")
              and str(tmp_path / f) != res.trace_path]
    assert any(d["otherData"].get("aborted") for d in others)
