"""The port's pilot-calibrated cost model (``repro_torch.core.runtime.
costmodel``, DESIGN.md §14) against the JAX package's: a real calibration
(probe constants shrunk as ``tests/test_costmodel.py`` shrinks them)
resolves every knob and mines what the static table and the JAX package's
run mine; the process cache, the disk round trip and the stale schema; the
small-graph skip; the probe-error fallback and the errors that must not
fall back (a kernel build error, a CUDA runtime error); explicit knobs over
the table (the card's case, the kernel knobs kept on, is in
``test_torch_cuda.py``, which imports no JAX). Decisions come from
timings, so the tests hold outputs, sources and mechanics, not decisions.
Tolerance 0."""
import dataclasses
import json

import pytest
import torch

from repro.core import EngineConfig
from repro.core.apps import MotifsApp as JMotifs
from repro.core.runtime import costmodel as jcostmodel
from repro_torch.core import RunConfig, graph as TG, run, to_device
from repro_torch.core.apps import FSMApp, MotifsApp
from repro_torch.core.runtime import costmodel
from repro_torch.kernels.build import KernelCompileError
from torch_parity import graph_pair, jax_run


@pytest.fixture(autouse=True)
def _fresh_cache():
    costmodel.clear_cache()
    yield
    costmodel.clear_cache()


@pytest.fixture
def shrunk(monkeypatch):
    monkeypatch.setattr(costmodel, "PROBE_CHUNK_ROWS", 32)
    monkeypatch.setattr(costmodel, "PROBE_BIN_ROWS", 2048)
    monkeypatch.setattr(costmodel, "PROBE_OUT_CAP", 1 << 10)


def _cal_graph(seed=15):
    return TG.random_labeled(120, 600, n_labels=2, seed=seed)


def _resolve(g, cfg, app=None):
    return costmodel.resolve(cfg, to_device(g, "cpu"),
                             app or MotifsApp(max_size=3), "serial")


def _stub_calibrate(monkeypatch, marker):
    calls = []

    def fake(g, app, config, backend_name):
        calls.append(1)
        t = costmodel.static_table(backend_name, g.device,
                                   source="calibrated")
        t.timings["stub"] = marker
        return t

    monkeypatch.setattr(costmodel, "calibrate", fake)
    return calls


def test_calibration_resolves_every_knob(shrunk):
    """A real probe pass on the CPU: every decided knob concrete, the
    timings recorded, the table's constants the reference's, and the same
    patterns as the static table's run and the JAX package's."""
    for name in ("SCHEMA_VERSION", "EXPAND_HYSTERESIS", "DECIDED_KNOBS",
                 "COST_MODEL_MODES"):
        assert getattr(costmodel, name) == getattr(jcostmodel, name), name
    jg, tg = graph_pair(lambda G: G.random_labeled(120, 600, n_labels=2,
                                                   seed=15))
    jres = jax_run(jg, JMotifs(max_size=3), EngineConfig(cost_model="off"))
    cfg = RunConfig(cost_model_min_edges=100)
    for app, want in ((MotifsApp(max_size=3), jres.patterns),
                      (FSMApp(support=3, max_size=3), None)):
        off = run(tg, app, dataclasses.replace(cfg, cost_model="off"),
                  device="cpu")
        auto = run(tg, app, cfg, device="cpu")
        assert auto.patterns == off.patterns
        if want is not None:
            assert auto.patterns == want
        cm = auto.stats.cost_model
        assert cm["source"] == "calibrated", cm
        assert cm["platform"] == "cpu" and cm["schema"] == 2
        assert any(k.startswith("expand.") for k in cm["timings"])
        assert {"bin.sort", "bin.radix", "place.host_drain",
                "async.legacy_chunk_tax", "canon.host"} <= set(cm["timings"])
        for knob in costmodel.DECIDED_KNOBS:
            assert cm[knob] is not None, knob
        # a second run in the process reuses the table: no new pilot
        again = run(tg, app, cfg, device="cpu")
        assert again.stats.cost_model == cm


def test_process_cache_and_disk_roundtrip(tmp_path, monkeypatch):
    calls = _stub_calibrate(monkeypatch, 42.0)
    g = _cal_graph(16)
    cfg = RunConfig(cost_model_dir=str(tmp_path), cost_model_min_edges=0)
    _, t1 = _resolve(g, cfg)
    assert t1.source == "calibrated" and len(calls) == 1
    (path,) = tmp_path.glob("costmodel-*.json")
    assert path.name.startswith("costmodel-v2-cpu-serial-")
    _, t2 = _resolve(g, cfg)
    assert len(calls) == 1 and t2.timings["stub"] == 42.0
    # a fresh process: the disk table comes back as "cached"
    costmodel.clear_cache()
    _, t3 = _resolve(g, cfg)
    assert t3.source == "cached" and len(calls) == 1
    assert t3.timings["stub"] == 42.0
    # another graph, or a measurement-relevant config change, re-pilots
    costmodel.clear_cache()
    _, t4 = _resolve(_cal_graph(17), cfg)
    assert t4.source == "calibrated" and len(calls) == 2
    costmodel.clear_cache()
    _, t5 = _resolve(g, dataclasses.replace(cfg, chunk_size=8192))
    assert t5.source == "calibrated" and len(calls) == 3
    assert len(list(tmp_path.glob("costmodel-*.json"))) == 3
    # a decided knob is no part of the key
    costmodel.clear_cache()
    _, t6 = _resolve(g, dataclasses.replace(cfg, aggregate_kernel=True))
    assert t6.source == "cached" and len(calls) == 3


def test_cache_rejects_stale_schema(tmp_path, monkeypatch):
    calls = _stub_calibrate(monkeypatch, 7.0)
    g = _cal_graph(18)
    cfg = RunConfig(cost_model_dir=str(tmp_path), cost_model_min_edges=0)
    _resolve(g, cfg)
    (path,) = tmp_path.glob("costmodel-*.json")
    d = json.loads(path.read_text())
    assert d["schema"] == costmodel.SCHEMA_VERSION
    d["schema"] = -1
    path.write_text(json.dumps(d))
    costmodel.clear_cache()
    _, t = _resolve(g, cfg)
    assert t.source == "calibrated" and len(calls) == 2
    with pytest.raises(ValueError, match="schema"):
        costmodel.DecisionTable.from_dict(d)


def test_small_graph_skips_pilot(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("pilot must not run below cost_model_min_edges")

    monkeypatch.setattr(costmodel, "calibrate", boom)
    g = TG.random_labeled(20, 40, n_labels=2, seed=19)
    assert RunConfig().cost_model_min_edges == 2048
    _, t = _resolve(g, RunConfig())
    assert t.source == "static"
    _, t = _resolve(g, RunConfig(cost_model="off"))
    assert t.source == "forced:off"


def test_probe_error_falls_back_static(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("probe boom")

    monkeypatch.setattr(costmodel, "_calibrate", fail)
    _, t = _resolve(_cal_graph(20), RunConfig(cost_model_min_edges=0))
    assert t.source == "static:probe-error"
    for knob in costmodel.DECIDED_KNOBS:
        assert getattr(t, knob) is not None


@pytest.mark.parametrize("error", [
    KernelCompileError("kernel build failed (canonical_refine.cu)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["build", "cuda"])
def test_fatal_probe_error_reraises(error, monkeypatch):
    """A kernel build error or a CUDA runtime error in a probe is not
    turned into a static table: it would hide the card or a kernel."""
    def fail(*a, **k):
        raise error

    monkeypatch.setattr(costmodel, "_calibrate", fail)
    with pytest.raises(type(error)):
        _resolve(_cal_graph(21), RunConfig(cost_model_min_edges=0))


def test_explicit_knobs_override_table(monkeypatch):
    calls = _stub_calibrate(monkeypatch, 1.0)
    g = _cal_graph(13)
    cfg = RunConfig(cost_model_min_edges=0, device_aggregate=False,
                    aggregate_bin="radix")
    resolved, table = _resolve(g, cfg)
    assert len(calls) == 1
    assert resolved.device_aggregate is False and table.device_aggregate is False
    assert resolved.aggregate_bin == "radix" and table.aggregate_bin == "radix"
    assert "override.device_aggregate" in table.timings
    assert resolved.async_chunks is True
    # the cached table is not poisoned by the override
    _, again = _resolve(g, RunConfig(cost_model_min_edges=0))
    assert again.aggregate_bin == "sort"
    assert "override.aggregate_bin" not in again.timings
    with pytest.raises(ValueError, match="cost_model"):
        _resolve(g, RunConfig(cost_model="bogus"))
    dev = costmodel.forced_table("force_device", "serial",
                                 torch.device("cpu"))
    assert (dev.aggregate_bin, dev.canonical_placement) == ("radix", "device")
    with pytest.raises(ValueError):
        costmodel.forced_table("force_nothing", "serial", torch.device("cpu"))
