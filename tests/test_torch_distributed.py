"""Whole runs of the port's shard-map backend (``repro_torch.core.runtime.
shard``, ``repro_torch.core.distributed``) on the CPU.

- At W = 1 every ``StepStats`` counter (``collective_bytes`` and
  ``bytes_to_host`` included), the patterns, the embeddings in order and the
  step aggregates equal the reference ``ShardMapBackend``'s on a one-device
  mesh (``torch_parity.assert_same_run``; tolerance 0).
- At W = 4 and 8 the patterns, supports and embeddings (as sets) equal the
  serial run's, over the stores, the halo strategies and the placements.
- The per-step counters of ``tests/test_partition.py::
  test_partitioned_shard_map_8dev``'s configs equal the reference's own
  8-device run (one subprocess with 8 host devices, started when the module
  starts and read by the last test). Its mesh takes ``AxisType.Auto``
  where jax has axis types: jax 0.9's ``jax.make_mesh`` defaults to
  explicit axes, under which the reference's eager indexing of sharded
  arrays raises (``ShardingTypeError``).
- An elastic resume (cut at W = 2, resumed at W = 1 and 3), ``run_supervised``
  under a ``halo`` fault, a traced run and the forced cost-model modes.

The JAX runs compile under ``torch_parity.quick_compiles`` and extract
ODAGs under ``host_extract``, as the other parity files do.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core import RunConfig as JRunConfig
from repro.core import SuperstepRuntime as JRuntime
from repro.core.apps import CliquesApp as JCliques
from repro.core.apps import FSMApp as JFSM
from repro.core.apps import MotifsApp as JMotifs
from repro.core.runtime import ShardMapBackend as JShardMapBackend
from repro_torch.core import graph as TG
from repro_torch.core import obs, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.distributed import run_distributed
from repro_torch.core.runtime import (
    FaultPlan, FaultSpec, RunConfig, ShardMapBackend, SuperstepRuntime,
    checkpoint as ckpt_lib, costmodel, make_mesh, resume, run_supervised,
)
from torch_parity import COUNTERS, assert_same_run, graph_pair, \
    host_extract, quick_compiles


def _mesh(w):
    return make_mesh((w,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# the reference's own 8-device run, in a subprocess started with the module
# ---------------------------------------------------------------------------

#: the configs of ``test_partitioned_shard_map_8dev``, under
#: ``cost_model="off"`` (220 edges take the static table either way)
CONFIGS_8DEV = {
    "motifs-a2a": ("motifs", dict(halo="alltoall")),
    "motifs-gather": ("motifs", dict(halo="gather")),
    "fsm-odag": ("fsm", dict(store="odag")),
    "motifs-spill": ("motifs", dict(store="raw", device_budget_bytes=2048)),
    "cliques": ("cliques", dict()),
    "motifs-devagg": ("motifs", dict(device_aggregate=True)),
}

SCRIPT_8DEV = textwrap.dedent(
    """
    import json, sys
    import jax
    from repro.core import graph as G, RunConfig, SuperstepRuntime
    from repro.core.apps import CliquesApp, FSMApp, MotifsApp
    from repro.core.runtime.shard import ShardMapBackend
    from torch_parity import COUNTERS, host_extract, quick_compiles

    assert len(jax.devices()) == 8
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,)}
          if hasattr(jax.sharding, "AxisType") else {})
    mesh = jax.make_mesh((8,), ("data",), **kw)
    apps = {"motifs": lambda: MotifsApp(max_size=3),
            "fsm": lambda: FSMApp(support=3, max_size=3),
            "cliques": lambda: CliquesApp(max_size=4,
                                          collect_embeddings=True)}
    g = G.random_labeled(40, 220, n_labels=3, seed=2)
    out = {}
    for name, (app, kw) in json.loads(sys.argv[1]).items():
        with quick_compiles(), host_extract():
            res = SuperstepRuntime(
                g, apps[app](),
                RunConfig(graph_partition=8, cost_model="off", **kw),
                backend=ShardMapBackend(mesh),
            ).run()
        out[name] = {
            "patterns": sorted([list(k), v] for k, v in res.patterns.items()),
            "steps": [{f: getattr(s, f) for f in COUNTERS}
                      for s in res.stats.steps],
        }
    print("RESULT" + json.dumps(out))
    """
)


@pytest.fixture(scope="module", autouse=True)
def reference_8dev():
    """Start the reference's 8-device run when the module starts; the
    other tests run while it does."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here])
    proc = subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", SCRIPT_8DEV,
         json.dumps(CONFIGS_8DEV)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# W = 1 against the reference's backend
# ---------------------------------------------------------------------------

_APPS = {
    "motifs": (lambda A: A(max_size=3, collect_embeddings=True),
               MotifsApp, JMotifs),
    "cliques": (lambda A: A(max_size=4), CliquesApp, JCliques),
    "fsm": (lambda A: A(support=3, max_size=3), FSMApp, JFSM),
}


@pytest.mark.parametrize("name,app,kw", [
    ("motifs-raw", "motifs", dict()),
    ("motifs-odag", "motifs", dict(store="odag")),
    ("cliques", "cliques", dict()),
    ("motifs-naive", "motifs", dict(naive_aggregation=True)),
], ids=["motifs-raw", "motifs-odag", "cliques", "motifs-naive"])
def test_w1_matches_reference_backend(name, app, kw):
    """Every counter, ``collective_bytes`` and ``bytes_to_host`` included,
    equals the reference backend's on a one-device mesh (the naive
    aggregation's per-embedding bytes too)."""
    mk, tapp, japp = _APPS[app]
    jg, tg = graph_pair(lambda G: G.random_labeled(40, 220, n_labels=3,
                                                   seed=2))
    with quick_compiles(), host_extract():
        jres = JRuntime(jg, mk(japp), JRunConfig(cost_model="off", **kw),
                        JShardMapBackend(jax.make_mesh((1,), ("data",)))
                        ).run()
    tres = run_distributed(tg, mk(tapp), _mesh(1),
                           RunConfig(cost_model="off", **kw))
    assert_same_run(jres, tres)
    assert sum(s.collective_bytes for s in tres.stats.steps) > 0


# ---------------------------------------------------------------------------
# W = 4 and 8 against the serial run
# ---------------------------------------------------------------------------

def _same_as_serial(got, ref, label):
    assert got.patterns == ref.patterns, label
    assert sorted(got.embeddings) == sorted(ref.embeddings), label
    for size, emb in ref.embeddings.items():
        a = np.unique(np.asarray(got.embeddings[size]), axis=0)
        b = np.unique(np.asarray(emb), axis=0)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} size {size}")
    for ga, ra in zip(got.aggregates, ref.aggregates):
        np.testing.assert_array_equal(ga.canon_codes, ra.canon_codes)
        np.testing.assert_array_equal(ga.supports, ra.supports)


@pytest.mark.parametrize("w", [4, 8])
def test_matches_serial_run(w):
    """Patterns, supports and embeddings (as sets) of the serial run, for
    motifs, cliques and FSM under the raw and the ODAG store, whole-graph
    and partitioned under both halo strategies, the host aggregation path,
    a spill budget, ``force_device``, an overflowing per-worker distinct
    table (the host path; and the card's re-bin on the device, with a
    ``saturate`` fault) and the worker body in pieces."""
    from repro_torch.core.runtime import shard

    g = TG.random_labeled(40, 150, n_labels=3, seed=3)
    motifs = lambda: MotifsApp(max_size=4, collect_embeddings=True)  # noqa
    fsm = lambda: FSMApp(support=3, max_size=3, collect_embeddings=True)  # noqa
    cliques = lambda: CliquesApp(max_size=4)  # noqa
    cases = [
        ("motifs", motifs, dict()),
        ("motifs-odag", motifs, dict(store="odag")),
        ("motifs-a2a", motifs, dict(graph_partition=w)),
        ("motifs-gather", motifs, dict(graph_partition=w, halo="gather")),
        ("motifs-hostagg", motifs, dict(device_aggregate=False)),
        ("motifs-spill", motifs, dict(device_budget_bytes=256)),
        ("motifs-device", motifs, dict(cost_model="force_device")),
        # a worker's distinct table overflows: that step takes the host path
        ("motifs-qcap", motifs, dict(agg_qcap=4)),
        ("cliques", cliques, dict()),
        ("cliques-a2a", cliques, dict(graph_partition=w)),
        ("fsm", fsm, dict()),
        ("fsm-odag", fsm, dict(store="odag")),
        ("fsm-odag-gather", fsm, dict(store="odag", graph_partition=w,
                                      halo="gather")),
        ("fsm-hostagg", fsm, dict(device_aggregate=False)),
    ]
    refs = {}
    for label, mk, kw in cases:
        app = mk()
        if type(app) not in refs:
            refs[type(app)] = run(g, app, RunConfig(cost_model="off"),
                                  device="cpu")
        got = run_distributed(g, mk(), _mesh(w),
                              RunConfig(**{"cost_model": "off", **kw}))
        _same_as_serial(got, refs[type(app)], label)
        assert max(s.n_host_syncs for s in got.stats.steps) <= 2, label
        if kw.get("store") == "odag":
            # the dense exchange ships the merged DenseODAG's words
            assert any(s.collective_bytes for s in got.stats.steps), label
    # a worker body in row pieces gives the one piece's run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shard, "BODY_SLOTS", 64)
        for label, mk, kw in (cases[2], cases[8], cases[10]):
            got = run_distributed(g, mk(), _mesh(w),
                                  RunConfig(cost_model="off", **kw))
            _same_as_serial(got, refs[type(mk())], f"{label} in pieces")
    # the card's overflow recovery, forced on the CPU: one re-bin on the
    # workers' devices at the grown cap, and never the host path
    def no_host_path(*_):
        raise AssertionError("the host aggregation path was taken")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ShardMapBackend, "refold_on_device", True)
        mp.setattr(ShardMapBackend, "quick_codes", no_host_path)
        for label, mk, kw in (
            cases[7],
            ("fsm-qcap", fsm, dict(agg_qcap=4)),
            ("motifs-saturate", motifs,
             dict(faults=FaultPlan([("aggregate", 2, "saturate")]))),
        ):
            plan = kw.get("faults")
            backend = ShardMapBackend(_mesh(w))
            got = SuperstepRuntime(g, mk(), RunConfig(cost_model="off", **kw),
                                   backend).run()
            _same_as_serial(got, refs[type(mk())], f"{label} re-binned")
            if plan is None:
                assert backend._shard_qcap > 4, label
            else:
                assert plan.fired == [("aggregate", 2, "saturate")], label


def test_partition_count_must_equal_workers():
    g = TG.random_labeled(30, 80, n_labels=2, seed=1)
    with pytest.raises(ValueError, match="graph_partition=4"):
        run_distributed(g, MotifsApp(max_size=3), _mesh(8),
                        RunConfig(graph_partition=4))
    with pytest.raises(ValueError, match="halo"):
        run_distributed(g, MotifsApp(max_size=3), _mesh(2),
                        RunConfig(graph_partition=2, halo="ring"))


# ---------------------------------------------------------------------------
# control plane under the mesh
# ---------------------------------------------------------------------------

def test_elastic_resume_other_worker_counts(tmp_path):
    """A cut written under W = 2 resumes at W = 1 and W = 3 to the serial
    run's patterns (the store's slices are re-partitioned)."""
    g = TG.random_labeled(60, 150, n_labels=3, seed=3)
    for name, mk in [("motifs", lambda: MotifsApp(max_size=4)),
                     ("fsm", lambda: FSMApp(support=3, max_size=3))]:
        ref = run(g, mk(), RunConfig(cost_model="off"), device="cpu")
        td = str(tmp_path / name)
        run_distributed(g, mk(), _mesh(2),
                        RunConfig(store="odag", checkpoint_dir=td,
                                  cost_model="off"))
        first = ckpt_lib.list_checkpoints(td)[0]
        for w in (1, 3):
            res = resume(g, mk(), first,
                         RunConfig(store="odag", cost_model="off"),
                         ShardMapBackend(_mesh(w)))
            assert res.patterns == ref.patterns, (name, w)


def test_supervised_halo_fault_takes_gather():
    """A failed halo exchange takes the ``halo_gather`` rung and recovers
    bit-identically."""
    g = TG.random_labeled(40, 150, n_labels=3, seed=3)
    cfg = RunConfig(graph_partition=4, cost_model="off")
    clean = run_distributed(g, MotifsApp(max_size=3), _mesh(4), cfg)
    plan = FaultPlan([FaultSpec("halo", 2, "halo")])
    res = run_supervised(g, MotifsApp(max_size=3),
                         dataclasses.replace(cfg, faults=plan),
                         ShardMapBackend(_mesh(4)))
    assert res.recovery["degradations"] == ["halo_gather"]
    assert plan.fired == [("halo", 2, "halo")]
    assert res.patterns == clean.patterns
    for a, b in zip(clean.stats.steps, res.stats.steps):
        assert (a.n_children, a.n_host_syncs) == (b.n_children,
                                                  b.n_host_syncs)


def test_traced_shard_run(tmp_path):
    """Tracing adds no host sync, covers the wall (the trace names the
    backend), and ``trace_sync`` probes the halo exchange into
    ``t_exchange``."""
    g = TG.random_labeled(40, 150, n_labels=3, seed=3)
    cfg = RunConfig(cost_model="off", graph_partition=4)
    ref = run_distributed(g, MotifsApp(max_size=3), _mesh(4), cfg)
    traced = run_distributed(
        g, MotifsApp(max_size=3), _mesh(4),
        dataclasses.replace(cfg, trace=True, trace_dir=str(tmp_path)))
    assert traced.patterns == ref.patterns
    assert [s.n_host_syncs for s in traced.stats.steps] == \
        [s.n_host_syncs for s in ref.stats.steps]
    doc = json.load(open(traced.trace_path))
    assert obs.validate_chrome_trace(doc) == []
    assert obs.phase_coverage(doc)["coverage"] >= 0.90
    assert '"backend": "shard_map"' in json.dumps(doc)
    synced = run_distributed(g, MotifsApp(max_size=3), _mesh(4),
                             dataclasses.replace(cfg, trace=True,
                                                 trace_sync=True))
    assert synced.patterns == ref.patterns
    assert [s.n_host_syncs for s in synced.stats.steps] == \
        [s.n_host_syncs for s in ref.stats.steps]
    assert any(s.t_exchange > 0 for s in synced.stats.steps)


@pytest.mark.parametrize("mode", ["auto", "force_device", "force_host"])
def test_cost_model_modes(mode):
    """The forced tables under the backend's name, with the reference's
    source strings; every mode gives the serial patterns."""
    costmodel.clear_cache()
    g = TG.random_labeled(40, 90, n_labels=2, seed=12)
    ref = run(g, MotifsApp(max_size=3), RunConfig(cost_model="off"),
              device="cpu")
    got = run_distributed(g, MotifsApp(max_size=3), _mesh(2),
                          RunConfig(cost_model=mode))
    assert got.patterns == ref.patterns
    cm = got.stats.cost_model
    assert cm["source"] == ("static" if mode == "auto" else f"forced:{mode}")
    assert cm["backend"] == "shard_map"


# ---------------------------------------------------------------------------
# the reference's 8-device run (last: its subprocess ran beside the above)
# ---------------------------------------------------------------------------

def test_counters_match_reference_8dev(reference_8dev):
    out, err = reference_8dev.communicate(timeout=600)
    assert reference_8dev.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    ref = json.loads(line[len("RESULT"):])
    g = TG.random_labeled(40, 220, n_labels=3, seed=2)
    apps = {"motifs": lambda: MotifsApp(max_size=3),
            "fsm": lambda: FSMApp(support=3, max_size=3),
            "cliques": lambda: CliquesApp(max_size=4,
                                          collect_embeddings=True)}
    for name, (app, kw) in CONFIGS_8DEV.items():
        res = SuperstepRuntime(
            g, apps[app](),
            RunConfig(graph_partition=8, cost_model="off", **kw),
            backend=ShardMapBackend(_mesh(8)),
        ).run()
        assert sorted([list(k), v] for k, v in res.patterns.items()) == \
            ref[name]["patterns"], name
        got = [{f: getattr(s, f) for f in COUNTERS} for s in res.stats.steps]
        assert got == ref[name]["steps"], name
        assert max(s["n_host_syncs"] for s in got) <= 2, name
        assert sum(s["collective_bytes"] for s in got) > 0, name
