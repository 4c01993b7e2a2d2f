"""The port's superstep checkpoints (``repro_torch.core.runtime.checkpoint``,
DESIGN.md §9) against the JAX package's: the graph fingerprint of the same
graph (whole and partitioned), the ``.npz`` a motif run writes after step
2 (every array, and the meta apart from the app fingerprint, the wall
clock and the ``t_*`` timings), and the port's own resume, cadence, file
and fingerprint contracts, mirroring ``tests/test_checkpoint.py``'s serial
cases. Tolerance 0: hashes, arrays, strings and patterns are exact."""
import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import EngineConfig
from repro.core import graph as JG
from repro.core.apps import MotifsApp as JMotifs
from repro.core.runtime import checkpoint as jckpt
from repro_torch.core import RunConfig, graph as TG, resume, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.runtime import checkpoint as ckpt_lib
from repro_torch.core.runtime import faults as faults_lib
from repro_torch.core.runtime import latest_checkpoint, sweep_stale_tmp
from torch_parity import graph_pair, jax_run

SMALL = dict(chunk_size=64, initial_capacity=64)
APPS = [
    lambda: MotifsApp(max_size=3, collect_embeddings=True),
    lambda: CliquesApp(max_size=4, collect_embeddings=True),
    lambda: FSMApp(support=3, max_size=3, collect_embeddings=True),
]


def _graph(seed=3):
    return TG.random_labeled(40, 90, n_labels=3, seed=seed)


def _emb_sets(res):
    return {k: set(map(tuple, v.tolist())) for k, v in res.embeddings.items()}


def _assert_same(base, other):
    assert base.patterns == other.patterns
    assert _emb_sets(base) == _emb_sets(other)


def _ckpts(td):
    return sorted(glob.glob(os.path.join(str(td), "ckpt-step*.npz")))


def _run(g, app, **kw):
    return run(g, app, RunConfig(**SMALL, **kw), device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_graph_fingerprint_matches_reference():
    """Same hash as the reference for the same graph, for the whole-graph
    and the partitioned layout (which hash alike), and the same layout
    string for the partitioned one."""
    for make in (lambda G: G.random_labeled(40, 90, n_labels=3, seed=3),
                 lambda G: G.citeseer_like(0.05)):
        jg, tg = graph_pair(make)
        want = jckpt.graph_fingerprint(JG.to_device(jg))
        dg = TG.to_device(tg, "cpu")
        pg = TG.to_partitioned(tg, 3, device="cpu")
        assert ckpt_lib.graph_fingerprint(dg) == want
        assert ckpt_lib.graph_fingerprint(pg) == want
        assert ckpt_lib.graph_layout(dg) == "replicated"
        assert ckpt_lib.graph_layout(pg) == jckpt.graph_layout(
            JG.to_partitioned(jg, 3))


def test_step2_checkpoint_matches_reference(tmp_path):
    """The cut written after step 2 of a size-3 motif run holds the JAX
    package's arrays bit for bit, and its meta less the app fingerprint
    (the app's module differs), the wall clock and the ``t_*`` timings."""
    jg, tg = graph_pair(lambda G: G.random_labeled(40, 90, n_labels=3,
                                                   seed=3))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jres = jax_run(jg, JMotifs(max_size=3), EngineConfig(
        cost_model="off", checkpoint_dir=str(jdir), **SMALL))
    tres = run(tg, MotifsApp(max_size=3), RunConfig(
        cost_model="off", checkpoint_dir=str(tdir), **SMALL), device="cpu")
    assert tres.patterns == jres.patterns
    names = [os.path.basename(p) for p in _ckpts(jdir)]
    assert names == [os.path.basename(p) for p in _ckpts(tdir)]
    assert "ckpt-step0003.npz" in names
    want = jckpt.verify(str(jdir / "ckpt-step0003.npz"))
    got = ckpt_lib.verify(str(tdir / "ckpt-step0003.npz"))
    assert sorted(got) == sorted(want)
    for key in want:
        if key not in ("meta", "checksum"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key

    def meta(arrays):
        m = json.loads(str(arrays["meta"][()]))
        del m["app_fp"], m["wall_time"]
        m["stats"] = [{k: v for k, v in s.items() if not k.startswith("t_")}
                      for s in m["stats"]]
        return m

    assert meta(got) == meta(want)
    assert ckpt_lib.load(str(tdir / "ckpt-step0003.npz")).graph_fp == \
        jckpt.load(str(jdir / "ckpt-step0003.npz")).graph_fp


# ---------------------------------------------------------------------------
# resume == uninterrupted, every app under every store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [
    dict(store="raw"), dict(store="odag"),
    dict(store="raw", device_budget_bytes=2048),
], ids=["raw", "odag", "spill"])
def test_resume_equals_uninterrupted(store, tmp_path):
    g = _graph()
    for i, mk in enumerate(APPS):
        td = tmp_path / str(i)
        ref = _run(g, mk(), checkpoint_dir=str(td), **store)
        files = _ckpts(td)
        assert files, "run wrote no checkpoints"
        # the earliest cut replays the longest tail; the directory resolves
        # to the latest
        _assert_same(ref, resume(g, mk(), files[0], RunConfig(**SMALL, **store),
                                 device="cpu"))
        _assert_same(ref, resume(g, mk(), str(td), RunConfig(**SMALL, **store),
                                 device="cpu"))


def test_resume_preserves_stats_history(tmp_path):
    g = _graph(17)
    ref = _run(g, MotifsApp(max_size=4), checkpoint_dir=str(tmp_path))
    resumed = resume(g, MotifsApp(max_size=4), _ckpts(tmp_path)[0],
                     device="cpu")
    assert [s.step for s in resumed.stats.steps] == [
        s.step for s in ref.stats.steps]
    for a, b in zip(ref.stats.steps, resumed.stats.steps):
        assert (a.n_frontier, a.n_children, a.n_quick_patterns) == (
            b.n_frontier, b.n_children, b.n_quick_patterns)
    assert resumed.stats.total_embeddings == ref.stats.total_embeddings
    assert len(resumed.aggregates) == len(ref.aggregates)
    np.testing.assert_array_equal(resumed.aggregates[-1].counts,
                                  ref.aggregates[-1].counts)


# ---------------------------------------------------------------------------
# cadence, fingerprints, file handling
# ---------------------------------------------------------------------------

def test_checkpoint_every_cadence(tmp_path):
    run(TG.random_labeled(40, 120, n_labels=2, seed=11), MotifsApp(max_size=4),
        RunConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2),
        device="cpu")
    steps = [int(os.path.basename(f)[len("ckpt-step"):-len(".npz")])
             for f in _ckpts(tmp_path)]
    assert steps, "no checkpoints written"
    # cursor step k+1 is written after superstep k; cadence 2 keeps even
    # completed steps only
    assert all((s - 1) % 2 == 0 for s in steps)


def test_latest_checkpoint_resolution(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for step in (2, 10, 3):
        open(tmp_path / f"ckpt-step{step:04d}.npz", "wb").close()
    (tmp_path / "not-a-checkpoint.npz").touch()
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == \
        "ckpt-step0010.npz"


def test_fingerprint_guards(tmp_path):
    g = _graph(13)
    _run(g, MotifsApp(max_size=4), checkpoint_dir=str(tmp_path))
    path = _ckpts(tmp_path)[0]
    with pytest.raises(ValueError, match="different app"):
        resume(g, MotifsApp(max_size=3), path, device="cpu")
    with pytest.raises(ValueError, match="different graph"):
        resume(_graph(14), MotifsApp(max_size=4), path, device="cpu")
    with pytest.raises(FileNotFoundError):
        resume(g, MotifsApp(max_size=4), str(tmp_path / "empty"),
               device="cpu")


def test_checkpoint_is_single_atomic_file(tmp_path):
    res = _run(_graph(15), MotifsApp(max_size=3), checkpoint_dir=str(tmp_path))
    files = os.listdir(tmp_path)
    assert files
    assert all(f.startswith("ckpt-step") and f.endswith(".npz") for f in files)
    assert not any(".tmp-" in f for f in files), "torn staging file left"
    # one file holds the payload, its meta and its SHA-256
    arrays = ckpt_lib.verify(_ckpts(tmp_path)[-1])
    assert {"meta", "checksum", "store_frontier"} <= set(arrays)
    assert any(s.t_checkpoint > 0 for s in res.stats.steps)
    assert res.stats.steps[-1].t_checkpoint == 0


def test_stale_tmp_swept(tmp_path):
    orphan = tmp_path / "ckpt-step0007.npz.tmp-12345.npz"
    orphan.write_bytes(b"x")
    (tmp_path / "ckpt-step0007.npz").write_bytes(b"real cut")
    (tmp_path / "other.tmp").write_bytes(b"y")
    assert sweep_stale_tmp(str(tmp_path)) == [str(orphan)]
    assert sorted(os.listdir(tmp_path)) == ["ckpt-step0007.npz", "other.tmp"]
    assert sweep_stale_tmp(str(tmp_path / "missing")) == []
    # and on resume from a directory
    g, td = _graph(), tmp_path / "run"
    ref = _run(g, APPS[0](), checkpoint_dir=str(td))
    orphan = td / "ckpt-step0002.npz.tmp-9999.npz"
    orphan.write_bytes(b"torn half-written payload")
    bystander = td / "unrelated.npz"
    bystander.write_bytes(b"not a staging file")
    _assert_same(ref, resume(g, APPS[0](), str(td), RunConfig(**SMALL),
                             device="cpu"))
    assert not orphan.exists() and bystander.exists()


# ---------------------------------------------------------------------------
# a real process death: the child exits at a phase boundary, the parent
# resumes from what survived
# ---------------------------------------------------------------------------

KILL_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.core import FaultPlan, RunConfig, graph as G, run
    from repro_torch.core.apps import MotifsApp

    run(
        G.random_labeled(40, 90, n_labels=3, seed=3),
        MotifsApp(max_size=3, collect_embeddings=True),
        RunConfig(chunk_size=64, initial_capacity=64,
                  checkpoint_dir=sys.argv[1],
                  faults=FaultPlan([(sys.argv[2], int(sys.argv[3]), "exit")])),
        device="cpu",
    )
    raise SystemExit("fault never tripped")
    """
)


def test_real_process_death(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", KILL_SCRIPT,
         str(tmp_path), "seal", "2"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == faults_lib.EXIT_CODE, proc.stderr[-3000:]
    assert _ckpts(tmp_path), "no checkpoint survived the kill"
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    clean = _run(_graph(), APPS[0]())
    _assert_same(clean, resume(_graph(), APPS[0](), str(tmp_path),
                               RunConfig(**SMALL), device="cpu"))
