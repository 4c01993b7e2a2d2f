"""Units of the port's shard-map backend (``repro_torch.core.runtime.shard``)
and of what it brings to the other modules, on the CPU: the frontier
slices, the halo knob, the mesh and its collectives, the dense ODAG
exchange, the ``halo_gather`` rung and the halo exchange. Held to the JAX
package's functions where it has one (``pad_parts``, ``partition_frontier``,
``resolve_halo``, ``build_dense``/``dense_to_ragged``, the dense ODAG store,
``apply_degradation``), to numpy for the collectives (the reference's live
inside ``shard_map``), and to the serial tile view for the halo exchange.
Everything is integers and booleans: tolerance 0. Whole runs are in
``test_torch_distributed.py``."""
import numpy as np
import pytest
import torch

from repro.core import odag as jodag
from repro.core.graph import to_device as jto_device
from repro.core.runtime import RunConfig as JRunConfig
from repro.core.runtime import faults as jfaults
from repro.core.runtime import shard as jshard
from repro.core.store import ODAGStore as JODAGStore
from repro.kernels import dispatch as jdispatch
from repro_torch.core import explore as texplore
from repro_torch.core import graph as TG
from repro_torch.core import odag as todag
from repro_torch.core import run
from repro_torch.core.apps import MotifsApp
from repro_torch.core.runtime import RunConfig, faults as faults_lib
from repro_torch.core.runtime import shard
from repro_torch.core.store import ODAGStore
from repro_torch.kernels import dispatch
from torch_parity import graph_pair, host_extract, quick_compiles


@pytest.mark.parametrize("b,k,w", [(23, 3, 4), (0, 2, 3), (5, 1, 8)])
def test_frontier_slices_match_reference(b, k, w):
    """``partition_frontier`` (the even split) and ``pad_parts`` (uneven
    store parts), padding and counts included."""
    rng = np.random.default_rng(b + 10 * w)
    f = rng.integers(0, 100, size=(b, k)).astype(np.int32)
    for got, want in zip(shard.partition_frontier(f, w),
                         jshard.partition_frontier(f, w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    cuts = np.sort(rng.integers(0, b + 1, size=w - 1))
    parts = np.split(f, cuts)
    for got, want in zip(shard.pad_parts(parts, k),
                         jshard.pad_parts(parts, k)):
        np.testing.assert_array_equal(got, want)


def test_resolve_halo_matches_reference():
    assert dispatch.HALO_STRATEGIES == jdispatch.HALO_STRATEGIES
    for halo in (None, "auto", "alltoall", "gather"):
        assert dispatch.resolve_halo(halo) == jdispatch.resolve_halo(halo)
        assert RunConfig(halo=halo).resolve_halo() == \
            JRunConfig(halo=halo).resolve_halo()
    for bad in ("ring", "all_to_all"):
        with pytest.raises(ValueError):
            jdispatch.resolve_halo(bad)
        with pytest.raises(ValueError, match="halo"):
            dispatch.resolve_halo(bad)
        with pytest.raises(ValueError, match="halo"):
            RunConfig(halo=bad).validate()
    cfg = RunConfig()
    assert (cfg.axes, cfg.naive_aggregation) == \
        (JRunConfig().axes, JRunConfig().naive_aggregation)


def test_halo_gather_rung_matches_reference():
    """A failed halo exchange takes ``halo_gather`` once, then no rung;
    on the card too (the rung runs kernels, not their plain versions)."""
    for halo in (None, "alltoall", "gather"):
        cfg, jcfg = RunConfig(halo=halo), JRunConfig(halo=halo)
        for phase in ("halo", "expand"):
            got, ev = faults_lib.apply_degradation(cfg, phase, "halo")
            want, jev = jfaults.apply_degradation(jcfg, phase, "halo")
            assert ev == jev and got.halo == want.halo
            assert faults_lib.apply_degradation(
                cfg, phase, "halo", on_card=True) == (got, ev)
    got, ev = faults_lib.apply_degradation(RunConfig(), "halo", "halo")
    assert ev == "halo_gather" and got.resolve_halo() == "gather"


def test_mesh_ranks_and_axes():
    """Workers in row-major rank order over the named axes; axes outside
    the sharded ones replicate (one replica runs)."""
    devs = [torch.device("cpu")] * 6
    mesh = shard.make_mesh((2, 3), ("pod", "data"), device=devs)
    assert mesh.shape == {"pod": 2, "data": 3}
    assert shard.mesh_axis_size(mesh, ("pod", "data")) == 6
    assert shard.mesh_axis_size(mesh, ("data",)) == 3
    assert len(mesh.worker_devices(("pod", "data"))) == 6
    assert len(mesh.worker_devices(("data",))) == 3
    assert [shard._linear_rank(mesh, ("pod", "data"), {"pod": p, "data": d})
            for p in range(2) for d in range(3)] == list(range(6))
    with pytest.raises(ValueError):
        shard.make_mesh((4,), ("data",), device=devs)
    one = shard.make_mesh((4,), ("data",), device="cpu")
    assert one.worker_devices(("data",)) == [torch.device("cpu")] * 4


@pytest.mark.parametrize("w", [1, 3, 8])
def test_collectives_match_numpy(w):
    """``psum`` (exact int64), ``pmax`` (OR of bitmaps, max of counts),
    ``all_gather`` (rank-order stack) and ``all_to_all`` (the (W, W, ...)
    transpose)."""
    rng = np.random.default_rng(w)
    devices = shard.make_mesh((w,), ("data",), device="cpu").worker_devices(
        ("data",))
    counts = rng.integers(0, 2**40, size=(w, 17)).astype(np.int64)
    got = shard.psum([torch.from_numpy(c.copy()) for c in counts], devices)
    assert len(got) == w
    for g_ in got:
        np.testing.assert_array_equal(g_.numpy(), counts.sum(axis=0))
    bits = rng.random((w, 5, 33)) < 0.2
    got = shard.pmax([torch.from_numpy(b.copy()) for b in bits], devices)
    for g_ in got:
        np.testing.assert_array_equal(g_.numpy(), bits.any(axis=0))
    got = shard.pmax([torch.from_numpy(c.copy()) for c in counts], devices)
    for g_ in got:
        np.testing.assert_array_equal(g_.numpy(), counts.max(axis=0))
    parts = rng.integers(-5, 5, size=(w, 4, 3)).astype(np.int32)
    for g_ in shard.all_gather([torch.from_numpy(p) for p in parts],
                               devices):
        np.testing.assert_array_equal(g_.numpy(), parts)
    blocks = rng.integers(0, 99, size=(w, w, 6)).astype(np.int32)
    got = shard.all_to_all([torch.from_numpy(b) for b in blocks], devices)
    for r, g_ in enumerate(got):
        np.testing.assert_array_equal(g_.numpy(), blocks[:, r])


def _frontier(tg, size):
    """The size-``size`` motif embeddings of ``tg`` (the port's serial run,
    held to the reference's in ``test_torch_engine.py``)."""
    res = run(tg, MotifsApp(max_size=size, collect_embeddings=True),
              RunConfig(cost_model="off"), device="cpu")
    return np.asarray(res.embeddings[size])


def test_dense_merge_and_extract_matches_reference():
    """``build_dense`` of two halves, their OR and ``dense_to_ragged``, word
    for word against the reference; the extraction gives the rows back."""
    jg, tg = graph_pair(lambda G: G.random_labeled(60, 150, n_labels=1,
                                                   seed=6))
    emb = _frontier(tg, 3)
    half = len(emb) // 2
    parts = []
    for rows in (emb[:half], emb[half:]):
        d, jd = todag.build_dense(rows, tg.n, 3), jodag.build_dense(
            rows, jg.n, 3)
        np.testing.assert_array_equal(d.domain_bits,
                                      np.asarray(jd.domain_bits))
        np.testing.assert_array_equal(d.conn_bits, np.asarray(jd.conn_bits))
        assert d.n_bytes == jd.n_bytes
        parts.append(d)
    merged = parts[0].merged(parts[1])
    jmerged = jodag.DenseODAG(k=3,
                              domain_bits=merged.domain_bits,
                              conn_bits=merged.conn_bits)
    rag, jrag = todag.dense_to_ragged(merged), jodag.dense_to_ragged(jmerged)
    for a, b in zip(rag.domains + rag.conn, jrag.domains + jrag.conn):
        np.testing.assert_array_equal(a, b)
    ext = todag.extract(TG.to_device(tg, "cpu"), rag)
    assert set(map(tuple, ext.tolist())) == set(map(tuple, emb.tolist()))


def test_odag_store_dense_exchange_matches_reference():
    """Three workers' appends (one empty) seal through the dense merge:
    the same frontier, ODAG, ``exchange_bytes`` and per-worker parts as the
    reference store's; one worker's rows take the ragged build."""
    jg, tg = graph_pair(lambda G: G.random_labeled(40, 90, n_labels=1,
                                                   seed=4))
    emb = _frontier(tg, 3)
    third = len(emb) // 3
    dg = TG.to_device(tg, "cpu")
    for blocks in ([emb[:third], emb[third:], emb[:0]], [emb]):
        ts = ODAGStore(dg, dense_exchange=True)
        js = JODAGStore(jto_device(jg), dense_exchange=True)
        for w, rows in enumerate(blocks):
            ts.append(torch.from_numpy(rows), worker=w, count=len(rows))
            js.append(rows, worker=w)
        ts.seal(3)
        js.seal(3)
        assert ts.exchange_bytes == js.exchange_bytes > 0
        assert ts.stored_bytes == js.stored_bytes
        with host_extract(), quick_compiles():
            want = js.materialize()
            jparts = js.worker_parts(3)
        np.testing.assert_array_equal(ts.materialize(), want)
        assert set(map(tuple, want.tolist())) == set(map(tuple,
                                                         emb.tolist()))
        for a, b in zip(ts.worker_parts(3), jparts):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["vertex", "edge"])
def test_halo_exchange_alltoall_equals_gather_equals_serial(mode):
    """At W = 4 each worker's tile view from the all-to-all exchange equals
    the all-gather's and the serial ``build_tile_view`` of its slice over
    the whole partitioned graph (itself held to the reference's)."""
    w = 4
    tg = TG.random_labeled(60, 150, 3, seed=0)
    pg = TG.to_partitioned(tg, w, device="cpu")
    rng = np.random.default_rng(1)
    ids = tg.n if mode == "vertex" else tg.m
    rows = rng.integers(0, ids, size=(4 * w * 5, 2)).astype(np.int32)
    rows[rng.random(len(rows)) < 0.2, 1] = -1
    padded, counts = shard.partition_frontier(rows, w)
    devices = [torch.device("cpu")] * w
    members, n_valid = [], []
    for s in range(w):
        m = torch.from_numpy(padded[s])
        nv = torch.from_numpy(((np.arange(padded.shape[1]) < counts[s])
                               * 2 - (padded[s, :, 1] < 0)).astype(np.int32))
        members.append(m)
        n_valid.append(nv.clamp(min=0))
    locals_ = [shard.local_shard(pg, s, "cpu") for s in range(w)]
    views = {
        halo: shard.halo_fetch_tile(
            locals_, members, n_valid, mode=mode, halo=halo,
            devices=devices, w=w, rows=pg.tile_rows, n=pg.n,
            use_pallas=True, compact_kernel=True)
        for halo in ("alltoall", "gather")
    }
    for s in range(w):
        serial = texplore.build_tile_view(pg, members[s], n_valid[s], mode)
        for a2a, gat, ser in zip(views["alltoall"][s], views["gather"][s],
                                 serial):
            np.testing.assert_array_equal(a2a.numpy(), ser.numpy())
            np.testing.assert_array_equal(gat.numpy(), ser.numpy())


def test_worker_body_pieces_match_one_piece(monkeypatch):
    """A slice expanded in one piece and in row pieces (appended on the
    device) gives the one fused chunk program's children, counts and quick
    codes, also past ``out_cap``."""
    from repro_torch.core.apps import CliquesApp

    tg = TG.random_labeled(60, 150, 3, seed=0)
    dg = TG.to_device(tg, "cpu")
    rows = np.asarray(tg.edges[:70], np.int32)
    m = torch.from_numpy(rows)
    nv = torch.full((len(rows),), 2, dtype=torch.int32)
    for app in (MotifsApp(max_size=3), CliquesApp(max_size=3)):
        for out_cap in (4096, 64):
            kw = dict(mode="vertex", app=app, with_patterns=True,
                      with_local_verts=True, use_pallas=True, fused=False,
                      compact_kernel=True)
            whole = texplore.fused_chunk_step(dg, m, nv, out_cap, **kw)
            one = shard.worker_body(dg, m, nv, out_cap, **kw)
            monkeypatch.setattr(shard, "BODY_SLOTS", 3 * 2 * dg.max_degree)
            pieces = shard.worker_body(dg, m, nv, out_cap, **kw)
            monkeypatch.undo()
            for got in (one, pieces):
                assert int(got[1]) == int(whole[1])
                assert [int(x) for x in got[4:]] == \
                    [int(x) for x in whole[4:]]
                for a, b in zip(got[:4], whole[:4]):
                    np.testing.assert_array_equal(a.numpy(), b.numpy())
