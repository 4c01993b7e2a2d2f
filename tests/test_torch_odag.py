"""The port's ODAG (``repro_torch.core.odag``, paper §5.2/§5.3) and its
store's payload vs the JAX package's ``repro.core.odag`` and
``repro.core.store``: build, merge, the §5.3 cost masks, extraction of
whole ODAGs and of partitions in vertex and in edge mode, with and without
an app filter, and ``ODAGStore.state_dict`` — arrays, masks and rows equal,
rows in the same order (tolerance 0). The frontiers come from the port's
runs on seeded graphs, and some are cut to a random subset, so the ODAG
encodes spurious paths that the filters must drop. The JAX side runs its
jnp routes, its extraction under ``torch_parity.host_extract`` (the same
integers, compiled once a row bucket; one test holds it to the eager
form); the port runs on the CPU, where the ``canonical_check`` and
``stream_compact`` wrappers take their plain versions."""
import numpy as np
import pytest
import torch

from repro.core import odag as jodag, to_device as jto_device
from repro.core.apps import CliquesApp as JCliques, FSMApp as JFSM
from repro.core.runtime import programs as jprograms
from repro.core.store import ODAGStore as JODAGStore
from repro_torch.core import RunConfig, graph as TG, odag as todag, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.runtime import programs as tprograms
from repro_torch.core.store import ODAGStore
from torch_parity import graph_pair, host_extract

CFG = RunConfig(chunk_size=2048, initial_capacity=2048)


def _frontier(tg, app, size, keep=None, seed=0):
    """The port's size-``size`` embeddings of ``app`` on ``tg``; with
    ``keep`` a seeded random share of them, in a shuffled order."""
    emb = run(tg, app, CFG, device="cpu").embeddings[size]
    if keep is None:
        return emb
    rng = np.random.default_rng(seed)
    sel = rng.permutation(len(emb))[: max(1, int(len(emb) * keep))]
    return emb[sel]


def _same_odag(t, j):
    assert t.k == j.k
    assert len(t.domains) == len(j.domains) and len(t.conn) == len(j.conn)
    for a, b in zip(t.domains, j.domains):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.conn, j.conn):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    assert t.n_bytes == j.n_bytes
    assert t.counts() == j.counts()
    assert t.path_upper_bound() == j.path_upper_bound()


def _vertex_case():
    jg, tg = graph_pair(lambda G: G.random_labeled(60, 180, n_labels=2,
                                                   seed=9))
    emb = _frontier(tg, MotifsApp(max_size=3, collect_embeddings=True), 3,
                    keep=0.6)
    return jg, tg, emb


def _edge_case():
    jg, tg = graph_pair(lambda G: G.random_labeled(40, 90, n_labels=2,
                                                   seed=3))
    emb = _frontier(tg, FSMApp(support=1, max_size=3,
                               collect_embeddings=True), 3, keep=0.6)
    return jg, tg, emb


@pytest.mark.parametrize("mode", ["vertex", "edge"])
def test_build_and_merge_match_reference(mode):
    _, _, emb = _vertex_case() if mode == "vertex" else _edge_case()
    _same_odag(todag.build(emb), jodag.build(emb))
    _same_odag(todag.build(emb[:, :2], k=2), jodag.build(emb[:, :2], k=2))
    third = len(emb) // 3
    shares = [emb[:third], emb[third:], emb[:0]]     # one worker empty
    merged = todag.merge([todag.build(s, k=3) for s in shares])
    _same_odag(merged, jodag.merge([jodag.build(s, k=3) for s in shares]))
    _same_odag(merged, todag.build(emb))


@pytest.mark.parametrize("mode,filtered", [
    ("vertex", False), ("vertex", True), ("edge", False), ("edge", True),
])
def test_extract_matches_reference(mode, filtered):
    """Whole-ODAG extraction, rows in the reference's order; the filtered
    cases re-apply cliques' filter (vertex) or FSM's vertex bound (edge)
    through ``store_app_filter``."""
    if mode == "vertex":
        jg, tg = graph_pair(lambda G: G.random_labeled(50, 180, n_labels=1,
                                                       seed=7))
        tapp, japp = ((CliquesApp(max_size=3), JCliques(max_size=3))
                      if filtered else
                      (MotifsApp(max_size=3, collect_embeddings=True), None))
        emb = _frontier(tg, tapp, 3, keep=0.5, seed=1)
    else:
        jg, tg, emb = _edge_case()
        tapp = FSMApp(support=1, max_size=3, max_vertices=3)
        japp = JFSM(support=1, max_size=3, max_vertices=3)
    jdg, tdg = jto_device(jg), TG.to_device(tg, "cpu")
    jphi = jprograms.store_app_filter(japp, jdg) if filtered else None
    tphi = tprograms.store_app_filter(tapp, tdg) if filtered else None
    assert (tphi is None) == (jphi is None)
    with host_extract():
        want = jodag.extract(jdg, jodag.build(emb), app_filter=jphi,
                             mode=mode)
    got = todag.extract(tdg, todag.build(emb), app_filter=tphi, mode=mode,
                        use_pallas=mode == "vertex", chunk=997)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(got) >= len(emb) if not filtered else len(got) > 0


def _dense_extract(tdg, o, mode):
    """Plain dense version of the extraction: every path against the whole
    next-level domain (the reference's P x D block), in torch."""
    paths = torch.from_numpy(o.domains[0])[:, None]
    for lvl in range(o.k - 1):
        dom = torch.from_numpy(o.domains[lvl + 1])
        a = np.searchsorted(o.domains[lvl], paths[:, lvl].numpy())
        mask = torch.from_numpy(o.conn[lvl][a]).reshape(-1)
        p, d = len(paths), len(dom)
        mem = paths.repeat_interleave(d, dim=0)
        cnd = dom.repeat(p)
        nv = torch.full((p * d,), lvl + 1, dtype=torch.int32)
        keep = todag._keep(tdg, mem, cnd, nv, mode, False, None) & mask
        paths = torch.cat([mem[keep], cnd[keep, None]], 1)
    return paths.numpy()


def test_sparse_enumeration_matches_dense():
    """The CSR enumeration gives the dense block's rows in its order,
    whatever the chunk of pairs, with one host sync per level and chunk
    (and one for the result)."""
    _, tg, emb = _vertex_case()
    tdg = TG.to_device(tg, "cpu")
    o = todag.build(emb[:400])
    want = _dense_extract(tdg, o, "vertex")
    pairs = sum(int(c.sum()) for c in o.conn[:1])
    for chunk in (1, 13, 1 << 22):
        stats = {}
        got = todag.extract(tdg, o, chunk=chunk, stats=stats)
        np.testing.assert_array_equal(got, want)
        assert stats["levels"] == 2 and stats["kept"] >= len(want)
        assert stats["host_syncs"] == stats["chunks"] + 1
        assert stats["pairs"] >= pairs
        if chunk == 1:
            assert stats["chunks"] == stats["pairs"]
    # the CSR of a row subset is the subset of the CSR
    csr = todag.conn_csr(o)
    rows = np.flatnonzero(np.arange(len(o.domains[0])) % 3 == 1)
    sub = todag.conn_csr(todag.ODAG(k=2, domains=o.domains[:2],
                                    conn=[o.conn[0][rows]]))[0]
    for a, b in zip(todag.csr_rows(csr[0], rows), sub):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["vertex", "edge"])
def test_partitions_match_reference(mode):
    """The §5.3 cost masks for several worker counts, and for three
    workers each partition's rows, equal the reference's; the partitions
    union to the whole, in order."""
    jg, tg, emb = _vertex_case() if mode == "vertex" else _edge_case()
    jdg, tdg = jto_device(jg), TG.to_device(tg, "cpu")
    to, jo = todag.build(emb), jodag.build(emb)
    whole = todag.extract(tdg, to, mode=mode)
    for n_workers in (1, 2, 3, 8):
        tm = todag.partition_by_cost(to, n_workers)
        jm = jodag.partition_by_cost(jo, n_workers)
        assert len(tm) == len(jm) == n_workers
        for a, b in zip(tm, jm):
            assert a.dtype == bool
            np.testing.assert_array_equal(a, b)
        parts = [todag.extract_partition(tdg, to, m, mode=mode,
                                         csr=todag.conn_csr(to))
                 for m in tm]
        np.testing.assert_array_equal(np.concatenate(parts), whole)
        if n_workers == 3:
            with host_extract():
                want = [jodag.extract_partition(jdg, jo, m, mode=mode)
                        for m in jm]
            for got, w in zip(parts, want):
                np.testing.assert_array_equal(got, w)


def _star(G, n_leaves=8):
    return G.Graph(
        n=n_leaves + 1,
        labels=np.zeros(n_leaves + 1, dtype=np.int32),
        edges=np.array([[0, v] for v in range(1, n_leaves + 1)], np.int32),
    )


def test_single_hub_partition():
    """Star graph: one first-level element carries the cost; it goes to
    one worker, as in the reference, and the shards union exactly."""
    jg, tg = graph_pair(_star)
    jdg, tdg = jto_device(jg), TG.to_device(tg, "cpu")
    emb = _frontier(tg, MotifsApp(max_size=3, collect_embeddings=True), 3)
    to, jo = todag.build(emb), jodag.build(emb)
    tm, jm = todag.partition_by_cost(to, 3), jodag.partition_by_cost(jo, 3)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    assert (np.stack(tm).sum(axis=0) == 1).all()
    shards = [todag.extract_partition(tdg, to, m) for m in tm if m.any()]
    got = np.concatenate(shards)
    np.testing.assert_array_equal(got, todag.extract(tdg, to))
    assert set(map(tuple, got.tolist())) == set(map(tuple, emb.tolist()))


def test_empty_odag():
    o, jo = (todag.build(np.zeros((0, 3), np.int32), k=3),
             jodag.build(np.zeros((0, 3), np.int32), k=3))
    _same_odag(o, jo)
    masks = todag.partition_by_cost(o, 4)
    assert len(masks) == 4
    assert all(m.shape == (0,) and m.dtype == bool for m in masks)
    got = todag.extract(TG.to_device(_star(TG), "cpu"), o)
    assert got.shape == (0, 3) and got.dtype == np.int32


def test_odag_store_state_dict_matches_reference():
    """The sealed store's payload equals the reference's array for array,
    and a store restored from the reference's payload extracts the same
    rows as the reference's store."""
    jg, tg, emb = _vertex_case()
    jdg, tdg = jto_device(jg), TG.to_device(tg, "cpu")
    ts, js = ODAGStore(tdg), JODAGStore(jdg)
    half = len(emb) // 2
    for s in (ts, js):
        s.append(emb[:half])
        s.append(emb[half:])
        s.seal(3)
    tsd, jsd = ts.state_dict(), js.state_dict()
    with host_extract():
        jrows = js.materialize()
    assert tsd["kind"] == jsd["kind"] == "odag"
    assert tsd["meta"] == jsd["meta"]
    assert sorted(tsd["arrays"]) == sorted(jsd["arrays"])
    for name, arr in jsd["arrays"].items():
        assert tsd["arrays"][name].dtype == arr.dtype
        np.testing.assert_array_equal(tsd["arrays"][name], arr)
    restored = ODAGStore(tdg)
    restored.from_state_dict(jsd)
    assert restored.n_rows == js.n_rows and restored.size == 3
    assert restored.stored_bytes == js.stored_bytes
    np.testing.assert_array_equal(restored.materialize(), jrows)
    with pytest.raises(ValueError):
        restored.from_state_dict({"kind": "raw", "meta": {}, "arrays": {}})


def test_host_extract_swap_matches_eager():
    """``torch_parity.host_extract`` gives the eager extraction's rows:
    vertex mode under cliques' filter, edge mode under FSM's (size-2
    ODAGs: the eager form compiles each of its operations anew)."""
    jg, tg = graph_pair(lambda G: G.random_labeled(30, 80, n_labels=1,
                                                   seed=2))
    ejg, etg = graph_pair(lambda G: G.random_labeled(40, 90, n_labels=2,
                                                     seed=3))
    vemb = _frontier(tg, CliquesApp(max_size=2), 2, keep=0.5)
    eemb = _frontier(etg, FSMApp(support=1, max_size=2,
                                 collect_embeddings=True), 2, keep=0.5)
    for mode, g, rows, app in (
        ("vertex", jto_device(jg), vemb, JCliques(max_size=3)),
        ("edge", jto_device(ejg), eemb,
         JFSM(support=1, max_size=3, max_vertices=2)),
    ):
        o = jodag.build(rows)
        phi = jprograms.store_app_filter(app, g)
        eager = jodag.extract(g, o, app_filter=phi, mode=mode)
        with host_extract():
            swapped = jodag.extract(g, o, app_filter=phi, mode=mode)
        assert swapped.dtype == eager.dtype
        np.testing.assert_array_equal(swapped, eager)
        assert len(eager)
