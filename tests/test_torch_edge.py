"""The port's edge-mode exploration (FSM's path) vs the JAX package's:
``canonical.edge_check``, ``explore.expand_edge``, the edge arms of
``expand_and_compact`` and ``fused_chunk_step`` (codes, the local-vertex
table, level-1 partials), ``pattern.quick_pattern_edge``, the edge-mode
halo and tile view of the partitioned layout, and the host canonical
orders. Each runs over the whole graph and over a 2-way tile view, on
canonical edge frontiers of sizes 1-3 made from one seed. Outputs are
integers and booleans: tolerance 0. The JAX side runs its jnp routes (edge
mode has no Pallas kernel in either package); the port runs its kernel
routes, whose plain versions take CPU tensors, and its plain routes. The
last test holds ``torch_parity.jax_run``'s swaps to the eager functions of
the JAX package they stand for. The module keeps to 14 cases (see
``test_torch_fsm.py``)."""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset, canonical as jcanonical
from repro.core import explore as jexplore, graph as JG
from repro.core import pattern as jpattern
from repro.core import EngineConfig
from repro.core.apps import FSMApp as JFSM
from repro.core.runtime import programs as jprograms
from repro_torch.core import RunConfig, bitset as tbitset
from repro_torch.core import canonical as tcanonical, explore as texplore
from repro_torch.core import graph as TG, pattern as tpattern, run
from repro_torch.core.apps import FSMApp
from repro_torch.kernels.canonical_check import ops as tcc_ops
from torch_parity import SWAPS, assert_same_arrays, graph_pair, jax_run
from torch_parity import quick_compiles

LAYOUTS = ["whole", "tile"]
ROWS, PAD_TO = 48, 64
#: the reference's functions as programs, shared by every case (their
#: eager forms compile every operation on its own)
jtile_view = jax.jit(jexplore.build_tile_view, static_argnums=3)
jedge_check = jax.jit(jcanonical.edge_check)
jexpand_edge = jax.jit(lambda g, m, n: tuple(jexplore.expand_edge(g, m, n)))
jquick_edge = jax.jit(
    lambda g, m, n: tuple(jpattern.quick_pattern_edge(g, m, n)))
jhalo = jax.jit(jexplore.halo_vertices, static_argnums=3)


@pytest.fixture(autouse=True, scope="module")
def _quick_compiles():
    """Every JAX program of the module compiled under
    ``torch_parity.quick_compiles``: the module's jitted and eager
    reference functions compile once a shape, as ``jax_run``'s do."""
    with quick_compiles():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setting():
    """A labeled graph in both packages, whole and in 2 shards, canonical
    edge frontiers of sizes 1-3 (from a port run, padded like a chunk with
    -1 rows) and each frontier's tile view in both packages."""
    jg, tg = graph_pair(lambda G: G.random_labeled(45, 110, 3, seed=11))
    res = run(tg, FSMApp(support=1, max_size=3, wants_domains=False,
                         collect_embeddings=True), RunConfig(), device="cpu")
    graphs = {"whole": (JG.to_device(jg), TG.to_device(tg, "cpu"))}
    jpg = JG.to_partitioned(jg, 2)
    tpg = TG.to_partitioned(tg, 2, device="cpu")
    frontiers, views = {}, {}
    for size, emb in res.embeddings.items():
        rows = np.asarray(emb, np.int32)[:ROWS]
        pad = PAD_TO - len(rows)
        members = np.concatenate([rows, np.full((pad, size), -1, np.int32)])
        n_valid = np.r_[np.full(len(rows), size),
                        np.zeros(pad)].astype(np.int32)
        frontiers[size] = (members, n_valid)
        views[size] = (
            jtile_view(jpg, jnp.asarray(members), jnp.asarray(n_valid),
                       "edge"),
            texplore.build_tile_view(tpg, _t(members), _t(n_valid), "edge"),
        )
    assert sorted(frontiers) == [1, 2, 3]
    return jg, graphs, (jpg, tpg), frontiers, views


def _graph_for(setting, layout, size):
    _, graphs, _, _, views = setting
    return graphs["whole"] if layout == "whole" else views[size]


def _frontier(setting, size):
    members, n_valid = setting[3][size]
    return (jnp.asarray(members), jnp.asarray(n_valid)), (_t(members),
                                                          _t(n_valid))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_check_matches_reference(setting, layout):
    """Alg. 2 for edges on every frontier row against random candidate
    edges (pads included), and the kernel dispatch's edge mode, which
    routes to the same plain check."""
    jg = setting[0]
    rng = np.random.default_rng(3)
    for size in (1, 3):
        jgr, tgr = _graph_for(setting, layout, size)
        (jm, jn), (tm, tn) = _frontier(setting, size)
        cand = rng.integers(-1, jg.m, size=jm.shape[0]).astype(np.int32)
        want = jedge_check(jgr, jm, jn, jnp.asarray(cand))
        got = tcanonical.edge_check(tgr, tm, tn, _t(cand))
        assert_same_arrays((got,), (want,))
        assert_same_arrays(
            (tcc_ops.canonical_check(tgr, tm, tn, _t(cand), mode="edge"),),
            (want,))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expand_edge_matches_reference(setting, layout):
    """Candidate slots, first-slot dedup, membership and canonicality:
    the flat ``Expansion`` of every frontier size, by the plain route and
    the kernel route."""
    for size in (1, 3):
        jgr, tgr = _graph_for(setting, layout, size)
        (jm, jn), (tm, tn) = _frontier(setting, size)
        want = jexpand_edge(jgr, jm, jn)
        for use_pallas in (False, True):
            got = texplore.expand_edge(tgr, tm, tn, use_pallas=use_pallas)
            assert_same_arrays(tuple(got), want)
            assert int(got.n_canonical) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expand_and_compact_edge_matches_reference(setting, layout):
    """The edge arm of ``expand_and_compact``, on the graph itself (the
    partitioned one builds its tile view inside), with an output capacity
    below and above the kept count."""
    _, graphs, (jpg, tpg), _, _ = setting
    jgr, tgr = graphs["whole"] if layout == "whole" else (jpg, tpg)
    for size, out_cap in ((2, 4096), (3, 16)):
        (jm, jn), (tm, tn) = _frontier(setting, size)
        want = jexplore.expand_and_compact(jgr, jm, jn, "edge", out_cap)
        for knobs in ({}, dict(use_pallas=True, compact_kernel=True)):
            got = texplore.expand_and_compact(tgr, tm, tn, "edge", out_cap,
                                              **knobs)
            assert_same_arrays(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_quick_pattern_edge_matches_reference(setting, layout):
    """Codes, local-vertex tables and vertex counts of edge embeddings of
    every size, pads and partial rows included."""
    rng = np.random.default_rng(5)
    for size in (2, 3):
        jgr, tgr = _graph_for(setting, layout, size)
        members, n_valid = setting[3][size]
        # some rows see only a prefix of their edges
        n_valid = np.minimum(n_valid, rng.integers(0, size + 1,
                                                   size=len(n_valid)))
        n_valid = n_valid.astype(np.int32)
        got = tpattern.quick_pattern_edge(tgr, _t(members), _t(n_valid))
        want = jquick_edge(jgr, jnp.asarray(members), jnp.asarray(n_valid))
        assert_same_arrays(tuple(got), want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_chunk_step_edge_matches_reference(setting, layout):
    """One chunk program of FSM: with the children's codes and the
    local-vertex table the domains read, and with the binned level-1
    partial (``agg_qcap`` below the distinct count: unclamped)."""
    _, graphs, (jpg, tpg), _, _ = setting
    jgr, tgr = graphs["whole"] if layout == "whole" else (jpg, tpg)
    japp, tapp = JFSM(support=2, max_size=4), FSMApp(support=2, max_size=4)
    (jm, jn), (tm, tn) = _frontier(setting, 2)
    for flags in (dict(with_patterns=True, with_local_verts=True),
                  dict(with_aggregates=True, agg_qcap=4)):
        fn = jprograms.make_expand_fn(japp, "edge", **flags)
        want = fn(jgr, jm, jn, out_cap=1024)
        got = texplore.fused_chunk_step(
            tgr, tm, tn, 1024, mode="edge", app=tapp, use_pallas=True,
            compact_kernel=True, aggregate_kernel=True, **flags)
        assert_same_arrays(got, want)
    assert got[3].dtype == torch.int32 and int(got[4]) > 4


def test_edge_tile_view_matches_reference(setting):
    """``build_tile_view`` in edge mode: the halo of member-edge endpoints,
    the gathered neighbour and incident-edge rows (kernel and plain
    routes), and an adjacency tile edge mode never reads."""
    _, _, (jpg, tpg), frontiers, _ = setting
    for size in (1, 3):
        members, n_valid = frontiers[size]
        jview = jtile_view(jpg, jnp.asarray(members), jnp.asarray(n_valid),
                           "edge")
        want = [np.asarray(a) for a in jview]
        want[-1] = want[-1].view(np.int32)
        for knobs in (dict(use_pallas=True, compact_kernel=True), {}):
            tview = texplore.build_tile_view(tpg, _t(members), _t(n_valid),
                                             "edge", **knobs)
            assert_same_arrays(tuple(tview), want)
        assert tview.nbr_eid_t.shape == tview.nbr_t.shape
        assert texplore.halo_cap(members.shape, "edge", jpg.n) == \
            jexplore.halo_cap(members.shape, "edge", jpg.n)


def test_edge_halo_vertices_match_reference(setting):
    """The flat halo of an edge chunk: both endpoints of every valid
    member edge, -1 elsewhere, on the whole graph and the partitioned
    one."""
    _, graphs, (jpg, tpg), frontiers, _ = setting
    rng = np.random.default_rng(9)
    for size in (1, 3):
        members, n_valid = frontiers[size]
        n_valid = rng.integers(0, size + 1, size=len(n_valid)).astype(np.int32)
        for jgr, tgr in (graphs["whole"], (jpg, tpg)):
            want = jhalo(jgr, jnp.asarray(members), jnp.asarray(n_valid),
                         "edge")
            got = texplore.halo_vertices(tgr, _t(members), _t(n_valid),
                                         "edge")
            assert_same_arrays((got,), (want,))


def test_canonical_orders_match_reference(setting):
    """The host reference orders: edge sets and vertex sets of a seeded
    sample (connected and disconnected), and ``count_bits``."""
    jg = setting[0]
    rng = np.random.default_rng(2)
    adj = {(int(u), int(v)) for u, v in jg.edges}
    adj |= {(v, u) for u, v in adj}

    def query(u, v):
        return (u, v) in adj

    for k in (1, 2, 3, 4):
        for _ in range(40):
            es = rng.choice(jg.m, size=k, replace=False)
            assert tcanonical.canonical_order_edges(jg.edges, es) == \
                jcanonical.canonical_order_edges(jg.edges, es)
            vs = rng.choice(jg.n, size=k, replace=False)
            assert tcanonical.canonical_order_vertices(query, vs) == \
                jcanonical.canonical_order_vertices(query, vs)
    words = rng.integers(0, 2**32, size=(17, 5), dtype=np.uint64).astype(
        np.uint32)
    for axis in (0, -1):
        assert_same_arrays(
            (tbitset.count_bits(_t(words.view(np.int32)), axis),),
            (jbitset.count_bits(jnp.asarray(words), axis),))
    # every permutation of a path's edges orders to the same canonical order
    path = [0, 1, 2]
    uv = np.array([[0, 1], [1, 2], [2, 3]])
    for perm in itertools.permutations(path):
        assert tcanonical.canonical_order_edges(uv, perm) == path


def test_jax_run_swaps_match_eager(setting):
    """``torch_parity.jax_run``'s swaps give the integers of the eager
    functions they stand for: the wave quick patterns in vertex and edge
    mode, the chunk slice at every start of a wave, and the host prefix
    slices of a chunk program's outputs; and ``jax_run`` refuses a cost
    model that times the reference."""
    jg, graphs, _, frontiers, _ = setting
    jdg = graphs["whole"][0]
    rng = np.random.default_rng(4)
    verts = np.stack([rng.choice(jg.n, size=3, replace=False)
                      for _ in range(40)]).astype(np.int32)
    n_valid = rng.integers(0, 4, size=40).astype(np.int32)
    inputs = {"vertex": (verts, n_valid), "edge": frontiers[3]}
    for mode, (members, nv) in inputs.items():
        args = (jdg, mode, jnp.asarray(members), jnp.asarray(nv))
        want = jprograms.quick_patterns(*args)
        assert_same_arrays(tuple(map(_t, map(np.array,
                                              SWAPS["quick_patterns"](*args)))),
                           tuple(want))
    wave = jnp.asarray(verts[:37])
    for lo in range(0, 37, 16):
        cb = min(16, 37 - lo)
        bucket = min(16, 1 << (cb - 1).bit_length())
        got = SWAPS["device_chunk"](wave, lo, cb, bucket, 3)
        want = jprograms.device_chunk(wave, lo, cb, bucket, 3)
        assert_same_arrays(tuple(map(_t, map(np.array, got))), want)
    bufs = [jnp.asarray(rng.integers(-1, 99, size=(64,) + shape,
                                     dtype=np.int32)) for shape in
            ((3,), (2,), (8,))]
    out = (bufs[0], jnp.int32(40), bufs[1], bufs[2], 0, 0)
    p = SWAPS["rec"](types.SimpleNamespace(with_aggregates=False), out, 64)
    for key, buf in zip(("children", "codes", "lv"), bufs):
        for count in (0, 1, 40, 64):
            np.testing.assert_array_equal(p[key][:count],
                                          np.asarray(buf[:count]))
        p[key].delete()
        assert buf.is_deleted()
    with pytest.raises(ValueError, match="cost_model"):
        jax_run(jg, JFSM(support=1, max_size=1), EngineConfig())
