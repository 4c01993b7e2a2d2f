"""FSM in the port (``FSMApp``: edge-induced exploration, min-image support
from domain bitmaps, alpha pruning by support) vs the JAX package.

Units, on inputs made from one seed: the domain half of
``core/aggregation.py`` (``quick_slot_ids``, ``domain_bitmaps``,
``min_image_support``, ``map_to_canonical_positions``, the level-2 device
tables and ``scatter_canon_bitmaps``), the orbit memo of
``core/pattern.py`` and the canonical refine's orbit pass
(``refine_codes(with_orbits=True)``) on FSM canonical codes. Whole runs:
``run`` against the JAX package's ``run`` (``torch_parity.jax_run``) on
the graphs and apps of its FSM tests, the pipeline's five configs spread
over them (the 4-edge runs also under the default config), with
``assert_same_run`` (patterns, supports, every ``StepStats`` counter,
chunk signatures, embeddings, step aggregates). Tolerance 0 everywhere. The JAX side pins
``cost_model="off"`` (its jnp routes); the port runs on the CPU with the
kernel knobs on, so every kernel wrapper takes its plain version. Each JAX
reference run is computed once for the module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig, aggregation as jagg
from repro.core import pattern as jpattern
from repro.core.apps import FSMApp as JFSM
from repro.kernels import canonical_refine as jrefine
from repro_torch.core import RunConfig, aggregation as tagg
from repro_torch.core import canon_math, graph as TG, pattern as tpattern
from repro_torch.core import run
from repro_torch.core.apps import FSMApp
from repro_torch.kernels import canonical_refine as trefine
from torch_parity import KERNELS_ON, assert_same_arrays, assert_same_run
from torch_parity import graph_pair, jax_run

#: small chunks, capacities and ``agg_qcap``: each step spans several
#: chunks and capacity retries
PIPELINE = dict(chunk_size=32, initial_capacity=16, agg_qcap=8)

GRAPHS = {
    "rl40s3": lambda G: G.random_labeled(40, 90, n_labels=2, seed=3),
    "rl40s5": lambda G: G.random_labeled(40, 90, n_labels=2, seed=5),
    "cite08": lambda G: G.citeseer_like(0.08),
    "rl30s5": lambda G: G.random_labeled(30, 60, n_labels=2, seed=5),
    "fig2": lambda G: G.paper_figure2(),
}
EMBEDDINGS = dict(support=1, max_size=4, collect_embeddings=True)
#: The module keeps to 14 cases, as ``test_torch_edge.py`` does: under
#: ``--dist loadfile`` the files with more cases start first, and one that
#: starts before ``test_store.py``, the suite's longest file, delays the
#: suite's end.
#: (graph, FSMApp fields of each run, config knobs) of each whole-run case:
#: the graphs and apps of the JAX package's FSM tests, the pipeline's
#: configs spread over them (4 edges, where the device level 2 refines
#: nv 5 and runs its orbit pass there, under the default config and on the
#: device)
RUNS = {
    "rl40s3_sync_chunks": ("rl40s3", [dict(support=3, max_size=3)],
                           dict(async_chunks=False)),
    "rl40s5_size4": ("rl40s5", [dict(support=2, max_size=4)], dict()),
    "rl40s5_size4_device_level2": ("rl40s5", [dict(support=2, max_size=4)],
                                   dict(canonical_placement="device")),
    "cite08_s2_partitioned": ("cite08", [dict(support=2, max_size=3)],
                              dict(graph_partition=2)),
    "cite08_s6_radix_bin": ("cite08", [dict(support=6, max_size=3)],
                            dict(aggregate_bin="radix")),
    "rl30s5_embeddings": ("rl30s5", [EMBEDDINGS], dict()),
    "rl30s5_embeddings_host_level1": ("rl30s5", [EMBEDDINGS],
                                      dict(device_aggregate=False)),
    # paper Fig. 2 with domains, then with counts
    "figure2": ("fig2", [dict(support=1, max_size=1),
                         dict(support=1, max_size=1, wants_domains=False)],
                dict()),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's runs, one list per case, computed once and
    shared."""
    cache = {}

    def get(case):
        if case not in cache:
            graph, apps, knobs = RUNS[case]
            jg, tg = graph_pair(GRAPHS[graph])
            cfg = EngineConfig(cost_model="off", **PIPELINE, **knobs)
            cache[case] = ([jax_run(jg, JFSM(**f), cfg) for f in apps], tg)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(RUNS))
def test_fsm_runs_match_reference(reference, case):
    _, apps, knobs = RUNS[case]
    jres, tg = reference(case)
    cfg = RunConfig(**KERNELS_ON, **PIPELINE, **knobs)
    tres = [run(tg, FSMApp(**f), cfg, device="cpu") for f in apps]
    for j, t in zip(jres, tres):
        assert_same_run(j, t)
        assert t.patterns
    if case.endswith("device_level2"):
        assert tres[0].stats.cost_model["canonical_placement"] == "device"
        # a frequent 4-edge pattern of 5 vertices went through the refine
        assert any(c[0] & 0xF == 5 for c in tres[0].patterns)
    if case.startswith("rl30s5_embeddings"):
        assert sorted(tres[0].embeddings) == [1, 2, 3, 4]
    if case == "figure2":
        # paper Fig. 2: the three edges of the path share one pattern whose
        # min-image support is 2; without domains the value is the count
        assert [list(t.patterns.values()) for t in tres] == [[2], [3]]


@pytest.fixture(scope="module")
def level1():
    """One FSM step's level-1 state from a port run over a labeled graph:
    the step-3 frontier's quick codes and local-vertex tables (in the
    port; the units compare both packages on these inputs), the distinct
    codes and the per-row quick slots."""
    _, tg = graph_pair(lambda G: G.random_labeled(30, 70, n_labels=3,
                                                  seed=4))
    res = run(tg, FSMApp(support=1, max_size=3, collect_embeddings=True),
              RunConfig(), device="cpu")
    dg = TG.to_device(tg, "cpu")
    emb = torch.from_numpy(np.asarray(res.embeddings[3], np.int32))
    qp = tpattern.quick_pattern_edge(dg, emb, torch.full(
        (emb.shape[0],), 3, dtype=torch.int32))
    codes, lv = qp.codes.numpy(), qp.local_verts.numpy()
    uniq, inv = tagg.quick_slot_ids(codes, np.ones(len(codes), bool))
    canon = np.concatenate([a.canon_codes for a in res.aggregates])
    return tg.n, codes, lv, uniq, inv, canon


def test_quick_slots_and_pattern_table_match_reference(level1):
    """``quick_slot_ids`` (invalid rows at -1), and the level-2 table with
    orbits built by both packages from a cold memo: canonical codes,
    slots, sigma, orbits; then the memo sizes."""
    _, codes, _, uniq, inv, _ = level1
    valid = np.random.default_rng(1).random(len(codes)) < 0.8
    assert_same_arrays(tuple(map(_t, tagg.quick_slot_ids(codes, valid))),
                       jagg.quick_slot_ids(jnp.asarray(codes),
                                           jnp.asarray(valid)))
    assert_same_arrays((_t(uniq), _t(inv)),
                       jagg.quick_slot_ids(codes, np.ones(len(codes), bool)))
    for with_orbits in (True, False):
        jpattern.clear_memo()
        tpattern.clear_memo()
        want = jpattern.build_pattern_table(uniq, with_orbits=with_orbits)
        got = tpattern.build_pattern_table(uniq, with_orbits=with_orbits)
        assert_same_arrays(tuple(map(_t, got[:-1])), want[:-1])
        assert got.n_iso_checks == want.n_iso_checks
        assert tpattern.memo_sizes() == jpattern.memo_sizes()
    assert tpattern.memo_sizes()[1] == 0


def test_domain_bitmaps_match_reference(level1):
    """The level-1 domain scatter: rows, positions and slots out of range
    (negative) land in the dump slot, never in the result."""
    n = level1[0]
    rng = np.random.default_rng(7)
    b, pc = 300, 9
    slot = rng.integers(-1, pc, size=b).astype(np.int32)
    verts = rng.integers(-1, n, size=(b, 8)).astype(np.int32)
    valid = rng.random(b) < 0.7
    want = jagg.domain_bitmaps(jnp.asarray(slot), jnp.asarray(verts),
                               jnp.asarray(valid), pc, n)
    got = tagg.domain_bitmaps(_t(slot), _t(verts), _t(valid), pc, n)
    assert_same_arrays((got,), (want,))
    assert got.any() and not got.all()


def test_min_image_support_matches_reference(level1):
    """Support as the least orbit-merged domain over each pattern's
    positions, on seeded bitmaps of the step's canonical codes."""
    n, canon = level1[0], level1[5]
    rng = np.random.default_rng(8)
    bm = rng.random((len(canon), 8, n)) < 0.1
    nv = (canon[:, 0] & 0xF).astype(np.int32)
    orbits = np.stack([canon_math.automorphism_orbits(c) for c in canon])
    assert (orbits != np.arange(8)).any()     # some pattern has automorphisms
    got = tagg.min_image_support(_t(bm), nv, orbits)
    np.testing.assert_array_equal(got, jagg.min_image_support(bm, nv, orbits))
    np.testing.assert_array_equal(
        tagg.min_image_support(np.zeros((0, 8, n), bool), nv[:0], orbits[:0]),
        np.zeros((0,), np.int64))


def test_canonical_positions_and_domain_scatter_match_reference(level1):
    """The host mapping of every row to canonical positions, the uploaded
    level-2 tables, and the device scatter of two batches into one flat
    accumulator (its dump slot included) against the reference's."""
    n, codes, lv, uniq, inv, _ = level1
    jtable = jpattern.build_pattern_table(uniq)
    ttable = tpattern.build_pattern_table(uniq)
    slot = inv.astype(np.int32).copy()
    slot[::7] = -1
    got = tagg.map_to_canonical_positions(ttable, slot, lv)
    want = jagg.map_to_canonical_positions(jtable, slot, jnp.asarray(lv))
    assert_same_arrays((_t(got[0]), got[1]), want)
    cap = 1 << (len(uniq) - 1).bit_length()
    tq2c, tsi = tagg.level2_device_tables(ttable, cap, "cpu")
    jq2c, jsi = jagg.level2_device_tables(jtable, cap)
    assert_same_arrays((tq2c, tsi), (jq2c, jsi))
    pc = len(ttable.canon_codes)
    pc_cap = 1 << (pc - 1).bit_length()
    size = pc_cap * 8 * n + 1
    tflat = torch.zeros((size,), dtype=torch.bool)
    jflat = jnp.zeros((size,), dtype=bool)
    half = len(slot) // 2
    for lo, hi in ((0, half), (half, len(slot))):
        tflat = tagg.scatter_canon_bitmaps(tflat, _t(slot[lo:hi]),
                                           _t(lv[lo:hi]), tq2c, tsi,
                                           pc_cap, n)
        jflat = jagg.scatter_canon_bitmaps(jflat, jnp.asarray(slot[lo:hi]),
                                           jnp.asarray(lv[lo:hi]), jq2c, jsi,
                                           pc_cap, n)
    assert_same_arrays((tflat,), (jflat,))
    # the flat bitmap is the host scatter of the mapped rows
    bm = tflat[:-1].reshape(pc_cap, 8, n)[:pc]
    vc = got[1].numpy()
    ok = (vc >= 0) & (got[0][:, None] >= 0)
    rows, pos = np.nonzero(ok)
    host = np.zeros((pc, 8, n), bool)
    host[got[0][rows], pos, vc[rows, pos]] = True
    np.testing.assert_array_equal(bm.numpy(), host)


def test_refine_orbits_on_fsm_codes_match_reference(level1):
    """The orbit pass of device level 2 on the canonical codes of every
    FSM step (nv 2-4): the port's kernel route and plain route against the
    JAX refine and the host ``automorphism_orbits``, and its canonical
    codes unchanged."""
    canon = level1[5]
    nvs = (2, 3, 4)
    valid = np.ones(len(canon), bool)
    valid[-1] = False
    refine = jax.jit(lambda c, v: jrefine.refine_codes(c, v, nvs,
                                                       with_orbits=True))
    want = refine(jnp.asarray(canon), jnp.asarray(valid))
    host = np.stack([canon_math.automorphism_orbits(c) for c in canon])
    for use_kernel in (True, False):
        got = trefine.refine_codes(_t(canon), _t(valid), nvs,
                                   with_orbits=True, use_kernel=use_kernel)
        assert_same_arrays(got, want)
        np.testing.assert_array_equal(got[2].numpy()[valid], host[valid])
        np.testing.assert_array_equal(got[0].numpy(), canon)


def test_seeded_orbits_and_networkx_match_reference(level1):
    """``seed_memo`` with canonical codes and orbits fills the orbit memo
    that a later host table reads; ``pattern_to_networkx`` builds the same
    labelled graph in both packages."""
    canon = level1[5]
    orbits = np.stack([canon_math.automorphism_orbits(c) for c in canon])
    tpattern.clear_memo()
    tpattern.seed_memo(np.zeros((0, 3), np.int64), np.zeros((0, 3), np.int64),
                       np.zeros((0, 8), np.int32), canon_codes=canon,
                       orbits=orbits)
    assert tpattern.memo_sizes() == (0, len(canon))
    for code in canon[:20]:
        tg, jg = tpattern.pattern_to_networkx(code), \
            jpattern.pattern_to_networkx(code)
        assert sorted(tg.nodes(data=True)) == sorted(jg.nodes(data=True))
        assert sorted(tg.edges) == sorted(jg.edges)
    tpattern.clear_memo()
