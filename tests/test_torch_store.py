"""The port's frontier stores (``repro_torch.core.store``, DESIGN.md §7) vs
the JAX package's: the raw, spill and ODAG store units (mirroring
``tests/test_store.py``; the dense exchange's merge is in
``test_torch_shard.py``), and
whole runs under ``store="odag"`` and under a ``device_budget_bytes``
below the peak frontier, for motifs, cliques and FSM, held to the JAX
package's runs under the same config with ``assert_same_run`` (patterns,
every ``StepStats`` counter with ``odag_bytes``, chunk signatures,
embeddings, step aggregates; tolerance 0). Also the edge quick patterns
over row slices against the unsliced and the JAX package's.

The JAX side pins ``cost_model="off"`` and runs through
``torch_parity.jax_run`` (its ODAG extraction under ``host_extract``); the
port runs on the CPU with the kernel knobs on, so every kernel wrapper
takes its plain version."""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig
from repro.core import to_device as jto_device
from repro.core.apps import CliquesApp as JCliques, FSMApp as JFSM
from repro.core.apps import MotifsApp as JMotifs
from repro.core.store import ODAGStore as JODAGStore
from repro_torch.core import RunConfig, graph as TG, pattern as tpattern, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.store import ODAGStore, RawStore, SpillStore, make_store
from torch_parity import KERNELS_ON, assert_same_run, graph_pair
from torch_parity import SWAPS, host_extract, jax_run

CFG = dict(chunk_size=2048, initial_capacity=2048)
GRAPH = lambda G: G.random_labeled(40, 90, n_labels=3, seed=1)  # noqa: E731


# ---------------------------------------------------------------------------
# unit behaviour
# ---------------------------------------------------------------------------

def test_raw_store_roundtrip_and_waves():
    s = RawStore()
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    b = np.arange(6, 14, dtype=np.int32).reshape(4, 2)
    s.append(a)
    s.append(b, worker=1)      # worker tag is ignored by RawStore
    # a capacity-padded tensor resolves to its valid prefix at the seal
    s.append(torch.arange(16, 24, dtype=torch.int32).reshape(4, 2), count=2)
    s.seal(2)
    want = np.concatenate([a, b, np.arange(16, 20).reshape(2, 2)])
    assert s.n_rows == 9 and s.size == 2
    assert s.raw_bytes == s.stored_bytes == s.exchange_bytes == 9 * 2 * 4
    assert s.materialize().dtype == np.int32
    np.testing.assert_array_equal(s.materialize(), want)
    waves = list(s.chunks(max_rows=4))
    assert [len(w) for w in waves] == [4, 4, 1]
    np.testing.assert_array_equal(np.concatenate(waves), want)
    parts = s.worker_parts(3)
    np.testing.assert_array_equal(np.concatenate(parts), want)
    sd = s.state_dict()
    restored = RawStore()
    restored.from_state_dict(sd)
    np.testing.assert_array_equal(restored.materialize(), want)
    with pytest.raises(ValueError):
        restored.from_state_dict(dict(sd, kind="odag"))
    # re-seal with nothing staged -> empty frontier of the new width
    s.seal(3)
    assert s.n_rows == 0 and list(s.chunks()) == []


def test_spill_store_bounds_wave_rows():
    inner = RawStore()
    inner.append(np.arange(20, dtype=np.int32).reshape(10, 2))
    inner.seal(2)
    s = SpillStore(inner, device_budget_bytes=3 * 2 * 4)   # 3 rows of width 2
    assert s.budget_rows() == 3 and s.kind == "raw" and s.inner is inner
    waves = list(s.chunks())
    assert [len(w) for w in waves] == [3, 3, 3, 1]
    np.testing.assert_array_equal(np.concatenate(waves), inner.materialize())
    assert [len(w) for w in s.chunks(max_rows=2)] == [2] * 5
    assert s.state_dict()["kind"] == "raw"
    with pytest.raises(ValueError):
        SpillStore(RawStore(), 0)


def test_odag_store_matches_reference():
    """Seal, whole and budgeted extraction, worker parts and byte stats of
    the port's ODAG store equal the JAX package's, rows in order."""
    jg, tg = graph_pair(lambda G: G.random_labeled(40, 90, n_labels=1,
                                                   seed=2))
    emb = run(tg, MotifsApp(max_size=3, collect_embeddings=True),
              RunConfig(**CFG), device="cpu").embeddings[3]
    ts, js = ODAGStore(TG.to_device(tg, "cpu")), JODAGStore(jto_device(jg))
    half = len(emb) // 2
    for s in (ts, js):
        s.append(emb[:half])
        s.append(emb[half:])
        s.seal(3)
    assert ts.n_rows == js.n_rows == len(emb)
    assert ts.stored_bytes == js.stored_bytes < ts.raw_bytes
    assert ts.exchange_bytes == js.exchange_bytes
    budget = max(len(emb) // 3, 1)
    with host_extract():
        want = js.materialize()
        jwaves = list(js.chunks(max_rows=budget))
        jparts = js.worker_parts(4)
    np.testing.assert_array_equal(ts.materialize(), want)
    assert set(map(tuple, want.tolist())) == set(map(tuple, emb.tolist()))
    waves = list(ts.chunks(max_rows=budget))
    assert len(waves) == len(jwaves) > 1
    assert max(len(w) for w in waves) <= budget
    for a, b in zip(waves, jwaves):
        np.testing.assert_array_equal(a, b)
    parts = ts.worker_parts(4)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    # one host sync a level and chunk, and one copy an extraction (of two
    # levels)
    st = ts.extract_stats
    assert st["host_syncs"] == st["chunks"] + st["levels"] // 2


def test_make_store_kinds():
    g = TG.to_device(TG.triangle_plus_tail(), "cpu")
    assert isinstance(make_store("raw"), RawStore)
    assert isinstance(make_store("odag", g), ODAGStore)
    spilled = make_store("raw", device_budget_bytes=1024)
    assert isinstance(spilled, SpillStore) and spilled.kind == "raw"
    assert make_store("odag", g, device_budget_bytes=64).kind == "odag"
    for kind in ("mmap", "spill"):
        with pytest.raises(ValueError):
            make_store(kind)
    with pytest.raises(ValueError):
        make_store("odag")      # needs the device graph
    dense = make_store("odag", g, dense_exchange=True)
    assert isinstance(dense, ODAGStore) and dense._dense_exchange


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

APPS = {
    "motifs": (lambda A: A(max_size=3, collect_embeddings=True),
               MotifsApp, JMotifs),
    "cliques": (lambda A: A(max_size=4), CliquesApp, JCliques),
    "fsm": (lambda A: A(support=3, max_size=3, collect_embeddings=True),
            FSMApp, JFSM),
}


def _runs(name, **knobs):
    mk, tapp, japp = APPS[name]
    jg, tg = graph_pair(GRAPH)
    jres = jax_run(jg, mk(japp), EngineConfig(cost_model="off", **CFG,
                                              **knobs))
    tres = run(tg, mk(tapp), RunConfig(**KERNELS_ON, **CFG, **knobs),
               device="cpu")
    assert_same_run(jres, tres)
    return jres, tres


@pytest.mark.parametrize("name", list(APPS))
def test_odag_run_matches_reference(name):
    _, tres = _runs(name, store="odag")
    # the compressed representation is what lived between supersteps
    assert any(s.odag_bytes > 0 for s in tres.stats.steps if s.size >= 3)


def _peak_bytes():
    _, tg = graph_pair(GRAPH)
    base = run(tg, MotifsApp(max_size=3), RunConfig(**CFG), device="cpu")
    return max(s.frontier_bytes for s in base.stats.steps)


@pytest.mark.parametrize("store", ["raw", "odag"])
def test_spill_budget_below_peak_matches_reference(store):
    """A device budget of a ninth of the peak frontier: the size-2
    frontier expands in two waves (more than the pilot and one drain a
    step) and the size-3 one aggregates in nine."""
    budget = _peak_bytes() // 9
    _, tres = _runs("motifs", store=store, device_budget_bytes=budget)
    assert max(s.n_host_syncs for s in tres.stats.steps) > 2
    assert tres.stats.steps[-1].frontier_bytes > 8 * budget


def test_fsm_spill_matches_reference():
    """FSM under the ODAG store and a budget that splits the size-3
    frontier in three waves: extraction by cost partitions, alpha pruning
    and the domain scatter over wave batches."""
    _, tres = _runs("fsm", store="odag", device_budget_bytes=24576)
    assert tres.stats.steps[-1].frontier_bytes > 2 * 24576


def test_quick_pattern_edge_slices_match_reference():
    """The edge quick patterns over forced small slices equal the unsliced
    call and the JAX package's, on seeded rows of 4 edge ids with padding
    (rows of 0 to 4 valid edges)."""
    jg, tg = graph_pair(GRAPH)
    rng = np.random.default_rng(0)
    b = 3000
    nv = rng.integers(0, 5, size=b).astype(np.int32)
    mem = rng.integers(0, tg.m, size=(b, 4)).astype(np.int32)
    mem = np.where(np.arange(4)[None, :] < nv[:, None], mem, -1)
    tdg = TG.to_device(tg, "cpu")
    tm, tn = torch.from_numpy(mem), torch.from_numpy(nv)
    whole = tpattern.quick_pattern_edge(tdg, tm, tn)
    # the JAX package's quick patterns as one program (``jax_run``'s swap)
    want = SWAPS["quick_patterns"](jto_device(jg), "edge", mem, nv)
    assert tpattern.quick_edge_slice_rows(4) > b
    for slice_rows in (1, 97, b - 1):
        part = tpattern.quick_pattern_edge(tdg, tm, tn, slice_rows=slice_rows)
        for a, w, c in zip(part, whole, want):
            assert a.dtype == w.dtype
            assert torch.equal(a, w)
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_domain_scatter_slices_match_one_scatter(monkeypatch):
    """The FSM domain scatter over row slices sets the bits one scatter
    sets (its parity with the JAX package: ``test_torch_fsm.py``)."""
    from repro_torch.core import aggregation as tagg
    rng = np.random.default_rng(1)
    b, n, q, pc_cap = 1000, 50, 12, 8
    slot = torch.from_numpy(rng.integers(-1, q, b).astype(np.int32))
    lv = torch.from_numpy(rng.integers(-1, n, (b, 8)).astype(np.int32))
    q2c = torch.from_numpy(rng.integers(-1, pc_cap, q).astype(np.int32))
    sigma_inv = torch.from_numpy(
        np.stack([rng.permutation(8) for _ in range(q)]).astype(np.int32))
    size = pc_cap * 8 * n + 1
    one = tagg.scatter_canon_bitmaps(torch.zeros(size, dtype=torch.bool),
                                     slot, lv, q2c, sigma_inv, pc_cap, n)
    monkeypatch.setattr(tagg, "SCATTER_SLICE_ROWS", 7)
    sliced = tagg.scatter_canon_bitmaps(torch.zeros(size, dtype=torch.bool),
                                        slot, lv, q2c, sigma_inv, pc_cap, n)
    assert one[:-1].any() and torch.equal(sliced, one)
