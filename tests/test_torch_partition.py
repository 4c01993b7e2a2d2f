"""The port's partitioned graph layout (``PartitionedGraph``, the halo tile
view, ``kernels/gather.py``, ``canonical_check_tiles``) vs the JAX
package's, on graphs and inputs made from one seed with numpy. Outputs are
integers and booleans: tolerance 0. The JAX side runs its Pallas kernels in
interpret mode where one is compared; the port runs its kernel routes,
whose plain versions take CPU tensors, and its plain routes. Whole runs
under ``graph_partition=4`` are in ``test_torch_partition_runs.py``, the
shard bounds in ``test_torch_partition_bounds.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import explore as jexplore, graph as JG
from repro.kernels import gather as jgather
from repro.kernels.canonical_check import ops as jcc_ops
from repro.kernels.canonical_check.canonical_check import (
    canonical_check_tiles_pallas,
)
from repro_torch.core import RunConfig, explore as texplore, graph as TG, run
from repro_torch.core.apps import MotifsApp
from repro_torch.kernels import gather as tgather
from repro_torch.kernels.canonical_check import ops as tcc_ops
from torch_parity import assert_same_arrays, graph_pair


def _graphs():
    return [
        graph_pair(lambda G: G.random_labeled(60, 150, 3, seed=0)),
        graph_pair(lambda G: G.random_labeled(40, 220, 3, seed=2)),
        graph_pair(lambda G: G.random_labeled(7, 9, 2, seed=5)),
        graph_pair(lambda G: G.complete(5)),
    ]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_partitioned_tables_match_reference(w):
    """Every table of ``to_partitioned`` (from a host graph and from a
    ``DeviceGraph``), and the same tables carried across with
    ``partitioned_graph_from_numpy``."""
    for jg, tg in _graphs():
        jpg = JG.to_partitioned(jg, w)
        want = [np.asarray(a) for a in jpg]
        want[-1] = want[-1].view(np.int32)        # adj_sh: uint32 bits
        for tpg in (
            TG.to_partitioned(tg, w, device="cpu"),
            TG.to_partitioned(TG.to_device(tg, "cpu"), w),
            TG.partitioned_graph_from_numpy(
                JG.PartitionedGraph(*[np.asarray(a) for a in jpg]), "cpu"),
        ):
            assert isinstance(tpg, TG.PartitionedGraph)
            assert all(t.dtype == torch.int32 for t in tpg)
            assert_same_arrays(tuple(tpg), want)
            assert (tpg.n, tpg.m, tpg.n_parts, tpg.tile_rows,
                    tpg.max_degree) == (jpg.n, jpg.m, jpg.n_parts,
                                        jpg.tile_rows, jpg.max_degree)
            assert (tpg.per_device_adjacency_bytes
                    == jpg.per_device_adjacency_bytes)
            assert tpg.replicated_bytes == jpg.replicated_bytes
            assert tpg.device == torch.device("cpu")
        assert TG.replicated_adjacency_bytes(TG.to_device(tg, "cpu")) == (
            JG.replicated_adjacency_bytes(JG.to_device(jg)))


def test_partitioned_lookups_match_reference():
    """``owner``, ``flat_index``, ``nbr_rows`` and ``is_edge`` on ids in
    [-1, n) — the ids the engine asks about."""
    rng = np.random.default_rng(7)
    for jg, tg in _graphs():
        jpg = JG.to_partitioned(jg, 4)
        tpg = TG.to_partitioned(tg, 4, device="cpu")
        u = rng.integers(-1, jg.n, size=400).astype(np.int32)
        v = rng.integers(-1, jg.n, size=400).astype(np.int32)
        ju, jv = jnp.asarray(u), jnp.asarray(v)
        tu, tv = _t(u), _t(v)
        assert_same_arrays(
            (tpg.owner(tu), *tpg.flat_index(tu), tpg.nbr_rows(tu),
             tpg.is_edge(tu, tv)),
            (jpg.owner(ju), *jpg.flat_index(ju), jpg.nbr_rows(ju),
             jpg.is_edge(ju, jv)),
        )
        # the total view agrees with the whole-graph layout
        tdg = TG.to_device(tg, "cpu")
        assert torch.equal(tpg.is_edge(tu, tv), tdg.is_edge(tu, tv))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("cap", [64, 16], ids=["fits", "overflow"])
def test_halo_unique_matches_reference(use_kernel, cap):
    """Ascending distinct ids padded with the sentinel n; ``count`` is the
    unclamped distinct total, also when it exceeds ``cap``."""
    n = 50
    verts = np.random.default_rng(3).integers(-3, n + 3, size=200)
    verts = verts.astype(np.int32)
    want = jgather.halo_unique(jnp.asarray(verts), n, cap)
    got = tgather.halo_unique(_t(verts), n, cap, use_kernel=use_kernel)
    assert_same_arrays(got, want)
    assert int(got[1]) == len(np.unique(verts[(verts >= 0) & (verts < n)]))
    if cap == 16:
        assert int(got[1]) > cap


@pytest.mark.parametrize("fill", [-1, 0])
def test_gather_rows_matches_reference_kernel(fill):
    """The port's kernel route (its plain version on the CPU) against the
    JAX package's Pallas gather in interpret mode: rows of -1, N and past
    it give ``fill`` rows."""
    rng = np.random.default_rng(5)
    table = rng.integers(-5, 100, size=(30, 7)).astype(np.int32)
    rows = rng.integers(-2, 33, size=50).astype(np.int32)
    rows[:3] = [-1, 30, 29]
    want = jgather.gather_rows(jnp.asarray(table), jnp.asarray(rows),
                               jnp.int32(fill), use_kernel=True,
                               interpret=True)
    for use_kernel in (True, False):
        got = tgather.gather_rows(_t(table), _t(rows), fill,
                                  use_kernel=use_kernel)
        assert_same_arrays((got,), (want,))
    assert (np.asarray(want)[:2] == fill).all()


def test_canonical_check_tiles_matches_reference_kernel():
    """The port's tile check (kernel route and plain route) against the
    JAX package's ``canonical_check_tiles_pallas`` in interpret mode and
    its jnp route, on a small random tile with members of -1, ranks of -1
    and past the tile, and batches that are no block multiple."""
    rng = np.random.default_rng(9)
    u_rows, words, n = 37, 3, 90
    adj = rng.integers(0, 2**32, size=(u_rows, words), dtype=np.uint64)
    adj = adj.astype(np.uint32)
    for b, k in ((301, 3), (129, 8)):
        n_valid = rng.integers(0, k + 1, size=b).astype(np.int32)
        members = np.full((b, k), -1, np.int32)
        for i in range(b):
            members[i, : n_valid[i]] = rng.choice(n, n_valid[i], replace=False)
        ranks = rng.integers(-1, u_rows + 2, size=(b, k)).astype(np.int32)
        cand = rng.integers(-1, n, size=b).astype(np.int32)
        args = [jnp.asarray(a) for a in (members, ranks, n_valid, cand, adj)]
        want = canonical_check_tiles_pallas(*args, block_b=128,
                                            interpret=True)
        np.testing.assert_array_equal(
            np.asarray(want), np.asarray(jcc_ops.canonical_check_tiles_ref(
                *args)))
        targs = [_t(a) for a in (members, ranks, n_valid, cand,
                                 adj.view(np.int32))]
        for use_pallas in (True, False):
            got = tcc_ops.canonical_check_tiles(*targs, use_pallas=use_pallas)
            assert_same_arrays((got,), (want,))


def test_tile_view_matches_reference():
    """``build_tile_view`` contents (through the kernel routes and the
    plain routes), and the view's ``rank`` / ``is_edge`` on ids in and out
    of the halo."""
    jg, tg = graph_pair(lambda G: G.random_labeled(60, 150, 3, seed=0))
    jpg = JG.to_partitioned(jg, 4)
    tpg = TG.to_partitioned(tg, 4, device="cpu")
    rng = np.random.default_rng(6)
    members = rng.integers(0, jg.n, size=(16, 2)).astype(np.int32)
    n_valid = rng.integers(0, 3, size=16).astype(np.int32)
    jview = jexplore.build_tile_view(jpg, jnp.asarray(members),
                                     jnp.asarray(n_valid), "vertex")
    want = [np.asarray(a) for a in jview]
    want[-1] = want[-1].view(np.int32)
    ids = rng.integers(-1, jg.n, size=(40, 3)).astype(np.int32)
    for knobs in (dict(use_pallas=True, compact_kernel=True), {}):
        tview = texplore.build_tile_view(tpg, _t(members), _t(n_valid),
                                         "vertex", **knobs)
        assert_same_arrays(tuple(tview), want)
        assert_same_arrays(
            (*tview.rank(_t(ids)), tview.is_edge(_t(ids), _t(ids[:, ::-1]))),
            (*jview.rank(jnp.asarray(ids)),
             jview.is_edge(jnp.asarray(ids), jnp.asarray(ids[:, ::-1]))),
        )
    assert texplore.halo_cap((16, 2), "vertex", jg.n) == jexplore.halo_cap(
        (16, 2), "vertex", jg.n)


def test_partitioned_entry_points_need_a_card_unless_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jg, tg = graph_pair(lambda G: G.random_labeled(20, 40, 2, seed=1))
    for call in (
        lambda: TG.to_partitioned(tg, 2),
        lambda: TG.partitioned_graph_from_numpy(
            JG.PartitionedGraph(*[np.asarray(a)
                                  for a in JG.to_partitioned(jg, 2)])),
        lambda: run(tg, MotifsApp(max_size=3), RunConfig(graph_partition=2)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    tpg = TG.to_partitioned(tg, 2, device="cpu")
    want = run(tg, MotifsApp(max_size=3), device="cpu").patterns
    assert run(tpg, MotifsApp(max_size=3)).patterns == want
    with pytest.raises(ValueError, match="device"):
        run(tpg, MotifsApp(max_size=3), device="meta")
