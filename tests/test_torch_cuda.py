"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
a CUDA device — a CUDA kernel has no CPU mode). Each kernel is held against
its plain PyTorch version on the same tensors (integers and booleans:
exact), and a whole run on the card against the same run on the CPU. This
file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import RunConfig, run
from repro_torch.core.apps import CliquesApp, MotifsApp
from repro_torch.core import canon_math
from repro_torch.kernels import aggregate, build, canonical_refine, compact
from repro_torch.kernels import gather, radix_bin
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda,
    canonical_check_ref,
    canonical_check_tiles_cuda,
    canonical_check_tiles_ref,
    expand_canonical_cuda,
    expand_canonical_ref,
)
from repro_torch.core import explore

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _members(rng, b, k, n):
    members = np.full((b, k), -1, np.int32)
    n_valid = rng.integers(0, k + 1, b).astype(np.int32)
    for i in range(b):
        members[i, : n_valid[i]] = rng.choice(n, size=n_valid[i], replace=False)
    return torch.from_numpy(members), torch.from_numpy(n_valid)


def _codes(rng, b):
    w0 = 3 | (rng.integers(0, 8, b).astype(np.int64) << 4)
    w1 = np.zeros(b, np.int64)
    w2 = np.zeros(b, np.int64)
    for i in range(4):
        w1 |= rng.integers(126, 131, b).astype(np.int64) << (8 * i)
        w2 |= rng.integers(126, 131, b).astype(np.int64) << (8 * i)
    return torch.from_numpy(np.stack([w0, w1, w2], axis=1))


def test_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    g = TG.to_device(TG.random_labeled(300, 2000, n_labels=3, seed=4), dev)
    rng = np.random.default_rng(0)
    members, n_valid = (t.to(dev) for t in _members(rng, 777, 3, g.n))
    before = dict(build.LAUNCHES)

    got = expand_canonical_cuda(members, n_valid, g.nbr, g.adj_bits)
    want = expand_canonical_ref(members, n_valid, g.nbr, g.adj_bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    cand = got[0].reshape(-1)
    rows = torch.arange(777, device=dev).repeat_interleave(3 * g.max_degree)
    assert torch.equal(
        canonical_check_cuda(members[rows], n_valid[rows], cand, g.adj_bits),
        canonical_check_ref(members[rows], n_valid[rows], cand, g.adj_bits),
    )
    # an empty batch launches nothing and still has the contract's shapes
    empty = canonical_check_cuda(members[:0], n_valid[:0], cand[:0],
                                 g.adj_bits)
    assert empty.shape == (0,)

    keep = got[2].reshape(-1)
    for cap in (1, 4096, 1 << 20):
        idx, count = compact.stream_compact_cuda(keep, cap)
        ref_idx, ref_count = compact.stream_compact_ref(keep, cap)
        assert torch.equal(idx, ref_idx) and torch.equal(count, ref_count)
    # an unaligned view takes the byte-wise flag loads
    for a, b in zip(compact.stream_compact_cuda(keep[3:], 4096),
                    compact.stream_compact_ref(keep[3:], 4096)):
        assert torch.equal(a, b)

    codes = _codes(rng, 50_000).to(dev)
    valid = torch.rand(50_000, device=dev) < 0.9
    sc, sv, _ = aggregate.sort_codes(codes, valid)
    new = sv & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          (sc[1:] != sc[:-1]).any(1)])
    for cap in (8, 1 << 16):
        for a, b in zip(aggregate.seg_unique_cuda(new, sv, cap),
                        aggregate.seg_unique_ref(new, sv, cap)):
            assert torch.equal(a, b)
    for use_kernel in (False, True):
        out = aggregate.bin_rows(codes, valid, 1 << 16, use_kernel=use_kernel)
        ref = aggregate.bin_rows(codes.cpu(), valid.cpu(), 1 << 16)
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b)
    torch.cuda.synchronize()
    for name in ("canonical_check", "expand_canonical", "stream_compact",
                 "seg_unique"):
        assert build.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("app", [MotifsApp(max_size=3), CliquesApp(max_size=4)])
@pytest.mark.parametrize("fused", [False, True])
def test_card_run_equals_cpu_run(cuda_device, app, fused):
    g = TG.mico_like(0.003)
    cfg_kw = dict(chunk_size=256, initial_capacity=64, fused_expand=fused)
    gpu = run(g, app, RunConfig(**cfg_kw), device=cuda_device)
    cpu = run(g, app, RunConfig(**cfg_kw), device="cpu")
    assert gpu.patterns == cpu.patterns
    assert gpu.stats.cost_model["use_pallas"] is True
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert (a.n_children, a.n_generated, a.n_canonical, a.n_host_syncs,
                a.n_quick_patterns, a.bytes_to_host) == (
            b.n_children, b.n_generated, b.n_canonical, b.n_host_syncs,
            b.n_quick_patterns, b.bytes_to_host)
    for size, emb in cpu.embeddings.items():
        np.testing.assert_array_equal(gpu.embeddings[size], emb)


def _refine_codes(rng, nv, n, n_labels=4):
    out = []
    for _ in range(n):
        upper = np.triu(rng.random((nv, nv)) < 0.5, 1)
        out.append(canon_math.encode(nv, upper | upper.T,
                                     rng.integers(0, n_labels, nv)))
    return np.array(out, dtype=np.int64)


def test_radix_and_refine_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(1)
    before = dict(build.LAUNCHES)
    codes = _codes(rng, 70_000).to(dev)
    codes[:, 2] = 0                   # constant word: its passes are skipped
    valid = torch.rand(70_000, device=dev) < 0.9
    for b in (0, 1, 4096, 70_000):
        got = radix_bin.radix_sort_codes(codes[:b], valid[:b])
        want = radix_bin.radix_sort_codes_ref(codes[:b], valid[:b])
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    # one varying pass, piece by piece, on a shuffled order
    order = torch.randperm(70_000, device=dev).to(torch.int32)
    vary = torch.zeros(4, dtype=torch.int32, device=dev)
    radix_bin.radix_hist_cuda(codes, valid, order, 2, 0, vary, True)
    assert torch.equal(vary, radix_bin.digit_vary_ref(codes, valid))
    hist, totals = radix_bin.radix_hist_cuda(codes, valid, order, 1, 8, vary,
                                             False)
    ref_h, ref_t = radix_bin.radix_hist_ref(codes, valid, order, 1, 8,
                                            radix_bin.RADIX_TILE)
    assert torch.equal(hist, ref_h) and torch.equal(totals, ref_t)
    out = radix_bin.radix_scatter_cuda(codes, valid, order, 1, 8, vary, hist,
                                       totals)
    assert torch.equal(out, radix_bin.radix_scatter_ref(codes, valid, order,
                                                        1, 8))
    for use_kernel in (False, True):
        got = aggregate.bin_rows(codes, valid, 1 << 12, use_kernel=use_kernel,
                                 method="radix")
        want = aggregate.bin_rows(codes.cpu(), valid.cpu(), 1 << 12)
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)

    mixed = np.concatenate([_refine_codes(rng, nv, 300 if nv < 8 else 40)
                            for nv in range(2, 9)]
                           + [np.array([[1, 5, 0], [0, 0, 0]], np.int64)])
    codes = torch.from_numpy(mixed).to(dev)
    valid = torch.rand(len(mixed), device=dev) < 0.95
    for nvs in ((3,), (2, 3, 4, 5, 6, 7, 8)):
        for orbits in (False, True):
            got = canonical_refine.refine_cuda(codes, valid, nvs,
                                               with_orbits=orbits)
            want = canonical_refine.refine_codes_ref(codes, valid, nvs,
                                                     with_orbits=orbits)
            for a, w in zip(got, want):
                assert torch.equal(a, w)
    torch.cuda.synchronize()
    for name in ("radix_hist", "radix_scatter", "canonical_refine"):
        assert build.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("placement", ["device", "host_async"])
def test_force_device_card_run_equals_cpu_run(cuda_device, placement):
    g = TG.mico_like(0.003)
    cfg = RunConfig(cost_model="force_device", canonical_placement=placement,
                    chunk_size=256, initial_capacity=64)
    gpu = run(g, MotifsApp(max_size=3), cfg, device=cuda_device)
    cpu = run(g, MotifsApp(max_size=3), cfg, device="cpu")
    assert gpu.patterns == cpu.patterns
    assert gpu.stats.cost_model["aggregate_kernel"] is True
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert (a.n_children, a.n_quick_patterns, a.n_canonical_patterns,
                a.n_host_syncs, a.bytes_to_host) == (
            b.n_children, b.n_quick_patterns, b.n_canonical_patterns,
            b.n_host_syncs, b.bytes_to_host)


def test_partition_kernels_match_plain_versions(cuda_device):
    """gather_rows and canonical_check_tiles against their plain versions:
    row counts that are no block multiple, row ids of -1, N and past N,
    tables wider and narrower than a block, and a whole tile view built
    through the kernels against the one built on the CPU."""
    dev = cuda_device
    rng = np.random.default_rng(2)
    before = dict(build.LAUNCHES)
    for n, r, u in ((1000, 2945, 777), (1000, 313, 8193), (5, 3, 1),
                    (64, 257, 0)):
        table = torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, r), dtype=np.int64)
            .astype(np.int32)).to(dev)
        rows = torch.from_numpy(
            rng.integers(-2, n + 2, u).astype(np.int32)).to(dev)
        if u:
            rows[0] = n
        for fill in (-1, 0):
            assert torch.equal(gather.gather_rows_cuda(table, rows, fill),
                               gather.gather_rows_ref(table, rows, fill))

    pg = TG.to_partitioned(TG.random_labeled(300, 2000, n_labels=3, seed=4),
                           4, device=dev)
    pg_cpu = TG.PartitionedGraph(*(t.cpu() for t in pg))
    members, n_valid = (t.to(dev) for t in _members(rng, 777, 3, pg.n))
    kw = dict(use_pallas=True, compact_kernel=True)
    view = explore.build_tile_view(pg, members, n_valid, "vertex", **kw)
    view_cpu = explore.build_tile_view(pg_cpu, members.cpu(), n_valid.cpu(),
                                       "vertex", **kw)
    for a, b in zip(view, view_cpu):
        assert torch.equal(a.cpu(), b)
    b = 50_001
    flat = torch.from_numpy(rng.integers(0, 777, b)).to(dev)
    ranks = torch.from_numpy(
        rng.integers(-1, view.uniq.shape[0] + 2, (b, 3)).astype(np.int32)
    ).to(dev)
    cand = torch.from_numpy(rng.integers(-1, pg.n, b).astype(np.int32)).to(dev)
    args = (members[flat], ranks, n_valid[flat], cand, view.adj_t)
    assert torch.equal(canonical_check_tiles_cuda(*args),
                       canonical_check_tiles_ref(*args))
    assert canonical_check_tiles_cuda(
        *(a[:0] for a in args[:4]), view.adj_t).shape == (0,)
    torch.cuda.synchronize()
    for name in ("gather_rows", "canonical_check_tiles", "stream_compact"):
        assert build.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("app", [MotifsApp(max_size=3), CliquesApp(max_size=4)])
def test_partitioned_card_run_equals_cpu_run(cuda_device, app):
    g = TG.mico_like(0.003)
    cfg = RunConfig(graph_partition=4, chunk_size=256, initial_capacity=64)
    before = dict(build.LAUNCHES)
    gpu = run(g, app, cfg, device=cuda_device)
    cpu = run(g, app, cfg, device="cpu")
    assert gpu.patterns == cpu.patterns
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert (a.n_children, a.n_generated, a.n_canonical, a.n_host_syncs,
                a.n_quick_patterns, a.bytes_to_host) == (
            b.n_children, b.n_generated, b.n_canonical, b.n_host_syncs,
            b.n_quick_patterns, b.bytes_to_host)
    for size, emb in cpu.embeddings.items():
        np.testing.assert_array_equal(gpu.embeddings[size], emb)
    for name in ("gather_rows", "canonical_check_tiles"):
        assert build.LAUNCHES[name] > before[name], name
