"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
a CUDA device — a CUDA kernel has no CPU mode). Each kernel is held against
its plain PyTorch version on the same tensors (integers and booleans:
exact; the model zoo's float kernels within the tolerances stated at each
test), and a whole run on the card against the same run on the CPU. This
file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import RunConfig, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core import canon_math
from repro_torch.core.stats import StepStats
from repro_torch.kernels import aggregate, build, canonical_refine, compact
from repro_torch.kernels import gather, radix_bin
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda,
    canonical_check_ref,
    canonical_check_tiles_cuda,
    canonical_check_tiles_ref,
    expand_canonical_cuda,
    expand_canonical_ref,
    expand_variant,
)
from repro_torch.core import explore
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
    flash_attention_ref,
    tma_readable,
)
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_ref
from repro_torch.models import build_model

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


#: (k, D, n) of the expansion cases: every k in {1, 2, 3, 8} against D of
#: 1, 3, 17 and 300 and n a multiple of 32 and not (the bitmap's last word
#: whole or partial); then k = 8 at full MiCo's n (100,000: 100,000 bytes
#: of staged rows, above the 48 KB default) and at 2^17 + 5 (131,077
#: vertices: the global-read variant).
EXPAND_CASES = [(k, d, n) for k in (1, 2, 3, 8) for d in (1, 3, 17, 300)
                for n in (256, 237)] + [(8, 60, 100_000), (8, 40, 131_077)]


@pytest.mark.parametrize("k,d,n", EXPAND_CASES)
def test_expand_kernel_matches_plain_version(cuda_device, k, d, n):
    """The fused expansion kernel bit for bit against its plain version on
    synthetic tables: neighbour rows with -1 pads anywhere (the contract
    does not ask them to be left-packed), random bitmap words, C of 0, 1
    and 777 parents whose n_valid runs from 0 to k, with real vertex ids or
    -1 past n_valid and member ids at or past n (clamped into the tables).
    Each batch runs twice; each call with C > 0 adds one launch."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(k * 1000 + d + n)
    words = (n + 31) // 32
    want_variant = "global" if n > 100_000 else "staged"
    assert expand_variant(k, words) == want_variant
    nbr = torch.randint(0, n, (n, d), generator=gen, device=dev,
                        dtype=torch.int32)
    nbr[torch.rand((n, d), generator=gen, device=dev) < 0.3] = -1
    adj = torch.randint(-2**31, 2**31 - 1, (n, words), generator=gen,
                        device=dev, dtype=torch.int32)
    for c in (0, 1, 777):
        members = torch.randint(0, n + 8, (c, k), generator=gen, device=dev,
                                dtype=torch.int32)
        n_valid = torch.randint(0, k + 1, (c,), generator=gen, device=dev,
                                dtype=torch.int32)
        past = torch.arange(k, device=dev)[None, :] >= n_valid[:, None]
        pad = past & (torch.arange(c, device=dev)[:, None] % 2 == 0)
        members = members.masked_fill(pad, -1)
        want = expand_canonical_ref(members, n_valid, nbr, adj)
        for _ in range(2):
            before = build.LAUNCHES["expand_canonical"]
            got = expand_canonical_cuda(members, n_valid, nbr, adj)
            assert build.LAUNCHES["expand_canonical"] - before == (c > 0)
            torch.cuda.synchronize()
            for a, b, name in zip(got, want, ("cand", "valid", "keep")):
                assert a.shape == (c, k, d) and a.dtype == b.dtype, name
                assert torch.equal(a, b), (name, c)


@pytest.mark.parametrize("app", [MotifsApp(max_size=3), CliquesApp(max_size=4)])
@pytest.mark.parametrize("fused", [False, True])
def test_card_run_equals_cpu_run(cuda_device, app, fused):
    g = TG.mico_like(0.003)
    # cost_model="off": a graph of 2,048 edges or more calibrates under
    # "auto", and the card and the CPU may then place phases differently
    cfg_kw = dict(chunk_size=256, initial_capacity=64, fused_expand=fused,
                  cost_model="off")
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


def _check_radix_kernels(codes, valid):
    """The radix kernels on one batch against their plain versions, twice
    on the same scratch: the histogram's plan, counts and bases, each
    launch of the scatter kernel against one stable pass over the keys and
    order it read (the last one also against the codes and valid flags
    gathered in its order), and the outputs against the whole-sort
    oracle."""
    b, dev = codes.shape[0], codes.device
    st = radix_bin.RadixScratch(b, dev)
    want = radix_bin.radix_sort_codes_ref(codes, valid)[2]
    ref = radix_bin.radix_digit_counts_ref(codes, valid)
    for _ in range(2):
        radix_bin.radix_hist_cuda(codes, valid, st)
        for a, w in zip((st.plan, st.counts, st.bases), ref):
            assert torch.equal(a, w)
        plan = st.plan.tolist()
        nvary = plan[0]
        words = [radix_bin._PASSES[p][0] for p in plan[1:1 + nvary]]
        for i in range(radix_bin.NPASSES):
            if i < nvary:
                word, shift = radix_bin._PASSES[plan[1 + i]]
                order = (torch.arange(b, dtype=torch.int32, device=dev)
                         if i == 0 else st.orders[i & 1].clone())
                keys = (radix_bin._word(codes, valid, word)[order.long()]
                        if i == 0 or words[i - 1] != word
                        else st.keys[i & 1].long() & 0xFFFFFFFF)
            radix_bin.radix_scatter_cuda(codes, valid, st, i)
            if i == nvary - 1:
                o_ref = radix_bin.radix_pass_ref(keys, order, shift)[1]
                assert torch.equal(st.out, o_ref)
                assert torch.equal(st.codes_out, codes[o_ref])
                assert torch.equal(st.valid_out, valid[o_ref])
            elif i < nvary:
                k_ref, o_ref = radix_bin.radix_pass_ref(keys, order, shift)
                assert torch.equal(st.orders[(i + 1) & 1], o_ref), i
                if words[i + 1] == word:
                    got = st.keys[(i + 1) & 1].long() & 0xFFFFFFFF
                    assert torch.equal(got, k_ref), i
        assert torch.equal(st.out, want)
        assert torch.equal(st.codes_out, codes[want])
        assert torch.equal(st.valid_out, valid[want])


@pytest.mark.parametrize("case,size", [
    ("random", "0"), ("random", "1"), ("random", "tile-1"),
    ("random", "tile"), ("random", "tile+1"), ("random", "tiles"),
    ("random", "2^20+3"), ("one_digit", "2^20+3"), ("skewed", "2^20+3"),
    ("all_invalid", "tiles"), ("flag_only", "tiles"),
    ("word_after_skip", "tiles"), ("bit_31", "tiles"),
])
def test_radix_kernels_match_plain_versions(cuda_device, case, size):
    """The radix kernels off the main path's shapes: B of 0, 1, one tile
    and one row either side, 17 tiles and 2^20 + 3 rows; every pass varies
    (random words, bit 31 set in half of them); every row the same code
    (no pass varies: launch 0 writes the identity; the worst skew); 99.9 %
    of rows zero and invalid (the level-2 re-bin's shape); all rows
    invalid; only the invalid flag varies; a word whose low byte is
    constant and whose higher bytes vary (its first pass comes after a
    skipped one); words with bit 31 set in every row."""
    tile = build.library().repro_radix_tile()
    assert tile == radix_bin.RADIX_TILE
    b = {"0": 0, "1": 1, "tile-1": tile - 1, "tile": tile,
         "tile+1": tile + 1, "tiles": 17 * tile - 5,
         "2^20+3": (1 << 20) + 3}[size]
    rng = np.random.default_rng(b + len(case))
    codes = rng.integers(0, 2**32, (b, 3)).astype(np.int64)
    valid = rng.random(b) < 0.8
    if case in ("one_digit", "flag_only"):
        codes[:] = [3 | 5 << 4, 0x01020304, 0x0A0B0C0D]
    if case == "one_digit":
        valid[:] = True
    elif case == "skewed":
        live = rng.random(b) < 0.001
        codes[~live] = 0
        valid = live
    elif case == "all_invalid":
        valid[:] = False
    elif case == "word_after_skip":
        codes[:, 1] = (codes[:, 1] & 0xFFFFFF00) | 0x2A
        codes[:, 2] = 7
    elif case == "bit_31":
        codes |= 1 << 31
    codes = torch.from_numpy(codes).to(cuda_device)
    valid = torch.from_numpy(valid).to(cuda_device)
    before = dict(build.LAUNCHES)
    _check_radix_kernels(codes, valid)
    for _ in range(2):
        got = radix_bin.radix_sort_codes(codes, valid)
        want = radix_bin.radix_sort_codes_ref(codes, valid)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    torch.cuda.synchronize()
    if b:
        assert build.LAUNCHES["radix_hist"] == before["radix_hist"] + 4
        assert build.LAUNCHES["radix_scatter"] == before["radix_scatter"] + 52


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
    # the two kernels piece by piece: the histogram, then each launch of
    # the plan from the state the launches before it left
    _check_radix_kernels(codes, valid)
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


SEG_SIZES = ["0", "1", "tile-1", "tile", "tile+1", "many tiles"]


@pytest.mark.parametrize("case", ["random", "prefix", "all_invalid",
                                  "one_segment", "every_row", "unaligned"])
@pytest.mark.parametrize("size", SEG_SIZES)
def test_seg_unique_matches_plain_version(cuda_device, size, case):
    """Bit for bit against the plain version: B of 0, 1, one tile and one
    row either side, and 4 x 132 tiles + 77 (chains of look-backs over more
    tiles than the card holds at once); flags random with a valid mask
    that is no prefix, a valid prefix (the main path's sort order), all
    rows invalid, one segment over every tile (every tile adds to one
    count), every row its own segment, and the flags as views at byte
    offset 3 (byte-wise loads); cap 0, below the distinct count and above
    it. Each call runs twice and answers the same."""
    tile = build.library().repro_seg_unique_tile()
    b = {"0": 0, "1": 1, "tile-1": tile - 1, "tile": tile,
         "tile+1": tile + 1, "many tiles": 4 * 132 * tile + 77}[size]
    g = torch.Generator(device=cuda_device).manual_seed(b + len(case))
    valid = torch.rand(b + 3, generator=g, device=cuda_device) < 0.9
    new = torch.rand(b + 3, generator=g, device=cuda_device) < 0.01
    if case == "prefix":
        valid = torch.arange(b + 3, device=cuda_device) < (b * 7) // 10
    elif case == "all_invalid":
        valid.fill_(False)
    elif case == "one_segment":
        valid.fill_(True)
        new.fill_(False)
        new[0] = True
    elif case == "every_row":
        valid.fill_(True)
        new.fill_(True)
    new, valid = ((new[3:], valid[3:]) if case == "unaligned"
                  else (new[:b], valid[:b]))
    distinct = int((new & valid).sum())
    before = build.LAUNCHES["seg_unique"]
    for cap in (0, distinct // 2, distinct + 5):
        want = aggregate.seg_unique_ref(new, valid, cap)
        for _ in range(2):
            got = aggregate.seg_unique_cuda(new, valid, cap)
            for a, w in zip(got, want):
                assert a.shape == w.shape and torch.equal(a, w), cap
        assert int(got[3]) == distinct
    torch.cuda.synchronize()
    assert build.LAUNCHES["seg_unique"] == before + (6 if b else 0)


@pytest.mark.parametrize("case", ["scattered", "all_invalid", "mixed",
                                  "prefix"])
def test_refine_kernel_matches_plain_version(cuda_device, case):
    """Bit for bit against the plain version, orbits off and on: nv-3 rows
    live at both sides of every tile edge and at random among invalid
    rows; all rows invalid; mixed nv 2-8 (labels in every byte, some rows
    invalid) under every nv and under a subset of them; the main path's
    shape, a live prefix of 68,743 rows in 2^20 with zero rows after it.
    The scattered and mixed batches are no multiple of the kernel's tile.
    Each call runs twice and answers the same."""
    dev = cuda_device
    rng = np.random.default_rng(len(case))
    if case == "mixed":
        codes = np.concatenate([_refine_codes(rng, nv, 400 if nv < 8 else 60,
                                              n_labels=29)
                                for nv in range(2, 9)])
        codes = codes[rng.permutation(len(codes))]
        valid = rng.random(len(codes)) < 0.9
        launches = ((2, 3, 4, 5, 6, 7, 8), (3, 5, 8))
    elif case == "prefix":
        codes = np.zeros((1 << 20, 3), np.int64)
        codes[:68_743] = _codes(rng, 68_743).numpy()
        valid = np.arange(1 << 20) < 68_743
        launches = ((3,),)
    else:
        codes = _codes(rng, 20_000 + 77).numpy()
        valid = rng.random(len(codes)) < 0.3
        launches = ((3,),)
    codes = torch.from_numpy(codes).to(dev)
    if case == "scattered":
        _, _, group = canonical_refine._kernel_tables((3,), dev)
        tile = canonical_refine.tile_rows(
            len(codes), group, 6,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        assert len(codes) % tile
        edges = np.arange(tile, len(codes), tile)
        valid[edges - 1] = valid[edges] = True
    elif case == "all_invalid":
        valid[:] = False
    valid = torch.from_numpy(valid).to(dev)
    before = build.LAUNCHES["canonical_refine"]
    for nvs in launches:
        for orbits in (False, True):
            want = canonical_refine.refine_codes_ref(codes, valid, nvs,
                                                     with_orbits=orbits)
            for _ in range(2):
                got = canonical_refine.refine_cuda(codes, valid, nvs,
                                                   with_orbits=orbits)
                for a, w in zip(got, want):
                    assert torch.equal(a, w), (nvs, orbits)
    torch.cuda.synchronize()
    assert build.LAUNCHES["canonical_refine"] == before + 4 * len(launches)


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
    cfg = RunConfig(graph_partition=4, chunk_size=256, initial_capacity=64,
                    cost_model="off")   # as in test_card_run_equals_cpu_run
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


@pytest.mark.parametrize("knobs", [
    dict(), dict(cost_model="force_device"), dict(device_aggregate=False),
    dict(graph_partition=4), dict(async_chunks=False),
], ids=["default", "force_device", "host_level1", "partitioned", "sync"])
def test_fsm_card_run_equals_cpu_run(cuda_device, knobs):
    """FSM (edge mode, min-image domains, support pruning) on the card
    against the same run on the CPU: patterns with their supports, every
    step's counters, the step aggregates; under ``force_device`` the
    refine's orbit pass (two launches a level-2 pass)."""
    g = TG.citeseer_like(0.1)
    cfg = RunConfig(chunk_size=256, initial_capacity=64, **knobs)
    app = FSMApp(support=2, max_size=3)
    before = dict(build.LAUNCHES)
    gpu = run(g, app, cfg, device=cuda_device)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] - before[k] for k in before}
    cpu = run(g, app, cfg, device="cpu")
    assert gpu.patterns == cpu.patterns and gpu.patterns
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert (a.n_children, a.n_generated, a.n_canonical, a.n_host_syncs,
                a.n_quick_patterns, a.n_canonical_patterns,
                a.bytes_to_host) == (
            b.n_children, b.n_generated, b.n_canonical, b.n_host_syncs,
            b.n_quick_patterns, b.n_canonical_patterns, b.bytes_to_host)
    for a, b in zip(gpu.aggregates, cpu.aggregates):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert launches["stream_compact"] > 0
    if "cost_model" in knobs:
        # the canonical refine and its orbit pass, once each a step
        assert launches["canonical_refine"] == 2 * len(gpu.stats.steps)
    if "graph_partition" in knobs:
        assert launches["gather_rows"] > 0


def test_edge_chunk_program_matches_cpu(cuda_device):
    """One edge-mode chunk program on the card (whole graph and tile view)
    against the CPU: children, codes, the local-vertex table, counters."""
    g = TG.citeseer_like(0.3)
    rows = min(777, g.m)
    members = torch.arange(rows, dtype=torch.int32)[:, None]
    n_valid = torch.ones(rows, dtype=torch.int32)
    app = FSMApp(support=2, max_size=3)
    for make in (lambda d: TG.to_device(g, d),
                 lambda d: TG.to_partitioned(g, 4, device=d)):
        outs = [explore.fused_chunk_step(
            make(dev), members.to(dev), n_valid.to(dev), 1 << 14,
            mode="edge", app=app, with_patterns=True, with_local_verts=True,
            use_pallas=True, compact_kernel=True, aggregate_kernel=True)
            for dev in (cuda_device, "cpu")]
        for a, b in zip(*outs):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mode", ["vertex", "edge"])
def test_odag_extraction_on_the_card_matches_cpu(cuda_device, mode):
    """ODAG extraction with the graph on the card: the same rows, in the
    same order, as on the CPU, whatever the chunk of candidate pairs; in
    vertex mode the Algorithm-2 check launches ``canonical_check`` once a
    level and chunk, and ``stream_compact`` compacts every chunk."""
    from repro_torch.core import odag
    g = TG.random_labeled(300, 1500, n_labels=2, seed=4)
    app = (MotifsApp(max_size=3, collect_embeddings=True) if mode == "vertex"
           else FSMApp(support=1, max_size=3, collect_embeddings=True))
    emb = run(g, app, RunConfig(), device="cpu").embeddings[3]
    o = odag.build(emb[::2])
    want = odag.extract(TG.to_device(g, "cpu"), o, mode=mode,
                        use_pallas=True)
    dg = TG.to_device(g, cuda_device)
    for chunk in (odag.EXTRACT_PAIRS, 1000):
        before = dict(build.LAUNCHES)
        stats = {}
        got = odag.extract(dg, o, mode=mode, use_pallas=True, chunk=chunk,
                           stats=stats)
        launches = {k: build.LAUNCHES[k] - before[k] for k in before}
        np.testing.assert_array_equal(got, want)
        assert launches["stream_compact"] == stats["chunks"]
        assert launches["canonical_check"] == (
            stats["chunks"] if mode == "vertex" else 0)
        assert stats["host_syncs"] == stats["chunks"] + 1


@pytest.mark.parametrize("knobs", [
    dict(store="odag"), dict(device_budget_bytes=1 << 14),
    dict(store="odag", device_budget_bytes=1 << 14),
], ids=["odag", "spill_raw", "spill_odag"])
@pytest.mark.parametrize("app", [MotifsApp(max_size=3), CliquesApp(max_size=4),
                                 FSMApp(support=2, max_size=3)],
                         ids=["motifs", "cliques", "fsm"])
def test_store_card_run_equals_cpu_run(cuda_device, app, knobs):
    """The ODAG and spill stores on the card against the same runs on the
    CPU: patterns, embeddings, every step's counters (``odag_bytes``
    included)."""
    g = (TG.citeseer_like(0.1) if isinstance(app, FSMApp)
         else TG.mico_like(0.002))
    cfg = RunConfig(chunk_size=512, cost_model="off",  # 2,160 edges
                    **knobs)
    gpu = run(g, app, cfg, device=cuda_device)
    cpu = run(g, app, cfg, device="cpu")
    assert gpu.patterns == cpu.patterns
    assert sorted(gpu.embeddings) == sorted(cpu.embeddings)
    for size, emb in cpu.embeddings.items():
        np.testing.assert_array_equal(gpu.embeddings[size], emb)
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert (a.n_frontier, a.n_children, a.n_generated, a.n_canonical,
                a.n_host_syncs, a.n_quick_patterns, a.frontier_bytes,
                a.odag_bytes, a.bytes_to_host) == (
            b.n_frontier, b.n_children, b.n_generated, b.n_canonical,
            b.n_host_syncs, b.n_quick_patterns, b.frontier_bytes,
            b.odag_bytes, b.bytes_to_host)


#: the wall-time fields of StepStats (every other field is a count)
_TIMES = [f.name for f in dataclasses.fields(StepStats)
          if f.name.startswith("t_")]


@pytest.mark.parametrize("knobs", [
    dict(), dict(graph_partition=4), dict(graph_partition=4, halo="gather"),
    dict(store="odag"), dict(fused_expand=True, aggregate_bin="radix",
                             canonical_placement="device"),
    dict(agg_qcap=16),
], ids=["whole", "alltoall", "gather", "odag", "fused_device", "qcap"])
@pytest.mark.parametrize("app", [MotifsApp(max_size=3), CliquesApp(max_size=4),
                                 FSMApp(support=2, max_size=3)],
                         ids=["motifs", "cliques", "fsm"])
def test_shard_card_run_equals_cpu_run(cuda_device, app, knobs,
                                      monkeypatch):
    """``run_distributed`` over four workers on the card against the same
    run over four workers on the CPU: patterns, embeddings in order, every
    step's counters (``collective_bytes`` included). The CPU run recovers
    from an overflowing per-worker table as the card does (``qcap``: a
    re-bin on the workers' devices); the card never takes the host
    aggregation path."""
    from repro_torch.core.distributed import make_mesh, run_distributed
    from repro_torch.core.runtime import ShardMapBackend

    g = (TG.citeseer_like(0.1) if isinstance(app, FSMApp)
         else TG.mico_like(0.002))
    cfg = RunConfig(cost_model="off", **knobs)
    quick_codes = ShardMapBackend.quick_codes

    def card_never_on_host(backend, blocks, size):
        assert not backend._refold, "the card took the host path"
        return quick_codes(backend, blocks, size)

    monkeypatch.setattr(ShardMapBackend, "quick_codes", card_never_on_host)
    gpu = run_distributed(g, app, make_mesh((4,), ("data",),
                                            device=cuda_device), cfg)
    monkeypatch.setattr(ShardMapBackend, "refold_on_device", True)
    cpu = run_distributed(g, app, make_mesh((4,), ("data",), device="cpu"),
                          cfg)
    assert gpu.patterns == cpu.patterns
    assert sorted(gpu.embeddings) == sorted(cpu.embeddings)
    for size, emb in cpu.embeddings.items():
        np.testing.assert_array_equal(gpu.embeddings[size], emb)
    for a, b in zip(gpu.stats.steps, cpu.stats.steps):
        assert dataclasses.replace(a, **{f: 0.0 for f in _TIMES}) == \
            dataclasses.replace(b, **{f: 0.0 for f in _TIMES})
        assert a.n_host_syncs <= 2


def test_edge_quick_patterns_in_slices_on_the_card(cuda_device):
    """The edge quick patterns over row slices on the card equal one call
    over all rows on the CPU."""
    from repro_torch.core import pattern
    g = TG.citeseer_like(0.3)
    rng = np.random.default_rng(5)
    b = 50_000
    nv = torch.from_numpy(rng.integers(0, 5, b).astype(np.int32))
    mem = torch.from_numpy(rng.integers(0, g.m, (b, 4)).astype(np.int32))
    mem = torch.where(torch.arange(4)[None, :] < nv[:, None], mem, -1)
    want = pattern.quick_pattern_edge(TG.to_device(g, "cpu"), mem, nv)
    dg = TG.to_device(g, cuda_device)
    for slice_rows in (None, 4097):
        got = pattern.quick_pattern_edge(dg, mem.to(cuda_device),
                                         nv.to(cuda_device),
                                         slice_rows=slice_rows)
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)


# ---------------------------------------------------------------------------
# model zoo: RMSNorm and flash attention (qwen2.5-14b widths: d_model 5,120,
# 40 heads over 8 KV heads of 128; smollm-135m: 9 over 3 of 64)
# ---------------------------------------------------------------------------

MODEL_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("scale_dtype", MODEL_DTYPES)
@pytest.mark.parametrize("dtype", MODEL_DTYPES)
@pytest.mark.parametrize("rows,d", [(8192, 5120), (4, 5120), (7, 100),
                                    (64, 8192), (64, 16384), (5, 5121)])
def test_rmsnorm_kernel_matches_plain_version(cuda_device, rows, d, dtype,
                                              scale_dtype):
    """Kernel and plain version both compute in f32 and round once: f32
    1e-5 (summation order), bf16 one rounding step (relative 2^-7). The
    scale may be of either type, as the TPU kernel takes it. (7, 100) and
    (5, 5121) take the scalar units (D not a vector multiple); bf16 16,384,
    f32 8,192 and up, and the scalar 5,121 are past the register budget
    and take the two-pass form."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((rows, d), generator=g, device=cuda_device).to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=g,
                                   device=cuda_device)).to(scale_dtype)
    before = build.LAUNCHES["rmsnorm"]
    got = rmsnorm_cuda(x, scale)
    want = rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2**-7)


def test_rmsnorm_kernel_runs_on_the_current_stream(cuda_device):
    """The raw stream handle the wrappers launch on is PyTorch's current
    stream, the default one and a side stream; a call on the side stream
    (leading dims kept, a strided view copied) matches the plain version."""
    side = torch.cuda.Stream(cuda_device)
    dev = cuda_device.index or 0
    assert build.raw_stream(dev) == torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 4, 2 * 5120), generator=g,
                    device=cuda_device).to(torch.bfloat16)[..., ::2]
    scale = torch.randn((5120,), generator=g, device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert build.raw_stream(dev) == side.cuda_stream
        assert build.raw_stream(dev) == torch.cuda.current_stream().cuda_stream
        got = rmsnorm_cuda(x, scale)
    side.synchronize()
    want = rmsnorm_ref(x, scale)
    assert got.shape == x.shape and got.dtype == x.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2**-7)


@pytest.mark.parametrize("mask", ["none", "all", "random"])
@pytest.mark.parametrize("size", ["0", "1", "tile", "tile+1", "many tiles"])
def test_stream_compact_matches_plain_version(cuda_device, size, mask):
    """Bit for bit against the plain version: B of 0, 1, one tile, one tile
    + 1 and 4 x 132 tiles + 77 (chains of look-backs over more tiles than
    the card holds at once); masks all false, all true and random at 0.3;
    out_cap 0, below the count and above it; the flags contiguous and as a
    view at byte offset 3 (byte-wise loads). Each call runs twice on fresh
    scratch and answers the same."""
    tile = build.library().repro_compact_tile()
    b = {"0": 0, "1": 1, "tile": tile, "tile+1": tile + 1,
         "many tiles": 4 * 132 * tile + 77}[size]
    g = torch.Generator(device=cuda_device).manual_seed(b)
    flags = torch.rand(b + 3, generator=g, device=cuda_device) < 0.3
    if mask != "random":
        flags.fill_(mask == "all")
    for keep in (flags[:b], flags[3:]):
        kept = int(keep.sum())
        for cap in (0, kept // 2, kept + 5):
            want = compact.stream_compact_ref(keep, cap)
            for _ in range(2):
                idx, count = compact.stream_compact_cuda(keep, cap)
                assert torch.equal(idx, want[0]) and torch.equal(count, want[1])
            assert count.shape == () and int(count) == kept


def _flash_inputs(g, dev, dtype, b, sq, sk, h, kv, d, layout):
    """q (B, Sq, H, D), k and v (B, Sk, KV, D): separate tensors
    ("contiguous"), views of one fused (B, S, H + 2 KV, D) projection
    ("fused"), views whose base lies one element past a 16-byte boundary
    ("unaligned"), or separate tensors whose q and k rows share a vector
    per head twice their own scale ("offset", as trained activations do:
    the keys' common part cancels from dq only in exact arithmetic)."""
    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if layout == "fused":
        qkv = draw(b, sq, h + 2 * kv, d)
        return qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    if layout == "unaligned":
        return tuple(draw(math.prod(shape) + 1)[1:].view(shape) for shape in (
            (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    if layout == "offset":
        q, k = (draw(b, s, n, d).float() + 2 * draw(b, 1, n, d).float()
                for s, n in ((sq, h), (sk, kv)))
        return q.to(dtype), k.to(dtype), draw(b, sk, kv, d)
    return draw(b, sq, h, d), draw(b, sk, kv, d), draw(b, sk, kv, d)


@pytest.mark.parametrize("dtype", MODEL_DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,layout", [
    (4, 2048, 2048, 40, 8, 128, True, "contiguous"),  # the qwen2.5-14b forward
    (2, 2048, 2048, 9, 3, 64, True, "contiguous"),    # smollm-135m widths
    (2, 200, 200, 40, 8, 128, True, "contiguous"),    # ragged S
    (1, 77, 300, 4, 2, 256, True, "contiguous"),      # Sq != Sk, start-aligned
    (2, 64, 96, 4, 4, 16, False, "contiguous"),       # full attention, reduced
    (1, 127, 127, 4, 2, 64, True, "contiguous"),      # around the 128-row tile
    (1, 129, 129, 4, 2, 64, True, "contiguous"),
    (1, 191, 191, 4, 2, 64, True, "contiguous"),
    (2, 150, 150, 4, 2, 16, True, "contiguous"),      # D padded to 64
    (2, 150, 150, 4, 2, 80, True, "contiguous"),      # D padded to 128
    (2, 150, 150, 4, 2, 256, True, "contiguous"),     # D = 256: 64-row K tiles
    (1, 200, 200, 6, 2, 128, False, "contiguous"),    # full attention, GQA
    (2, 130, 130, 8, 2, 64, True, "fused"),           # strided views
    (2, 100, 100, 4, 2, 64, True, "unaligned"),       # copied by the wrapper
])
def test_flash_kernel_matches_plain_version(cuda_device, b, sq, sk, h, kv, d,
                                            causal, layout, dtype):
    """f32 (CUDA cores): both compute in f32 and round once, within the JAX
    package's f32 kernel-test bound 2e-5 (summation order; TF32 off for the
    plain version's matmuls). bf16 (tensor cores): the kernel rounds the
    softmax weights to bf16 before PV, as the TPU kernel's MXU and
    ``scaled_dot_product_attention`` do, so it is held to the JAX package's
    bf16 bound for this kernel (2e-2) and to at most 1.5x SDPA's largest
    error against the same plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = _flash_inputs(g, cuda_device, dtype, b, sq, sk, h, kv, d,
                            layout)
    if layout == "unaligned" and dtype == torch.bfloat16:
        assert not tma_readable(q)
    before = build.LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal).float()
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        return
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal,
        enable_gqa=True).transpose(1, 2).float()
    err, sdpa_err = ((x - want).abs().max().item()
                     for x in (got.float(), sdpa))
    assert err <= 1.5 * sdpa_err, (err, sdpa_err)


def _keep_mask(sq, sk, causal, window, dev):
    i = torch.arange(sq, device=dev)[:, None]
    j = torch.arange(sk, device=dev)[None, :]
    keep = i >= j if causal else torch.ones((sq, sk), dtype=torch.bool,
                                            device=dev)
    return keep & (j > i - window) if window else keep


@pytest.mark.parametrize("dtype", MODEL_DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", [
    (1, 2048, 2048, 8, 2, 128, True, 512),   # the hybrid's window, tiles skipped
    (2, 300, 300, 4, 2, 80, True, 100),      # zamba2's head dim, ragged
    (1, 200, 200, 4, 4, 64, False, 37),      # a window without the mask
    (1, 40, 40, 2, 2, 64, True, 1),          # each query keeps only itself
    (1, 300, 300, 8, 8, 192, True, 0),       # MLA: D = 192 (v padded), DP 256
    (2, 1500, 1500, 8, 8, 64, False, 0),     # whisper's encoder
    (2, 448, 1500, 8, 8, 64, False, 0),      # whisper's cross-attention
])
def test_flash_kernel_window_and_model_shapes(cuda_device, b, sq, sk, h, kv,
                                              d, causal, window, dtype):
    """The window and the new families' shapes against the plain version,
    under the bounds of ``test_flash_kernel_matches_plain_version``; SDPA
    is given the same mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = _flash_inputs(g, cuda_device, dtype, b, sq, sk, h, kv, d,
                            "contiguous")
    before = build.LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal, window)
    want = flash_attention_ref(q, k, v, causal, window).float()
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        return
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)),
        attn_mask=_keep_mask(sq, sk, causal, window, cuda_device),
        enable_gqa=True).transpose(1, 2).float()
    err, sdpa_err = ((x - want).abs().max().item()
                     for x in (got.float(), sdpa))
    assert err <= 1.5 * sdpa_err, (err, sdpa_err)


@pytest.mark.parametrize("dtype", MODEL_DTYPES)
def test_mla_narrow_v_route_on_the_card(cuda_device, dtype):
    """MLA's prefill route at D = 192 with v of 128 padded, on the card
    against the plain version of the same route."""
    from repro_torch.models.layers import attention_narrow_v
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k = (torch.randn((2, 333, 8, 192), generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    v = torch.randn((2, 333, 8, 128), generator=g, device=cuda_device).to(dtype)
    got = attention_narrow_v(q, k, v)
    want = attention_narrow_v(q.cpu(), k.cpu(), v.cpu()).float()
    assert got.shape == (2, 333, 8, 128)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=tol)


def test_flash_kernel_reads_strided_inputs(cuda_device):
    """q, k and v as views of one fused (B, S, H + 2 KV, D) projection."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, 130, 12, 64), generator=g, device=cuda_device)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    torch.testing.assert_close(flash_attention_cuda(q, k, v),
                               flash_attention_ref(q, k, v),
                               atol=2e-5, rtol=2e-5)


def test_model_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    x = torch.ones((4, 64), device=cuda_device, dtype=torch.bfloat16)
    scale = torch.full((64,), 1.5, device=cuda_device)
    # a scale of the other kernel type is taken, as the TPU kernel takes it
    assert torch.equal(rmsnorm_cuda(x, scale), rmsnorm_ref(x, scale))
    with pytest.raises(TypeError):        # fp16 is not a kernel type
        rmsnorm_cuda(x.half(), torch.ones(64, device=cuda_device).half())
    q = torch.ones((1, 8, 4, 12), device=cuda_device)
    with pytest.raises(ValueError):       # head dim not a multiple of 8
        flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = torch.ones((1, 8, 6, 16), device=cuda_device)
    with pytest.raises(ValueError):       # 6 heads over 4 KV heads
        flash_attention_cuda(q, q[:, :, :4], q[:, :, :4])
    q = torch.ones((1, 8, 4, 264), device=cuda_device)
    with pytest.raises(ValueError):       # head dim above 256
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "smollm-135m",
                                  "stablelm-1.6b"])
def test_card_model_matches_cpu_model(cuda_device, name):
    """The reduced model with the same weights on the card and on the CPU:
    the card's bf16 logits (cuBLAS bf16 matmuls, whose reduced-precision
    reductions are on by default, and the two kernels) are as close to the
    CPU's f32 logits as the CPU's own bf16 logits: mean absolute error at
    most 1.25x, the largest at most 2x (as tests/test_torch_models.py holds
    the port to the JAX package)."""
    cfg = ARCHS[name].reduced()
    cpu = build_model(cfg, device="cpu", seed=5)
    cpu32 = build_model(cfg, device="cpu", seed=5)
    cpu32.float()
    card = build_model(cfg, device="cpu", seed=5).to(cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
    before = dict(build.LAUNCHES)
    ref = cpu32.forward(tokens)
    got = card.forward(tokens.to(cuda_device)).float().cpu()
    ec, eb = (got - ref).abs(), (cpu.forward(tokens).float() - ref).abs()
    assert ec.mean() <= 1.25 * eb.mean(), (ec.mean(), eb.mean())
    assert ec.max() <= 2 * eb.max(), (ec.max(), eb.max())
    assert build.LAUNCHES["flash_attention"] == before["flash_attention"] + 4
    assert build.LAUNCHES["rmsnorm"] == before["rmsnorm"] + 9


#: the new families' launches of one reduced forward (rmsnorm, flash)
FAMILY_LAUNCHES = {"deepseek-v2-236b": (4 * 4 + 1, 4),
                   "llama4-maverick-400b-a17b": (2 * 4 + 1, 4),
                   "internvl2-26b": (2 * 4 + 1, 4),
                   "zamba2-2.7b": (2 * 4 + 2 * 2 + 1, 2),
                   "xlstm-1.3b": (2 * 4 + 1, 0),
                   "whisper-base": (2 * 2 + 1 + 3 * 4 + 1, 2 + 2 * 4)}


def _chip_smoke():
    """``chip_smoke.py`` (the repository's root), whose 12b comparison the
    family test runs: one rule and one route record for both."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("name", sorted(FAMILY_LAUNCHES))
def test_card_family_matches_cpu_model(cuda_device, name):
    """Each new family reduced, the same weights on the card and on the
    CPU: the card's bf16 logits of a forward and of 8 decode steps are as
    close to the CPU's f32 logits as the CPU's own bf16 logits, the MoE
    archs' on the positions that keep the f32 run's experts and with no
    more than chip_smoke's slack of extra reroutes
    (``chip_smoke.card_vs_cpu_family``, 12b's first input batch), and the
    forward launches each kernel as often as the config says."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_batch
    cfg = ARCHS[name].reduced()
    card = build_model(cfg, device="cpu", seed=5).to(cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"),
                       torch.Generator().manual_seed(6))
    extra = {k: v for k, v in batch.items() if k in ("patch_embeds", "frames")}
    before = dict(build.LAUNCHES)
    card.forward(batch["tokens"].to(cuda_device), **{
        k: v.to(cuda_device) for k, v in extra.items()})
    torch.cuda.synchronize()
    norms, flashes = FAMILY_LAUNCHES[name]
    assert build.LAUNCHES["rmsnorm"] - before["rmsnorm"] == norms
    assert (build.LAUNCHES["flash_attention"]
            - before["flash_attention"]) == flashes
    smoke = _chip_smoke()
    smoke.card_vs_cpu_family(torch, name, smoke.ZOO_ROUTE_SEEDS[0])


def test_card_calibration_keeps_the_kernels(cuda_device, monkeypatch):
    """On the card the plain versions are never the main path's: the
    kernel knobs stay on, probe 1 (which would decide nothing) is skipped
    and probe 2 chooses between the two bins on their kernels (probe
    constants shrunk as ``test_torch_costmodel.py`` shrinks them)."""
    from repro_torch.core.runtime import costmodel

    monkeypatch.setattr(costmodel, "PROBE_CHUNK_ROWS", 32)
    monkeypatch.setattr(costmodel, "PROBE_BIN_ROWS", 2048)
    monkeypatch.setattr(costmodel, "PROBE_OUT_CAP", 1 << 10)
    costmodel.clear_cache()
    g0 = TG.random_labeled(120, 600, n_labels=2, seed=22)
    g = TG.to_device(g0, cuda_device)
    cfg = RunConfig(cost_model_min_edges=100)
    _, t = costmodel.resolve(cfg, g, MotifsApp(max_size=3), "serial")
    assert t.source == "calibrated" and t.platform == "cuda"
    assert (t.use_pallas, t.compact_kernel, t.aggregate_kernel) == \
        (True, True, True)
    assert [k for k in t.timings if k.startswith("expand.")] == []
    assert sorted(k for k in t.timings if k.startswith("bin.")) == \
        ["bin.radix.kernel", "bin.sort.kernel"]
    res = run(g0, MotifsApp(max_size=3), cfg, device=cuda_device)
    ref = run(g0, MotifsApp(max_size=3),
              dataclasses.replace(cfg, cost_model="off"), device="cpu")
    assert res.patterns == ref.patterns
    costmodel.clear_cache()


# ---------------------------------------------------------------------------
# Training: the backward kernels, the forward's lse, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_dtype", MODEL_DTYPES)
@pytest.mark.parametrize("dtype", MODEL_DTYPES)
@pytest.mark.parametrize("rows,d", [(1024, 576), (4096, 2048), (7, 100),
                                    (600, 5120)])
def test_rmsnorm_bwd_kernel_matches_plain_version(cuda_device, rows, d,
                                                  dtype, scale_dtype):
    """The backward kernel against its plain version on the same x, scale
    and dy: both compute in f32 and round once, so f32 within 1e-5 of the
    largest value (summation order) and bf16 within one rounding step
    (2^-7) of it; two runs give the same bits (no atomics). (7, 100) takes
    the scalar units; 600 rows cover a grid of fewer blocks than rows
    (rows 512 + c and c share a block). Through :func:`rmsnorm` with
    autograd recording, both directions launch their kernels."""
    from repro_torch.kernels.rmsnorm.rmsnorm import (
        rmsnorm, rmsnorm_bwd_cuda, rmsnorm_bwd_ref)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((rows, d), generator=g, device=cuda_device).to(dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=g,
                                   device=cuda_device)).to(scale_dtype)
    dy = torch.randn((rows, d), generator=g, device=cuda_device).to(dtype)
    before = build.LAUNCHES["rmsnorm_bwd"]
    dx, ds = rmsnorm_bwd_cuda(x, scale, dy)
    dx2, ds2 = rmsnorm_bwd_cuda(x, scale, dy)
    want_dx, want_ds = rmsnorm_bwd_ref(x, scale, dy)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm_bwd"] == before + 2
    assert dx.dtype == dtype and ds.dtype == scale_dtype
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    for got, want, t in ((dx, want_dx, dtype), (ds, want_ds, scale_dtype)):
        tol = 1e-5 if t == torch.float32 else 2**-7
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (err, tol)

    xr = x.clone().requires_grad_()
    sr = scale.clone().requires_grad_()
    fwd, bwd = build.LAUNCHES["rmsnorm"], build.LAUNCHES["rmsnorm_bwd"]
    rmsnorm(xr, sr).backward(dy)
    assert build.LAUNCHES["rmsnorm"] == fwd + 1
    assert build.LAUNCHES["rmsnorm_bwd"] == bwd + 1
    assert torch.equal(xr.grad, dx) and torch.equal(sr.grad, ds)


#: flash backward cases: (b, sq, sk, h, kv, d, causal, window, layout)
FLASH_BWD_CASES = [
    (2, 200, 200, 6, 2, 64, True, 0, "contiguous"),   # GQA, ragged tiles
    (2, 130, 130, 8, 2, 64, True, 0, "fused"),        # strided views
    (1, 300, 300, 4, 2, 80, True, 100, "contiguous"), # zamba2's window, D 80
    (2, 100, 333, 4, 4, 64, False, 0, "contiguous"),  # cross-attention
    (1, 150, 150, 4, 4, 192, True, 0, "contiguous"),  # MLA's D = 192
    (1, 96, 64, 2, 1, 256, True, 0, "contiguous"),    # D 256, Sq > Sk
    (1, 200, 64, 4, 4, 64, True, 32, "contiguous"),   # rows without a key
]


@pytest.mark.parametrize("dtype", MODEL_DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,layout",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain_version(cuda_device, b, sq, sk, h,
                                                kv, d, causal, window,
                                                layout, dtype):
    """The forward's lse against the plain log-sum-exp (1e-4), and the
    backward kernels against their plain version on the same q, k, v, out,
    dout and lse: f32 within 1e-4 of each output's largest value
    (summation order), bf16 within 1e-2 of it (each output rounded once
    from f32; an order difference can move a rounding by one step, 2^-8).
    Two runs give the same bits; through ``ops.flash_attention`` with
    autograd recording, both directions launch their kernels."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_ref,
        flash_attention_lse_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = _flash_inputs(g, cuda_device, dtype, b, sq, sk, h, kv, d,
                            layout)
    out, lse = flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    want_lse = flash_attention_lse_ref(q, k, causal, window)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    before = build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal, window)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal, window)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal, window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == before + 2
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.shape == w.shape and a.dtype == dtype, name
        assert torch.equal(a, a2), name
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), (name, err)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = (build.LAUNCHES["flash_attention"],
                build.LAUNCHES["flash_attention_bwd"])
    flash_attention(*leaves, causal, window).backward(dout)
    assert build.LAUNCHES["flash_attention"] == fwd + 1
    assert build.LAUNCHES["flash_attention_bwd"] == bwd + 1
    for name, leaf, a in zip(("dq", "dk", "dv"), leaves, got):
        assert torch.equal(leaf.grad, a), name


#: the bf16 backward's tensor-core kernels: (b, sq, sk, h, kv, d, causal,
#: window, layout), covering D padded to 64, 128 and 256, GQA groups 1, 3
#: and 5, the causal, window and full masks, Sq != Sk, ragged tiles and the
#: fused projection's strided views
FLASH_TC_CASES = [
    (2, 256, 256, 4, 4, 64, True, 0, "contiguous"),   # DP 64, group 1
    (1, 200, 200, 6, 2, 64, True, 0, "fused"),        # group 3, ragged, views
    (1, 333, 333, 10, 2, 128, True, 0, "contiguous"), # DP 128, group 5
    (2, 300, 300, 4, 4, 80, True, 100, "contiguous"), # window, D 80
    (2, 100, 333, 6, 2, 64, False, 0, "contiguous"),  # full, Sq < Sk
    (1, 333, 100, 4, 4, 64, True, 0, "contiguous"),   # causal, Sq > Sk
    (2, 130, 130, 8, 2, 128, True, 0, "fused"),       # DP 128, views
    (1, 150, 150, 5, 1, 192, True, 0, "contiguous"),  # DP 256, group 5
    (1, 96, 64, 3, 1, 256, True, 48, "contiguous"),   # DP 256, window
    (1, 1, 77, 4, 4, 64, False, 0, "contiguous"),     # one query row
    (2, 100, 100, 4, 2, 64, True, 0, "unaligned"),    # copied for TMA
    (2, 256, 256, 4, 4, 64, True, 0, "offset"),       # common q, k parts
    (1, 200, 200, 6, 2, 128, True, 0, "offset"),
    (1, 150, 150, 4, 2, 192, True, 0, "offset"),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,layout",
                         FLASH_TC_CASES)
def test_flash_bwd_tensor_cores_hold_the_autograd_rule(
        cuda_device, b, sq, sk, h, kv, d, causal, window, layout):
    """bf16 backward (wgmma + TMA) against autograd through the plain f32
    forward on f32 copies of the same inputs: each output's largest error
    at most twice that of autograd through the plain bf16 forward plus one
    bf16 step of its largest value (chip_smoke.py 13a's rule), and within
    1e-2 of that value against the plain backward; two calls give the same
    bits, one launch counted each, and a view that TMA cannot read is
    copied and counted."""
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(17)
    dtype = torch.bfloat16
    q, k, v = _flash_inputs(g, cuda_device, dtype, b, sq, sk, h, kv, d,
                            layout)
    out, lse = flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    launches = build.LAUNCHES["flash_attention_bwd"]
    copies = fa.BWD_COPIES["flash_attention_bwd"]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal, window)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                        window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == launches + 2
    unread = sum(not tma_readable(t) for t in (q, k, v, dout))
    assert unread == (3 if layout == "unaligned" else 0)
    assert fa.BWD_COPIES["flash_attention_bwd"] == copies + 2 * unread

    def grads(dt):
        leaves = [t.detach().to(dt).requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention_ref(*leaves, causal, window)
        return torch.autograd.grad(o, leaves, dout.to(dt))

    plain, ref = grads(dtype), grads(torch.float32)
    want = fa.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal, window)
    for name, a, a2, p, r, w in zip(("dq", "dk", "dv"), got, again, plain,
                                    ref, want):
        assert a.shape == r.shape and a.dtype == dtype, name
        assert torch.equal(a, a2), name
        top = r.abs().max().item()
        err = (a.float() - r).abs().max().item()
        perr = (p.float() - r).abs().max().item()
        assert err <= 2 * perr + 2 ** -8 * top, (name, err, perr, top)
        werr = (a.float() - w.float()).abs().max().item()
        assert werr <= 1e-2 * w.float().abs().max().item(), (name, werr)


def test_gather_launches_on_the_current_stream(cuda_device):
    """gather_rows_cuda called under a non-default stream: exact against
    its plain version (ids past either end give fill rows) once that
    stream is synchronised, one launch counted; an empty row list launches
    nothing."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (1000, 2945),
                                          dtype=np.int32)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(-5, 1005, 700).astype(np.int32)).to(
        cuda_device)
    want = gather.gather_rows_ref(table, rows, -1)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    before = build.LAUNCHES["gather_rows"]
    with torch.cuda.stream(side):
        got = gather.gather_rows_cuda(table, rows, -1)
        empty = gather.gather_rows_cuda(table, rows[:0], 7)
    side.synchronize()
    assert build.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(got, want)
    assert empty.shape == (0, 2945) and empty.dtype == torch.int32


def test_train_step_on_the_card_matches_cpu(cuda_device):
    """Reduced smollm-135m in f32, the same weights on the card and on the
    CPU: the loss and every gradient leaf agree (1e-4 relative RMS a leaf;
    TF32 off), both directions of both kernels launched on the card, and
    one step of ``make_train_step`` gives the same loss and weights (1e-4
    relative RMS a leaf; AdamW divides by sqrt(v), which amplifies a
    gradient's last bits where it is near zero)."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_batch
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["smollm-135m"].reduced()
    cpu = build_model(cfg, device="cpu", seed=0).float()
    card = copy.deepcopy(cpu).to(cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", seq_len=64, global_batch=2,
                                        kind="train"),
                       torch.Generator().manual_seed(2))

    def rel_rms(a, b):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    before = dict(build.LAUNCHES)
    loss_card = card.loss(batch)
    loss_card.backward()
    torch.cuda.synchronize()
    for name in ("rmsnorm", "rmsnorm_bwd"):
        assert build.LAUNCHES[name] - before[name] == 2 * cfg.n_layers + 1
    for name in ("flash_attention", "flash_attention_bwd"):
        assert build.LAUNCHES[name] - before[name] == cfg.n_layers
    loss_cpu = cpu.loss(batch)
    loss_cpu.backward()
    assert abs(loss_card.item() - loss_cpu.item()) <= 1e-5 * loss_cpu.item()
    for (name, pc), pk in zip(cpu.named_parameters(), card.parameters()):
        assert rel_rms(pk.grad, pc.grad) <= 1e-4, name

    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    results = []
    for model in (cpu, card):
        model.zero_grad(set_to_none=True)
        step = make_train_step(model, opt)
        state = init_opt_state(dict(model.named_parameters()))
        state, metrics = step(state, batch)
        results.append((metrics, model))
    (m_cpu, cpu), (m_card, card) = results
    assert int(m_card["skipped"]) == 0
    assert abs(m_card["loss"].item() - m_cpu["loss"].item()) <= 1e-5 * abs(
        m_cpu["loss"].item())
    for (name, pc), pk in zip(cpu.named_parameters(), card.parameters()):
        assert rel_rms(pk, pc) <= 1e-4, name
