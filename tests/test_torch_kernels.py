"""The port's kernel modules vs the JAX package's Pallas kernels.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors) is
held against the JAX Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, on the same numpy inputs. Outputs are
integers and booleans: tolerance 0. The CUDA kernels themselves run only on
the card: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import graph as JG
from repro.kernels import aggregate as jk_agg
from repro.kernels.canonical_check.canonical_check import (
    canonical_check_pallas,
    expand_canonical_pallas,
)
from repro.kernels.compact import stream_compact_pallas
from repro_torch.core import aggregation as tagg
from repro_torch.core import graph as TG
from repro_torch.kernels import aggregate as tk_agg
from repro_torch.kernels import compact as tk_compact
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda,
    canonical_check_ref,
    expand_canonical_cuda,
)


def _graphs(seed=0, n=60, m=150):
    g = JG.random_labeled(n, m, n_labels=2, seed=seed)
    return JG.to_device(g), TG.to_device(
        TG.Graph(n=g.n, labels=g.labels, edges=g.edges), "cpu"
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _members(rng, b, k, n, allow_empty=True):
    """Rows of distinct vertices with n_valid in [0 or 1, k]; pad -1."""
    members = np.full((b, k), -1, np.int32)
    n_valid = rng.integers(0 if allow_empty else 1, k + 1, b).astype(np.int32)
    for i in range(b):
        members[i, : n_valid[i]] = rng.choice(n, size=n_valid[i], replace=False)
    return members, n_valid


def _fake_codes(rng, b, nv=3, n_labels=4, high_labels=False):
    """Synthetic quick codes honouring the encoding (words < 2^32);
    ``high_labels`` puts label bytes >= 128 in both label words."""
    bits = rng.integers(0, 1 << 3, b).astype(np.int64)
    w0 = nv | (bits << 4)
    lo = 128 if high_labels else 0
    w1 = np.zeros(b, np.int64)
    w2 = np.zeros(b, np.int64)
    for i in range(4):
        w1 |= rng.integers(lo, lo + n_labels, b).astype(np.int64) << (8 * i)
        if high_labels:
            w2 |= rng.integers(lo, lo + n_labels, b).astype(np.int64) << (8 * i)
    return np.stack([w0, w1, w2], axis=1)


# ---------------------------------------------------------------------------
# canonical_check / expand_canonical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k", [(0, 3), (1, 3), (257, 3), (600, 5)])
def test_canonical_check_plain_matches_pallas(b, k):
    jdg, tdg = _graphs(seed=b)
    rng = np.random.default_rng(b + k)
    members, n_valid = _members(rng, b, k, jdg.n)
    cand = rng.integers(-1, jdg.n, b).astype(np.int32)
    want = canonical_check_pallas(
        jnp.asarray(members.reshape(b, k)), jnp.asarray(n_valid),
        jnp.asarray(cand), jdg.adj_bits, block_b=64, interpret=True,
    )
    got = canonical_check_cuda(_t(members), _t(n_valid), _t(cand),
                               tdg.adj_bits)
    assert got.dtype == torch.bool and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        canonical_check_ref(_t(members), _t(n_valid), _t(cand),
                            tdg.adj_bits).numpy(),
        np.asarray(want),
    )


@pytest.mark.parametrize("c,k", [(0, 2), (1, 1), (13, 2), (33, 3)])
def test_expand_canonical_plain_matches_pallas(c, k):
    jdg, tdg = _graphs(seed=c + 1)
    rng = np.random.default_rng(c * 7 + k)
    members, n_valid = _members(rng, c, k, jdg.n)
    want = expand_canonical_pallas(
        jnp.asarray(members.reshape(c, k)), jnp.asarray(n_valid), jdg.nbr,
        jdg.adj_bits, block_c=8, interpret=True,
    )
    got = expand_canonical_cuda(_t(members), _t(n_valid), tdg.nbr,
                                tdg.adj_bits)
    for g_, w_, name in zip(got, want, ("cand", "valid", "keep")):
        assert g_.shape == (c, k, tdg.max_degree), name
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# stream_compact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [0, 1, 5, 1000])
@pytest.mark.parametrize("out_cap", [1, 64, 2048])
def test_stream_compact_plain_matches_pallas(b, out_cap):
    rng = np.random.default_rng(b + out_cap)
    keep = rng.random(b) < 0.3
    idx_k, cnt_k = stream_compact_pallas(jnp.asarray(keep), out_cap,
                                         block=64, interpret=True)
    idx_t, cnt_t = tk_compact.stream_compact_cuda(_t(keep), out_cap)
    # the count is the UNCLAMPED kept total, a 0-d int32 on the device
    assert cnt_t.shape == () and cnt_t.dtype == torch.int32
    assert int(cnt_t) == int(cnt_k) == int(keep.sum())
    assert idx_t.dtype == torch.int32 and idx_t.shape == (out_cap,)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_k))


# ---------------------------------------------------------------------------
# seg_unique + bin_rows
# ---------------------------------------------------------------------------

def _sorted_flags(codes, valid):
    sc, sv, _ = jk_agg.sort_codes(jnp.asarray(codes), jnp.asarray(valid))
    new = sv & jnp.concatenate(
        [jnp.ones((1,), bool), (sc[1:] != sc[:-1]).any(axis=1)]
    )
    return np.asarray(new), np.asarray(sv)


@pytest.mark.parametrize("b", [1, 5, 127, 1000])
@pytest.mark.parametrize("cap", [8, 2048])
def test_seg_unique_plain_matches_pallas(b, cap):
    rng = np.random.default_rng(b + cap)
    new, sv = _sorted_flags(_fake_codes(rng, b), rng.random(b) < 0.8)
    want = jk_agg.seg_unique_pallas(jnp.asarray(new), jnp.asarray(sv), cap,
                                    block=64, interpret=True)
    got = tk_agg.seg_unique_cuda(_t(new), _t(sv), cap)
    for g_, w_, name in zip(got, want, ("src", "counts", "slot", "n")):
        assert g_.dtype == torch.int32, name
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)


def test_seg_unique_empty():
    src, counts, slot, n = tk_agg.seg_unique_cuda(
        torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.bool), 8
    )
    assert int(n) == 0 and slot.shape == (0,) and src.shape == (8,)
    assert not counts.any()


def _bin_both(codes, valid, cap, weights=None, use_kernel=True):
    want = jk_agg.bin_rows(
        jnp.asarray(codes), jnp.asarray(valid), cap,
        None if weights is None else jnp.asarray(weights),
        use_kernel=use_kernel, interpret=True,
    )
    got = tk_agg.bin_rows(
        _t(codes), _t(valid), cap, None if weights is None else _t(weights),
        use_kernel=use_kernel,
    )
    for g_, w_, name in zip(got, want, ("uniq", "counts", "inv", "n",
                                         "uvalid")):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("high_labels", [False, True])
def test_bin_rows_matches_reference(use_kernel, high_labels):
    rng = np.random.default_rng(3)
    codes = _fake_codes(rng, 700, n_labels=3, high_labels=high_labels)
    valid = rng.random(700) < 0.9
    _bin_both(codes, valid, 1024, use_kernel=use_kernel)


def test_bin_rows_overflow_count_unclamped():
    rng = np.random.default_rng(1)
    codes = _fake_codes(rng, 400, n_labels=4)
    valid = np.ones(400, bool)
    _, _, inv, n, _ = _bin_both(codes, valid, 16)
    assert int(n) > 16 and int(inv.max()) == int(n) - 1


def test_bin_rows_weighted_fold_past_int32():
    rng = np.random.default_rng(2)
    codes = _fake_codes(rng, 300, n_labels=2)
    valid = rng.random(300) < 0.95
    weights = rng.integers(2**30, 2**31 - 1, 300).astype(np.int64)
    _, counts, _, _, _ = _bin_both(codes, valid, 512, weights=weights)
    assert int(counts.max()) > 2**31


def test_bin_rows_empty_and_single_slot():
    _bin_both(np.zeros((0, 3), np.int64), np.zeros(0, bool), 4)
    codes = np.tile(np.array([[3 | (7 << 4), 5, 0]], np.int64), (9, 1))
    _, counts, _, n, _ = _bin_both(codes, np.ones(9, bool), 1)
    assert int(n) == 1 and int(counts[0]) == 9


def test_level1_saturation_flag_matches_reference():
    """An int32 partial at the I32_SAT sentinel makes finish() refuse (the
    step then re-folds wide), in both packages."""
    codes = np.array([[3 | (7 << 4), 5, 0], [3 | (3 << 4), 1, 0]], np.int64)
    counts = np.array([jk_agg.I32_SAT, 4], np.int32)
    assert tk_agg.I32_SAT == jk_agg.I32_SAT
    for sat in (False, True):
        c = counts if sat else np.array([6, 4], np.int32)
        jl = jagg.DeviceLevel1(merge_cap=4)
        tl = tagg.DeviceLevel1(merge_cap=4)
        for _ in range(2):
            jl.fold_partial(jnp.asarray(codes), jnp.asarray(c),
                            jnp.asarray(2, jnp.int32), 2, 2)
            tl.fold_partial(_t(codes), _t(c), torch.tensor(2, dtype=torch.int32),
                            2, 2)
        jr, tr = jl.finish(), tl.finish()
        assert (jr is None) == (tr is None) == sat
        if not sat:
            for a, b in zip(tr, jr):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pack_codes_round_trip():
    rng = np.random.default_rng(5)
    codes = _fake_codes(rng, 50, high_labels=True)
    packed = tk_agg.pack_codes_u32(_t(codes))
    np.testing.assert_array_equal(tk_agg.unpack_codes_u32(packed), codes)
    np.testing.assert_array_equal(
        tk_agg.unpack_codes_u32(packed),
        jk_agg.unpack_codes_u32(np.asarray(jk_agg.pack_codes_u32(
            jnp.asarray(codes)))),
    )
