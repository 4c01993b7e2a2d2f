"""The port's level-1 binning (``bin_rows`` through the kernel routes'
plain versions, and the level-1 saturation flag) against the JAX
package's, on the same numpy inputs. Outputs are integers and booleans:
tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels import aggregate as jk_agg
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import aggregate as tk_agg

from test_torch_kernels import _fake_codes, _t


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
