"""The port's radix level-1 bin vs the JAX package's.

``radix_sort_codes_ref`` (what the radix wrapper runs for CPU tensors) is
held against the JAX Pallas radix sort in interpret mode, and
``bin_rows(method="radix")`` — kernel knob on (the radix sort) and off (the
fused int64 key) — against the JAX radix bin and the port's own sort bin,
on the same numpy inputs. Outputs are integers and booleans: tolerance 0.
The CUDA passes run only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64, as the package does)
from repro.kernels import radix_bin as jradix
from repro.kernels.aggregate import bin_rows as jbin_rows
from repro_torch.kernels import aggregate as tk_agg
from repro_torch.kernels import radix_bin as tradix
from torch_parity import assert_same_arrays


def _codes(rng, b, label_bytes=3, n_labels=200):
    """Quick-code rows honouring the encoding (every word < 2^32), with
    labels in the high bytes of both label words so every pass varies."""
    w0 = 3 | (rng.integers(0, 8, b).astype(np.int64) << 4)
    w1 = np.zeros(b, np.int64)
    w2 = np.zeros(b, np.int64)
    for i in range(label_bytes):
        w1 |= rng.integers(0, n_labels, b).astype(np.int64) << (8 * i)
        w2 |= rng.integers(0, 2, b).astype(np.int64) << (8 * (3 - i))
    return np.stack([w0, w1, w2], axis=1)


def _jradix(codes, valid):
    return jradix.radix_sort_codes(jnp.asarray(codes), jnp.asarray(valid),
                                   block=16, interpret=True)


def test_radix_sort_single_row_matches_reference():
    codes = np.array([[3 | (5 << 4), 0x01020304, 7]], np.int64)
    for valid in (np.ones(1, bool), np.zeros(1, bool)):
        port = tradix.radix_sort_codes(torch.from_numpy(codes),
                                       torch.from_numpy(valid))
        assert_same_arrays(port, _jradix(codes, valid))


@pytest.mark.parametrize("case", ["random", "all_invalid", "constant_digit"])
def test_radix_sort_matches_reference(case):
    """One batch shape (one compile of the reference) for three inputs:
    mixed validity with every pass varying, all rows invalid, and a digit
    that is constant over the batch (w2 all zero, w1's low byte fixed)."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, 200)
    valid = rng.random(200) < 0.8
    if case == "all_invalid":
        valid[:] = False
    if case == "constant_digit":
        codes[:, 2] = 0
        codes[:, 1] = (codes[:, 1] & ~0xFF) | 0x2A
    port = tradix.radix_sort_codes(torch.from_numpy(codes),
                                   torch.from_numpy(valid))
    assert_same_arrays(port, _jradix(codes, valid))
    # the order is the stable sort by (invalid, w0, w1, w2)
    want = np.lexsort((np.arange(200), codes[:, 2], codes[:, 1], codes[:, 0],
                       ~valid))
    np.testing.assert_array_equal(port[2].numpy(), want)


def test_radix_pass_pieces_and_empty_batch():
    """The plain versions of the two kernels' pieces: the vary mask, the
    digit histogram layout, and one stable pass; an empty batch sorts to
    an empty order."""
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(_codes(rng, 300))
    valid = torch.from_numpy(rng.random(300) < 0.5)
    codes[:, 2] = 0
    vary = tradix.digit_vary_ref(codes, valid)
    assert vary[2] == 0 and vary[3] == 1 and (vary[1] & 0xFF) != 0
    order = torch.from_numpy(rng.permutation(300).astype(np.int32))
    hist, totals = tradix.radix_hist_ref(codes, valid, order, 1, 8, tile=64)
    d = ((codes[:, 1][order.long()] >> 8) & 0xFF).numpy()
    assert hist.shape == (256 * 5,) and int(totals.sum()) == 300
    np.testing.assert_array_equal(totals.numpy(), np.bincount(d, minlength=256))
    h = hist.reshape(256, 5).numpy()
    for blk in range(5):
        seen = np.bincount(d[: blk * 64], minlength=256)
        np.testing.assert_array_equal(h[:, blk], seen)
    out = tradix.radix_scatter_ref(codes, valid, order, 1, 8)
    np.testing.assert_array_equal(out.numpy(),
                                  order.numpy()[np.argsort(d, kind="stable")])
    empty = tradix.radix_sort_codes(codes[:0], valid[:0])
    assert [t.shape[0] for t in empty] == [0, 0, 0]
    assert empty[2].dtype == torch.int32


def _wide(rng, b, bits):
    """Rows whose three words use exactly ``bits`` bits each."""
    return np.stack([
        rng.integers(0, 1 << n, b).astype(np.int64) | (1 << (n - 1))
        for n in bits
    ], axis=1)


@pytest.mark.parametrize("case", ["plain", "weighted", "63_bits", "wide"])
def test_radix_bin_matches_reference_and_sort_bin(case):
    """Kernel knob on and off against the JAX radix bin (its fused-key
    route) and the port's sort bin, with and without overflow past
    ``cap``. ``63_bits`` fits the reference's 63-bit key but not the
    port's 62-bit one; ``wide`` fits neither: both take the sort bin."""
    rng = np.random.default_rng(11)
    b = 240
    codes = {"63_bits": lambda: _wide(rng, b, (21, 21, 21)),
             "wide": lambda: _wide(rng, b, (31, 31, 30))}.get(
        case, lambda: _codes(rng, b))()
    valid = rng.random(b) < 0.85
    weights = (rng.integers(1, 9, b).astype(np.int64)
               if case == "weighted" else None)
    tw = None if weights is None else torch.from_numpy(weights)
    for cap in (16, 256):
        ref = jbin_rows(jnp.asarray(codes), jnp.asarray(valid), cap,
                        None if weights is None else jnp.asarray(weights),
                        method="radix")
        sort = tk_agg.bin_rows(torch.from_numpy(codes),
                               torch.from_numpy(valid), cap, tw)
        for use_kernel in (False, True):
            port = tk_agg.bin_rows(torch.from_numpy(codes),
                                   torch.from_numpy(valid), cap, tw,
                                   use_kernel=use_kernel, method="radix")
            assert_same_arrays(port, ref)
            for a, s in zip(port, sort):
                assert a.dtype == s.dtype and torch.equal(a, s)
    fits = tradix._fused_keys(torch.from_numpy(codes),
                              torch.from_numpy(valid))[2]
    assert bool(fits) == (case in ("plain", "weighted"))


def test_unknown_bin_method_raises():
    codes = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="aggregate_bin"):
        tk_agg.bin_rows(codes, torch.ones(4, dtype=torch.bool), 4,
                        method="bucket")
