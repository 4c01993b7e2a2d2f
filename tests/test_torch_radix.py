"""The port's radix level-1 bin vs the JAX package's.

``radix_sort_codes`` (on CPU tensors: the kernels' plain versions over
the kernels' buffers), the same plain pieces composed pass by pass, and
the whole-sort oracle ``radix_sort_codes_ref`` are held against the JAX
Pallas radix sort in interpret mode, and ``bin_rows(method="radix")`` —
kernel knob on (the radix sort) and off (the fused int64 key) — against
the JAX radix bin and the port's own sort bin, on the same numpy inputs.
Outputs are integers and booleans: tolerance 0. The CUDA kernels run only
on the card (``tests/test_torch_cuda.py``).
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


def _composed(codes, valid):
    """The sort from the plain pieces alone: the plan of varying passes,
    then one stable pass each over keys carried while the word stays the
    same and gathered through the order when it changes."""
    plan, _, _ = tradix.radix_digit_counts_ref(codes, valid)
    order = torch.arange(codes.shape[0], dtype=torch.int32)
    keys, word = None, None
    for p in plan[1:1 + int(plan[0])].tolist():
        w, shift = tradix._PASSES[p]
        if w != word:
            keys, word = tradix._word(codes, valid, w)[order.long()], w
        keys, order = tradix.radix_pass_ref(keys, order, shift)
    return codes[order], valid[order], order


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
    tc, tv = torch.from_numpy(codes), torch.from_numpy(valid)
    port = tradix.radix_sort_codes(tc, tv)
    ref = _jradix(codes, valid)
    assert_same_arrays(port, ref)
    for other in (_composed(tc, tv), tradix.radix_sort_codes_ref(tc, tv)):
        assert_same_arrays(other, ref)
    # the order is the stable sort by (invalid, w0, w1, w2)
    want = np.lexsort((np.arange(200), codes[:, 2], codes[:, 1], codes[:, 0],
                       ~valid))
    np.testing.assert_array_equal(port[2].numpy(), want)


def test_radix_pass_pieces_and_empty_batch():
    """The plain versions of the two kernels: the digit counts, bases and
    plan of the histogram, and one stable pass over carried keys; an empty
    batch sorts to an empty order."""
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(_codes(rng, 300))
    valid = torch.from_numpy(rng.random(300) < 0.5)
    codes[:, 2] = 0
    plan, counts, bases = tradix.radix_digit_counts_ref(codes, valid)
    assert plan.dtype == counts.dtype == bases.dtype == torch.int32
    assert counts.shape == bases.shape == (13, 256)
    for p, (word, shift) in enumerate(tradix._PASSES):
        src = ((~valid).long() if word == 3 else codes[:, word])
        d = ((src >> shift) & 0xFF).numpy()
        want = np.bincount(d, minlength=256)
        np.testing.assert_array_equal(counts[p].numpy(), want)
        np.testing.assert_array_equal(bases[p].numpy(),
                                      np.cumsum(want) - want)
    # w2 is constant: its four passes are left out of the plan
    varying = [p for p in range(13) if counts[p].max() < 300]
    assert not {0, 1, 2, 3} & set(varying) and 12 in varying
    assert plan.tolist() == [len(varying)] + varying + [-1] * (
        13 - len(varying))
    keys = torch.from_numpy(rng.integers(0, 2**32, 300).astype(np.int64))
    order = torch.from_numpy(rng.permutation(300).astype(np.int32))
    k2, o2 = tradix.radix_pass_ref(keys, order, 8)
    perm = np.argsort((keys.numpy() >> 8) & 0xFF, kind="stable")
    np.testing.assert_array_equal(k2.numpy(), keys.numpy()[perm])
    np.testing.assert_array_equal(o2.numpy(), order.numpy()[perm])
    empty = tradix.radix_sort_codes(codes[:0], valid[:0])
    assert [t.shape[0] for t in empty] == [0, 0, 0]
    assert empty[2].dtype == torch.int32


@pytest.mark.parametrize("case", ["none_vary", "flag_only", "bit_31",
                                  "word_after_skip"])
def test_radix_launches_follow_the_plan(case):
    """The 13 launches over the kernels' buffers (CPU tensors: their plain
    versions) on plans the code cases above do not reach: no pass varies
    (launch 0 writes the identity), only the invalid flag varies, words
    with bit 31 set, and a word whose low byte is constant and whose high
    bytes vary (its first pass gathers after a skipped one). Twice on the
    same buffers, against the oracle and the lexicographic order."""
    rng = np.random.default_rng(7)
    b = 129
    codes = np.tile(np.array([[3, 5, 9]], np.int64), (b, 1))
    valid = np.ones(b, bool)
    if case == "flag_only":
        valid = rng.random(b) < 0.5
    elif case == "bit_31":
        codes[:, 1] = rng.integers(2**31, 2**32, b)
        codes[:, 2] = rng.integers(0, 2**32, b)
        valid = rng.random(b) < 0.9
    elif case == "word_after_skip":
        codes[:, 1] = (rng.integers(0, 4, b) << 16
                       | rng.integers(0, 4, b) << 8 | 0x2A)
        codes[:, 0] = rng.integers(0, 3, b) << 24 | 3
        valid = rng.random(b) < 0.8
    tc, tv = torch.from_numpy(codes), torch.from_numpy(valid)
    st = tradix.RadixScratch(b, "cpu")
    want = tradix.radix_sort_codes_ref(tc, tv)[2]
    lex = np.lexsort((np.arange(b), codes[:, 2] & 0xFFFFFFFF,
                      codes[:, 1] & 0xFFFFFFFF, codes[:, 0], ~valid))
    for _ in range(2):
        sc, sv, order = tradix.radix_sort_into(tc, tv, st)
        assert torch.equal(order, want)
        np.testing.assert_array_equal(order.numpy(), lex)
        assert torch.equal(sc, tc[want]) and torch.equal(sv, tv[want])
    nvary = int(st.plan[0])
    assert nvary == {"none_vary": 0, "flag_only": 1, "bit_31": 9,
                     "word_after_skip": 4}[case]


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
