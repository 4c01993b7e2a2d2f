"""Radix level-1 binning (``bin_rows`` without a comparison sort), port of
``repro.kernels.radix_bin``.

Two routes with ``aggregate.bin_rows``'s exact contract:

* :func:`radix_sort_codes` — a stable LSB radix sort of the (B, 3) code
  rows, one 8-bit digit per pass (w2, w1, w0, then the invalid flag, least
  significant first, :data:`_PASSES`). It is 1 + 13 launches of the two
  hand-written kernels of ``csrc/radix_sort.cu``: :func:`radix_hist_cuda`
  counts the digits of all 13 passes in one read of the rows and writes
  the plan (the passes whose digit varies) and each pass's digit bases;
  :func:`radix_scatter_cuda` launch ``i`` then runs the plan's ``i``-th
  pass over carried keys, and returns at once past the plan's count, so
  the host never reads the device. On a CPU tensor each launch is its
  plain version (:func:`radix_digit_counts_ref`, :func:`radix_pass_ref`)
  over the same buffers. :func:`radix_sort_codes_ref` is the whole-sort
  oracle (one stable sort per pass). :func:`bin_rows_radix` then finds
  segments as the sort bin does.

* the fused-key route (``use_kernel=False``): the three code words are
  fused into ONE int64 key at their measured bit widths, sorted
  payload-free, and slots and counts are recovered by gathers. Where the
  reference uses a uint64 key and the sentinel 2^64 - 1 for invalid rows,
  the port (no unsigned 64-bit shifts in PyTorch) uses int64 and the
  sentinel 2^63 - 1, so a key may use at most 62 bits (:data:`FUSED_BITS`);
  wider words take the sort bin, whose outputs are identical. Both arms are
  evaluated and the result selected on the device, in place of the
  reference's ``lax.cond``, and the reference's ``nonzero(size=...)`` is a
  cumsum-and-scatter through a dump slot: the route never reads the
  device from the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

#: digit width of one radix pass.
RADIX_BITS = 8
NDIGITS = 1 << RADIX_BITS

#: (word index, shift) per pass, least-significant digit first; word index
#: 3 is the synthesized invalid flag that pushes invalid rows last.
_PASSES = (
    (2, 0), (2, 8), (2, 16), (2, 24),
    (1, 0), (1, 8), (1, 16), (1, 24),
    (0, 0), (0, 8), (0, 16), (0, 24),
    (3, 0),
)
NPASSES = len(_PASSES)

#: the fused key of an invalid row: above every key of <= FUSED_BITS bits.
_SENTINEL = 2**63 - 1
FUSED_BITS = 62

INT32_MAX = 2**31 - 1
#: rows per tile of the pass kernel (``kTileRows`` in
#: ``csrc/radix_sort.cu``): one look-back status word per digit a tile.
RADIX_TILE = 4096
#: 8-byte words of the scratch header (``kHeaderWords``): the digit counts,
#: the histogram's finish counter and one tile counter per launch.
_HEADER_WORDS = 2048


def _word(codes, valid, word: int):
    """Word ``word`` of every row as int64 in [0, 2^32): the low 32 bits of
    code word 0-2, or 3, the invalid flag."""
    if word == 3:
        return (~valid).to(torch.int64)
    return codes[:, word] & 0xFFFFFFFF


def _pass_digits(codes, valid, order, word: int, shift: int):
    """The pass's 8-bit digit of each row of ``order`` (int64)."""
    return (_word(codes, valid, word)[order.to(torch.int64)] >> shift) & 0xFF


def radix_digit_counts_ref(codes, valid):
    """Plain version of the histogram kernel: ``(plan, counts, bases)``.

    ``counts`` (13, 256) int32: the rows of each digit of each pass of
    :data:`_PASSES`; ``bases`` (13, 256) int32: their exclusive prefix
    over the digits; ``plan`` (14,) int32: the number of passes whose
    digit is not the same for every row, then their pass indices in
    :data:`_PASSES` order, then -1. Computed without a host read."""
    b = codes.shape[0]
    dev = codes.device
    counts = torch.zeros((NPASSES, NDIGITS), dtype=torch.int32, device=dev)
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    for p, (word, shift) in enumerate(_PASSES):
        counts[p].index_add_(0, (_word(codes, valid, word) >> shift) & 0xFF,
                             ones)
    bases = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    vary = (counts != b).all(1)
    nvary = vary.sum(dtype=torch.int32)
    ids = torch.argsort((~vary).to(torch.int8), stable=True).to(torch.int32)
    pos = torch.arange(NPASSES, device=dev)
    plan = torch.cat([nvary.reshape(1), torch.where(pos < nvary, ids, -1)])
    return plan.to(torch.int32), counts, bases


def radix_pass_ref(keys, order, shift: int):
    """Plain version of one pass of the scatter kernel over carried keys:
    ``(keys, order)`` stably re-sorted by the digit
    ``(keys >> shift) & 0xFF`` (``keys`` int64 in [0, 2^32))."""
    perm = torch.sort((keys >> shift) & 0xFF, stable=True).indices
    return keys[perm], order[perm]


class RadixScratch:
    """The buffers of one sort of ``b`` rows on ``device``: the plan and
    the digit bases, the order and the carried keys in two ping-pong
    buffers each, the outputs (the order, and codes and valid in it) and,
    on the card, the three code words as int32 arrays (the histogram
    writes them, so that a pass that starts a word gathers 4 bytes a row,
    not a sector of the (B, 3) int64 table) and the kernels' scratch (the
    digit counts, the counters, the tiles' look-back status words). A sort
    clears what it needs, so the same buffers serve sort after sort of the
    same batch."""

    def __init__(self, b: int, device):
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        self.b = b
        self.plan = torch.empty((1 + NPASSES,), **i32)
        self.bases = torch.empty((NPASSES, NDIGITS), **i32)
        self.orders = [torch.empty((b,), **i32) for _ in range(2)]
        self.keys = [torch.empty((b,), **i32) for _ in range(2)]
        self.out = torch.empty((b,), **i32)
        self.codes_out = torch.empty((b, 3), dtype=torch.int64, device=dev)
        self.valid_out = torch.empty((b,), dtype=torch.bool, device=dev)
        if dev.type == "cuda":
            self.words = torch.empty((3, b), **i32)
            tiles = -(-b // RADIX_TILE)
            self.scratch = torch.empty((_HEADER_WORDS + tiles * NDIGITS,),
                                       dtype=torch.int64, device=dev)
            self.counts = self.scratch.view(torch.int32)[
                :NPASSES * NDIGITS].view(NPASSES, NDIGITS)
        else:
            self.words = self.scratch = None
            self.counts = torch.empty((NPASSES, NDIGITS), **i32)

    def ptrs(self):
        """The device pointers of the buffers, in the C entries' order."""
        return (self.words.data_ptr(), self.scratch.data_ptr(),
                self.plan.data_ptr(), self.bases.data_ptr())


def _check_rows(codes, valid, st):
    dev = codes.device
    if codes.dtype != torch.int64 or codes.dim() != 2 or codes.shape[1] != 3:
        raise TypeError(f"codes: expected (B, 3) int64, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    b = codes.shape[0]
    if (valid.dtype != torch.bool or valid.shape != (b,)
            or valid.device != dev):
        raise TypeError(f"valid: expected ({b},) bool on {dev}")
    if not (codes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("codes and valid must be contiguous")
    if st.b != b or st.plan.device != dev:
        raise ValueError(f"scratch for {st.b} rows on {st.plan.device}, "
                         f"batch of {b} on {dev}")
    if b > INT32_MAX:
        raise ValueError(f"batch {b} exceeds int32 row indices")


def radix_hist_cuda(codes, valid, st: RadixScratch):
    """The histogram kernel of ``csrc/radix_sort.cu``: one read of
    ``codes`` and ``valid`` writes ``st.plan``, ``st.counts`` and
    ``st.bases`` (:func:`radix_digit_counts_ref`'s contract) and the
    structure-of-arrays words, and clears the passes' scratch."""
    if not on_cuda(codes):
        plan, counts, bases = radix_digit_counts_ref(codes, valid)
        st.plan.copy_(plan)
        st.counts.copy_(counts)
        st.bases.copy_(bases)
        return
    _check_rows(codes, valid, st)
    build.launch("radix_hist", build.library().repro_radix_hist,
                 codes.get_device(), codes.data_ptr(), valid.data_ptr(),
                 st.b, *st.ptrs())


def _pass_plain(codes, valid, st: RadixScratch, i: int):
    """Plain version of launch ``i`` of the scatter kernel, over the same
    buffers (the plan is read on the host: CPU tensors only)."""
    plan = st.plan.tolist()
    nvary = plan[0]
    if i >= nvary:
        if i == 0:
            st.out.copy_(torch.arange(st.b, dtype=torch.int32))
            st.codes_out.copy_(codes)
            st.valid_out.copy_(valid)
        return
    word, shift = _PASSES[plan[1 + i]]
    order = (torch.arange(st.b, dtype=torch.int32) if i == 0
             else st.orders[i & 1])
    if i == 0 or _PASSES[plan[i]][0] != word:
        keys = _word(codes, valid, word)[order.to(torch.int64)]
    else:
        keys = st.keys[i & 1].to(torch.int64) & 0xFFFFFFFF
    keys, order = radix_pass_ref(keys, order, shift)
    if i == nvary - 1:
        st.out.copy_(order)
        st.codes_out.copy_(codes[order])
        st.valid_out.copy_(valid[order])
        return
    st.orders[(i + 1) & 1].copy_(order)
    if _PASSES[plan[2 + i]][0] == word:
        st.keys[(i + 1) & 1].copy_(keys.to(torch.int32))


def radix_scatter_cuda(codes, valid, st: RadixScratch, i: int):
    """Launch ``i`` (0-12) of the scatter kernel of ``csrc/radix_sort.cu``,
    after :func:`radix_hist_cuda` on ``st``: the plan's ``i``-th pass reads
    the order and the carried keys of ``st.orders[i & 1]`` and
    ``st.keys[i & 1]`` (the rows in place for ``i == 0``), and writes them
    stably re-sorted by its digit (:func:`radix_pass_ref`) to
    ``st.orders[(i + 1) & 1]`` and ``st.keys[(i + 1) & 1]``, the keys only
    when the next pass sorts by the same word. The last
    varying pass writes the sort's outputs instead: ``st.out``, and
    ``st.codes_out`` and ``st.valid_out``, the rows gathered in that
    order. Past the plan's count it writes nothing (launch 0 writes the
    identity outputs when no pass varies)."""
    if not on_cuda(codes):
        _pass_plain(codes, valid, st, i)
        return
    _check_rows(codes, valid, st)
    words, scratch, plan, bases = st.ptrs()
    build.launch("radix_scatter", build.library().repro_radix_scatter,
                 codes.get_device(), i, codes.data_ptr(),
                 valid.data_ptr(), st.b, words, scratch, plan, bases,
                 st.orders[0].data_ptr(), st.orders[1].data_ptr(),
                 st.keys[0].data_ptr(), st.keys[1].data_ptr(),
                 st.out.data_ptr(), st.codes_out.data_ptr(),
                 st.valid_out.data_ptr())


def radix_sort_into(codes, valid, st: RadixScratch):
    """The sort into ``st``'s outputs: the histogram, then all 13 launches
    of the scatter kernel (passes that do not vary return at once).
    Returns (sorted codes, sorted valid, order)."""
    radix_hist_cuda(codes, valid, st)
    for i in range(NPASSES):
        radix_scatter_cuda(codes, valid, st, i)
    return st.codes_out, st.valid_out, st.out


def radix_sort_codes_ref(codes, valid):
    """The whole-sort oracle of :func:`radix_sort_codes`: the same passes,
    each a stable sort of the pass's digits of every row. A pass over a
    constant digit is the identity, so none is skipped."""
    order = torch.arange(codes.shape[0], dtype=torch.int32,
                         device=codes.device)
    for word, shift in _PASSES:
        d = _pass_digits(codes, valid, order, word, shift)
        order = order[torch.sort(d, stable=True).indices]
    return codes[order], valid[order], order


def radix_sort_codes(codes, valid):
    """Stable LSB-radix sort of (B, 3) quick-code rows, invalid rows last.

    Same contract as ``aggregate.sort_codes``, and the order is exactly the
    stable sort by (invalid, w0, w1, w2): returns (sorted codes, sorted
    valid, order int32). A CUDA tensor runs the kernels (1 + 13 launches)
    and never reads the device from the host; a CPU tensor runs their
    plain versions over the same buffers."""
    b = codes.shape[0]
    if b == 0:
        return codes, valid, torch.zeros((0,), dtype=torch.int32,
                                         device=codes.device)
    codes, valid = codes.contiguous(), valid.contiguous()
    return radix_sort_into(codes, valid, RadixScratch(b, codes.device))


# ---------------------------------------------------------------------------
# The fused single-key route
# ---------------------------------------------------------------------------

def _bit_width(m):
    """Bits needed for the non-negative 0-d int64 ``m`` (0 for 0), on the
    device: the count of powers of two at or below it."""
    pow2 = torch.ones((63,), dtype=torch.int64, device=m.device) << torch.arange(
        63, device=m.device)
    return (m >= pow2).sum()


def _fused_keys(codes, valid):
    """Reduce (B, 3) code words to ONE int64 sort key at their measured bit
    widths. Returns (key, widths (b1, b2), fits) — ``fits`` is the 0-d
    device flag that the three words share :data:`FUSED_BITS` bits, so
    every valid key stays below the invalid sentinel."""
    def width(w):
        return _bit_width(w.masked_fill(~valid, 0).max())

    c0, c1, c2 = codes[:, 0], codes[:, 1], codes[:, 2]
    b0, b1, b2 = width(c0), width(c1), width(c2)
    fits = (b0 + b1 + b2) <= FUSED_BITS
    # shifts past 63 happen only when ``fits`` is false; that arm is
    # discarded
    key = (((c0 << b1) | c1) << b2) | c2
    key = torch.where(valid, key, _SENTINEL)
    return key, (b1, b2), fits


def _bin_fused(codes, valid, cap: int, weights, key, widths):
    """Bucket-partition bin over the fused single-word key: one
    payload-free sort, then slots/counts recovered by gathers alone."""
    b = codes.shape[0]
    dev = codes.device
    b1, b2 = widths
    skey = torch.sort(key).values
    boundary = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          skey[1:] != skey[:-1]])
    svalid = skey != _SENTINEL
    newv = boundary & svalid
    incl = torch.cumsum(newv.to(torch.int32), 0, dtype=torch.int32)
    n = incl[-1]
    # dense rank of every sorted position's distinct key (unclamped)
    rank = incl - 1
    # first-occurrence positions of the first cap + 1 distinct keys, b past
    # the last (the reference's nonzero(size=cap + 1, fill_value=b)); the
    # other boundaries land in the dump slot
    bpos = torch.full((cap + 2,), b, dtype=torch.int64, device=dev)
    slot = torch.where(newv & (rank <= cap), rank, cap + 1)
    bpos.scatter_(0, slot.to(torch.int64),
                  torch.arange(b, dtype=torch.int64, device=dev))
    bpos = bpos[:cap + 1]
    total_valid = svalid.sum(dtype=torch.int64)
    nxt = torch.cat([bpos[1:], torch.full((1,), b, dtype=torch.int64,
                                          device=dev)])
    seg_end = torch.minimum(nxt, total_valid)
    seg_start = torch.minimum(bpos, total_valid)
    uvalid = torch.arange(cap, dtype=torch.int32, device=dev) < n.clamp(max=cap)
    # per-row slot: binary search for the row's key among the sorted keys,
    # then the dense rank at that (first-occurrence) position
    first = torch.searchsorted(skey, key)
    inv = torch.where(valid, rank[first.clamp(max=b - 1)], -1)
    dkey = skey[bpos[:cap].clamp(max=b - 1)].masked_fill(~uvalid, 0)
    u2 = dkey & ((1 << b2) - 1)
    u1 = (dkey >> b2) & ((1 << b1) - 1)
    u0 = dkey >> (b1 + b2)
    uniq = torch.stack([u0, u1, u2], dim=1).masked_fill(~uvalid[:, None], 0)
    if weights is None:
        counts = (seg_end - seg_start).clamp(min=0)[:cap] * uvalid
    else:
        seg = torch.where(valid & (inv >= 0) & (inv < cap), inv, cap)
        counts = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
        counts.index_add_(0, seg.to(torch.int64),
                          weights.to(torch.int64).masked_fill(~valid, 0))
        counts = counts[:cap]
    return uniq, counts.to(torch.int64), inv.to(torch.int32), n, uvalid


def bin_rows_radix(codes, valid, cap: int, weights=None, *,
                   use_kernel: bool = False):
    """Level-1 binning through the radix sort (``use_kernel``) or the fused
    single-key route — the exact ``aggregate.bin_rows`` contract (see that
    docstring for the shapes and the unclamped overflow semantics)."""
    from repro_torch.kernels import aggregate as _agg

    b = codes.shape[0]
    dev = codes.device
    if b == 0:
        return (torch.zeros((cap, 3), dtype=torch.int64, device=dev),
                torch.zeros((cap,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.bool, device=dev))
    if weights is None and b >= _agg.I32_SAT:
        weights = torch.ones((b,), dtype=torch.int64, device=dev)

    if use_kernel:
        sc, sv, order = radix_sort_codes(codes, valid)
        return _agg.bin_sorted(sc, sv, order, cap, weights, use_kernel=True)

    key, widths, fits = _fused_keys(codes, valid)
    if not on_cuda(codes):
        # reading the flag costs nothing on the CPU: run only its arm
        if bool(fits):
            return _bin_fused(codes, valid, cap, weights, key, widths)
        return _agg.bin_rows(codes, valid, cap, weights, use_kernel=False)
    # on the card a host read would stall the chunk program, so both arms
    # run and the device flag selects (off the card's main path, where
    # ``aggregate_kernel`` is on)
    fast = _bin_fused(codes, valid, cap, weights, key, widths)
    slow = _agg.bin_rows(codes, valid, cap, weights, use_kernel=False)
    return tuple(torch.where(fits, f, s) for f, s in zip(fast, slow))
