"""Radix level-1 binning (``bin_rows`` without a comparison sort), port of
``repro.kernels.radix_bin``.

Two routes with ``aggregate.bin_rows``'s exact contract:

* :func:`radix_sort_codes` — a stable LSB radix sort of the (B, 3) code
  rows, one 8-bit digit per pass (w2, w1, w0, then the invalid flag, least
  significant first, :data:`_PASSES`). On a CUDA tensor each pass is the
  two hand-written kernels of ``csrc/radix_sort.cu``
  (:func:`radix_hist_cuda`, :func:`radix_scatter_cuda`); passes whose digit
  is constant over the batch are skipped on the device, without a host
  read. On a CPU tensor it is the plain version
  (:func:`radix_sort_codes_ref`, one stable sort per pass).
  :func:`bin_rows_radix` then finds segments as the sort bin does.

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

#: the fused key of an invalid row: above every key of <= FUSED_BITS bits.
_SENTINEL = 2**63 - 1
FUSED_BITS = 62

INT32_MAX = 2**31 - 1
#: rows per block of the radix kernels (``kTileRows`` in
#: ``csrc/radix_sort.cu``): the block partition of the histogram.
RADIX_TILE = 4096


def _pass_digits(codes, valid, order, word: int, shift: int):
    """The pass's 8-bit digit of each row of ``order`` (int64)."""
    src = (~valid).to(torch.int64) if word == 3 else codes[:, word]
    return (src[order.to(torch.int64)] >> shift) & 0xFF


def digit_vary_ref(codes, valid):
    """(4,) int32 mask of the bits that vary over the batch: the OR over
    rows of ``word[r] ^ word[0]`` for the three words' low 32 bits and the
    invalid flag. A pass whose byte of it is 0 permutes nothing."""
    words = torch.stack([
        codes[:, 0] & 0xFFFFFFFF, codes[:, 1] & 0xFFFFFFFF,
        codes[:, 2] & 0xFFFFFFFF, (~valid).to(torch.int64),
    ], dim=1)
    diff = words ^ words[:1]
    out = torch.zeros((4,), dtype=torch.int64, device=codes.device)
    for bit in range(32):
        out |= (((diff >> bit) & 1).amax(dim=0)) << bit
    return out.to(torch.int32)


def radix_hist_ref(codes, valid, order, word: int, shift: int, tile: int):
    """Plain version of one pass's digit statistics: ``hist`` (256 * nb,)
    int32, digit-major, holding for each (digit, block of ``tile`` rows)
    the rows of that digit in earlier blocks, and ``totals`` (256,) int32,
    the rows of each digit."""
    b = order.shape[0]
    nb = -(-b // tile)
    d = _pass_digits(codes, valid, order, word, shift)
    blk = torch.arange(b, device=order.device) // tile
    counts = torch.zeros((NDIGITS * nb,), dtype=torch.int32,
                         device=order.device)
    counts.index_add_(0, d * nb + blk, torch.ones_like(d, dtype=torch.int32))
    counts = counts.reshape(NDIGITS, nb)
    hist = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    return hist.reshape(-1), counts.sum(1, dtype=torch.int32)


def radix_scatter_ref(codes, valid, order, word: int, shift: int):
    """Plain version of one stable pass: ``order`` stably re-sorted by the
    pass's digit."""
    d = _pass_digits(codes, valid, order, word, shift)
    return order[torch.sort(d, stable=True).indices]


def _check_rows(codes, valid, order):
    dev = codes.device
    if codes.dtype != torch.int64 or codes.dim() != 2 or codes.shape[1] != 3:
        raise TypeError(f"codes: expected (B, 3) int64, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    b = codes.shape[0]
    for name, t, dt in (("valid", valid, torch.bool),
                        ("order", order, torch.int32)):
        if t.dtype != dt or t.shape != (b,) or t.device != dev:
            raise TypeError(f"{name}: expected ({b},) {dt} on {dev}")
    if b > INT32_MAX:
        raise ValueError(f"batch {b} exceeds int32 row indices")


def radix_hist_cuda(codes, valid, order, word: int, shift: int, vary,
                    first: bool, hist=None, totals=None):
    """One pass's digit statistics by ``csrc/radix_sort.cu`` (same
    contract as :func:`radix_hist_ref` for a pass whose digit varies; for
    a constant digit ``hist``/``totals`` are left unwritten). ``first``
    also ORs the batch's :func:`digit_vary_ref` mask into ``vary`` ((4,)
    int32, zeroed by the caller); every other pass reads it."""
    if not on_cuda(codes):
        if first:
            vary |= digit_vary_ref(codes, valid)
        return radix_hist_ref(codes, valid, order, word, shift, RADIX_TILE)
    _check_rows(codes, valid, order)
    b = codes.shape[0]
    dev = codes.device
    nb = -(-b // RADIX_TILE)
    if hist is None:
        hist = torch.empty((NDIGITS * nb,), dtype=torch.int32, device=dev)
    if totals is None:
        totals = torch.empty((NDIGITS,), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        build.count_launch("radix_hist")
        build.check(lib.repro_radix_hist(
            codes.data_ptr(), valid.data_ptr(), order.data_ptr(), b, word,
            shift, int(first), vary.data_ptr(), hist.data_ptr(),
            totals.data_ptr(), build.stream_of(codes),
        ), "radix_hist")
    return hist, totals


def radix_scatter_cuda(codes, valid, order, word: int, shift: int, vary,
                       hist, totals, out=None):
    """One stable pass by ``csrc/radix_sort.cu``, after
    :func:`radix_hist_cuda` of the same pass: ``order`` stably re-sorted
    by the pass's digit, written to ``out`` (a buffer distinct from
    ``order``)."""
    if not on_cuda(codes):
        return radix_scatter_ref(codes, valid, order, word, shift)
    _check_rows(codes, valid, order)
    b = codes.shape[0]
    if out is None:
        out = torch.empty_like(order)
    lib = build.library()
    with torch.cuda.device(codes.device):
        build.count_launch("radix_scatter")
        build.check(lib.repro_radix_scatter(
            codes.data_ptr(), valid.data_ptr(), order.data_ptr(), b, word,
            shift, vary.data_ptr(), hist.data_ptr(), totals.data_ptr(),
            out.data_ptr(), build.stream_of(codes),
        ), "radix_scatter")
    return out


def radix_sort_codes_ref(codes, valid):
    """Plain version of :func:`radix_sort_codes`: the same passes, each a
    stable sort of the pass's digits. A pass over a constant digit is the
    identity, so none is skipped."""
    order = torch.arange(codes.shape[0], dtype=torch.int32,
                         device=codes.device)
    for word, shift in _PASSES:
        order = radix_scatter_ref(codes, valid, order, word, shift)
    return codes[order], valid[order], order


def radix_sort_codes(codes, valid):
    """Stable LSB-radix sort of (B, 3) quick-code rows, invalid rows last.

    Same contract as ``aggregate.sort_codes``, and the order is exactly the
    stable sort by (invalid, w0, w1, w2): returns (sorted codes, sorted
    valid, order int32). A CUDA tensor runs the kernels and never reads the
    device from the host; a CPU tensor runs :func:`radix_sort_codes_ref`."""
    if not on_cuda(codes):
        return radix_sort_codes_ref(codes, valid)
    b = codes.shape[0]
    dev = codes.device
    codes, valid = codes.contiguous(), valid.contiguous()
    order = torch.arange(b, dtype=torch.int32, device=dev)
    if b == 0:
        return codes, valid, order
    nb = -(-b // RADIX_TILE)
    vary = torch.zeros((4,), dtype=torch.int32, device=dev)
    hist = torch.empty((NDIGITS * nb,), dtype=torch.int32, device=dev)
    totals = torch.empty((NDIGITS,), dtype=torch.int32, device=dev)
    spare = torch.empty_like(order)
    for i, (word, shift) in enumerate(_PASSES):
        radix_hist_cuda(codes, valid, order, word, shift, vary, i == 0,
                        hist, totals)
        radix_scatter_cuda(codes, valid, order, word, shift, vary, hist,
                           totals, spare)
        order, spare = spare, order
    return codes[order], valid[order], order


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
