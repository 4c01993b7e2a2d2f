"""Device-resident level-1 pattern binning (sort + segment-unique/reduce),
port of ``repro.kernels.aggregate``.

Given a batch of quick codes it produces, on the device,

  * ``uniq``   — the distinct codes, lexicographically sorted, padded to a
    static capacity ``cap``;
  * ``counts`` — embeddings per distinct code (optionally weighted, for
    folding pre-binned partial aggregates);
  * ``inv``    — the per-row slot id into ``uniq`` (-1 for invalid rows);
  * ``n``      — the UNCLAMPED distinct total: overflow past ``cap`` is a
    host decision on an already-drained value.

The row sort stays a library sort (``torch.sort``; the JAX package left it
to XLA's sort outside Pallas). What the hand-written kernel
(:func:`seg_unique_cuda`, ``csrc/seg_unique.cu``) computes is everything
after the sort: segment-boundary prefix sum, first-occurrence scatter,
per-slot counts and per-row slots. The ``"radix"`` bin
(:mod:`repro_torch.kernels.radix_bin`) replaces the library sort with the
hand-written radix kernels and shares the segment half
(:func:`bin_sorted`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

#: the int32 count ceiling (DESIGN.md §13): when a pipeline stage must
#: narrow per-pattern counts to int32 (the fused chunk programs' partial
#: emission), it SATURATES at this sentinel instead of wrapping negative;
#: ``DeviceLevel1.fold_partial`` detects it and the step re-folds in int64.
I32_SAT = 2**31 - 1


#: (the C entry ``repro_seg_unique``, rows per tile), bound at the first
#: launch
_kernel = None


def _bind():
    global _kernel
    lib = build.library()
    _kernel = (lib.repro_seg_unique, int(lib.repro_seg_unique_tile()))
    return _kernel


def _empty_seg(cap: int, dev):
    z = torch.zeros((cap,), dtype=torch.int32, device=dev)
    return (z, z.clone(), torch.zeros((0,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def seg_unique_ref(new: torch.Tensor, valid: torch.Tensor, cap: int):
    """Plain version (cumsum + scatter + ``index_add_``) with the kernel's
    exact contract — what ``bin_rows`` uses when the kernel knob is off."""
    b = new.shape[0]
    dev = new.device
    if b == 0:
        return _empty_seg(cap, dev)
    newv = new & valid
    incl = torch.cumsum(newv.to(torch.int32), 0, dtype=torch.int32)
    slot = torch.where(valid, incl - 1, -1)
    n = incl[-1]
    iota = torch.arange(b, dtype=torch.int32, device=dev)
    pos_src = torch.where(newv & (slot < cap), slot, cap).to(torch.int64)
    src = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    src.scatter_(0, pos_src, iota.masked_fill(~newv, 0))
    pos_cnt = torch.where(valid & (slot >= 0) & (slot < cap), slot, cap)
    counts = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, pos_cnt.to(torch.int64), valid.to(torch.int32))
    return src[:cap], counts[:cap], slot, n


def seg_unique_cuda(new: torch.Tensor, valid: torch.Tensor, cap: int):
    """(new (B,) bool boundary flags, valid (B,) bool) over SORTED rows ->
    (src (cap,) int32, counts (cap,) int32, slot (B,) int32, n () int32).

    ``src[:min(n, cap)]`` are the first-occurrence indices of each distinct
    segment in ascending order (pad slots 0); ``counts`` the per-segment
    row totals; ``slot`` the per-row segment id (-1 invalid, unclamped past
    ``cap``); ``n`` the unclamped distinct total. ``src`` and ``counts``
    are views of one scratch buffer (with the kernel's tile words), which
    one memset clears; ``n`` has its own four bytes, so that a caller that
    keeps the total does not keep the windows."""
    if not on_cuda(new):
        return seg_unique_ref(new, valid, cap)
    for name, t in (("new", new), ("valid", valid)):
        if t.dtype != torch.bool or t.dim() != 1 or t.device != new.device:
            raise TypeError(f"{name}: expected 1-d bool on {new.device}")
    b = new.shape[0]
    if valid.shape[0] != b:
        raise ValueError(f"new {b} and valid {valid.shape[0]} rows differ")
    if b > I32_SAT or not 0 <= cap <= I32_SAT:
        raise ValueError(f"batch {b} / cap {cap} exceed int32")
    dev = new.device
    if b == 0:
        return _empty_seg(cap, dev)
    new, valid = new.contiguous(), valid.contiguous()
    fn, tile = _kernel or _bind()
    scratch = torch.empty((2 * cap + 2 * (-(-b // tile) + 1),),
                          dtype=torch.int32, device=dev)
    slot = torch.empty((b,), dtype=torch.int32, device=dev)
    n = torch.empty((), dtype=torch.int32, device=dev)
    build.launch("seg_unique", fn, new.get_device(), new.data_ptr(),
                 valid.data_ptr(), b, cap, scratch.data_ptr(),
                 slot.data_ptr(), n.data_ptr())
    return scratch[:cap], scratch[cap:2 * cap], slot, n


def sort_codes(codes: torch.Tensor, valid: torch.Tensor):
    """Sort (B, 3) code rows lexicographically with invalid rows pushed
    last. Returns (sorted codes, sorted valid, order).

    Two int64 keys: ``k1 = invalid << 32 | w0`` and ``k2`` = ``(w1, w2)``
    with the sign bit flipped (``(w1 - 2^31) * 2^32 + w2``), so the unsigned
    order of the reference's uint64 key is the signed order here without
    overflow. A stable sort on ``k2`` then on ``k1`` orders by (k1, k2).
    Tie order among equal codes is irrelevant: every :func:`bin_rows`
    output is value-determined.
    """
    k1 = ((~valid).to(torch.int64) << 32) | codes[:, 0]
    k2 = (codes[:, 1] - 2**31) * 2**32 + codes[:, 2]
    _, o2 = torch.sort(k2, stable=True)
    _, o1 = torch.sort(k1[o2], stable=True)
    order = o2[o1]
    return codes[order], valid[order], order


def bin_rows(codes, valid, cap: int, weights=None, *, use_kernel: bool = False,
             method: str = "sort"):
    """Level-1 device binning of one batch of quick codes.

    ``codes`` (B, 3) int64, ``valid`` (B,) bool ->
    ``(uniq (cap, 3) int64, counts (cap,) int64, inv (B,) int32,
    n () int32, uvalid (cap,) bool)``.

    ``uniq`` holds the distinct valid codes in ascending lexicographic
    order; ``counts[q]`` sums ``weights`` (default 1) over the rows of slot
    ``q``; ``inv`` maps each input row to its slot (-1 invalid, *unclamped*
    on overflow); ``n`` is the unclamped distinct total — ``n > cap`` means
    the caller must re-bin at ``next_pow2(n)``. Precondition: every code
    word is non-negative and < 2^32.

    ``method`` selects the partition: ``"sort"`` is this module's sort +
    segment-unique route; ``"radix"`` routes to
    :mod:`repro_torch.kernels.radix_bin` — same contract, identical
    outputs."""
    if method == "radix":
        # late import: radix_bin's slow path calls back into this module
        from repro_torch.kernels import radix_bin

        return radix_bin.bin_rows_radix(codes, valid, cap, weights,
                                        use_kernel=use_kernel)
    if method != "sort":
        raise ValueError(f"unknown aggregate_bin {method!r} (expected "
                         "'sort' or 'radix')")
    b = codes.shape[0]
    dev = codes.device
    if b == 0:
        return (torch.zeros((cap, 3), dtype=torch.int64, device=dev),
                torch.zeros((cap,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((cap,), dtype=torch.bool, device=dev))
    if weights is None and b >= I32_SAT:
        # static wide guard: unweighted counts accumulate in int32, exact
        # only while a slot's count (<= B) fits
        weights = torch.ones((b,), dtype=torch.int64, device=dev)
    sc, sv, order = sort_codes(codes, valid)
    return bin_sorted(sc, sv, order, cap, weights, use_kernel=use_kernel)


def bin_sorted(sc, sv, order, cap: int, weights=None, *,
               use_kernel: bool = False):
    """The segment half of :func:`bin_rows`, over rows already sorted
    (``sc``/``sv`` = codes/valid in sort order, invalid rows last;
    ``order`` the sort permutation): segment starts, counts and per-row
    slots through the ``seg_unique`` kernel or its plain version."""
    b = sc.shape[0]
    dev = sc.device
    prev_diff = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=dev),
        (sc[1:] != sc[:-1]).any(dim=1),
    ])
    new = sv & prev_diff
    if use_kernel:
        src, counts32, slot, n = seg_unique_cuda(new, sv, cap)
    else:
        src, counts32, slot, n = seg_unique_ref(new, sv, cap)
    uvalid = torch.arange(cap, dtype=torch.int32, device=dev) < n.clamp(max=cap)
    uniq = sc[src.clamp(max=b - 1)].masked_fill(~uvalid[:, None], 0)
    if weights is None:
        counts = counts32.to(torch.int64)
    else:
        w_sorted = weights[order].to(torch.int64).masked_fill(~sv, 0)
        seg = torch.where(sv & (slot >= 0) & (slot < cap), slot, cap)
        counts = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
        counts.index_add_(0, seg.to(torch.int64), w_sorted)
        counts = counts[:cap]
    inv = torch.zeros((b,), dtype=torch.int32, device=dev)
    inv[order] = slot
    return uniq, counts, inv, n, uvalid


def pack_codes_u32(uniq: torch.Tensor) -> torch.Tensor:
    """Lossless device-side packing of (Q, 3) int64 quick codes to 32-bit
    words (every word < 2^32 by construction), kept as int32 with the
    uint32 bits — halving the aggregation bytes that cross to the host."""
    return uniq.to(torch.int32)


def unpack_codes_u32(packed) -> np.ndarray:
    """Host-side inverse of :func:`pack_codes_u32` (numpy)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return np.asarray(packed, dtype=np.int32).view(np.uint32).astype(np.int64)
