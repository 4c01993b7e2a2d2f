"""Pattern-keyed aggregation (paper §4.1 map/reduce + §5.4 two levels),
port of ``repro.core.aggregation``.

Level 1 runs on the device over all embeddings of the step: quick-pattern
codes are binned into distinct codes and counts (:class:`DeviceLevel1`,
``kernels/aggregate.py`` sort + segment-reduce), and only O(Q) bytes — the
distinct codes packed to 32-bit words and their counts — cross to the host.
Level 2 maps quick codes to canonical codes and folds the counts, at one
of three placements (DESIGN.md §15): on the host
(:func:`repro_torch.core.pattern.build_pattern_table`), on a background
thread that the loop joins at the next seal (``host_async``,
:func:`submit_level2`), or on the device (:func:`device_level2`, the
canonical-refine kernel plus a weighted re-bin). :func:`aggregate_rows` is
the host reference path (``device_aggregate=False``), bit-identical by
construction because every path emits distinct codes in ascending
lexicographic order.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.core import pattern as pattern_lib
from repro_torch.kernels import aggregate as agg_kernel
from repro_torch.kernels import canonical_refine


def _next_pow2(x: int) -> int:
    # lazy import: runtime.config sits in a package whose __init__ imports
    # the loop, which imports this module
    from repro_torch.core.runtime.config import next_pow2

    return next_pow2(x)


class StepAggregates(NamedTuple):
    """Aggregation output of one exploration step (canonical-pattern keyed)."""

    canon_codes: np.ndarray    # (Pc, 3) int64
    counts: np.ndarray         # (Pc,) int64 — #embeddings per pattern
    supports: np.ndarray       # (Pc,) int64 — min-image support (== counts
                               #   when domains were not requested)
    n_quick: int               # distinct quick patterns this step (Table 4)
    n_canonical: int           # distinct canonical patterns
    n_iso_checks: int          # graph-isomorphism invocations


def _unique_rows3(codes: np.ndarray):
    """``np.unique(axis=0, return_inverse=True)`` for (B, 3) int64 rows via
    a 3-key lexsort."""
    order = np.lexsort((codes[:, 2], codes[:, 1], codes[:, 0]))
    sc = codes[order]
    new = np.empty(len(sc), dtype=bool)
    new[0] = True
    np.any(sc[1:] != sc[:-1], axis=1, out=new[1:])
    uniq = sc[new]
    inv = np.empty(len(sc), dtype=np.int64)
    inv[order] = np.cumsum(new) - 1
    return uniq, inv


def aggregate_rows(codes: np.ndarray,
                   canon_fn=None) -> tuple[StepAggregates, np.ndarray]:
    """Full two-level aggregation for one step's embeddings over host
    (B, 3) int64 quick codes — the ``device_aggregate=False`` reference
    path. ``canon_fn`` is the level-2 miss hook of the device placement.
    Returns (aggregates, per-embedding canonical slot)."""
    codes = np.asarray(codes)
    b = len(codes)
    if b == 0:
        empty = StepAggregates(
            canon_codes=np.zeros((0, 3), np.int64),
            counts=np.zeros((0,), np.int64),
            supports=np.zeros((0,), np.int64),
            n_quick=0,
            n_canonical=0,
            n_iso_checks=0,
        )
        return empty, np.full(b, -1, np.int32)
    uniq, inv = _unique_rows3(codes)
    table, counts = finish_quick_level2(
        uniq, np.bincount(inv, minlength=len(uniq)), canon_fn=canon_fn
    )
    agg = StepAggregates(
        canon_codes=table.canon_codes,
        counts=counts,
        supports=counts.copy(),
        n_quick=len(uniq),
        n_canonical=len(table.canon_codes),
        n_iso_checks=table.n_iso_checks,
    )
    return agg, table.quick_to_canon[inv].astype(np.int32)


# ---------------------------------------------------------------------------
# Device-resident level 1 (DESIGN.md §10)
# ---------------------------------------------------------------------------

def _bin_all_valid(codes, cap: int, use_kernel: bool, method: str = "sort"):
    """Bin one batch of all-valid quick codes at capacity ``cap``."""
    b = codes.shape[0]
    return agg_kernel.bin_rows(
        codes, torch.ones((b,), dtype=torch.bool, device=codes.device), cap,
        use_kernel=use_kernel, method=method,
    )


def _bin_weighted(codes, valid, weights, cap: int, use_kernel: bool,
                  method: str = "sort"):
    """Fold pre-binned partials: weighted re-bin of stacked unique tables."""
    return agg_kernel.bin_rows(
        codes, valid, cap, weights=weights, use_kernel=use_kernel,
        method=method,
    )


def _finish_flags(uniq, counts, uvalid, n_stack, corrupt, sat):
    """The ONE scalar drain of a step's level-1 state: [final distinct
    count, max distinct count over every fold (merge-overflow detection),
    partial-corruption flag, w1/w2 column-used flags, counts-fit-int32
    flag, count-saturation flag] as one (7,) int32 device tensor."""
    w1_used = (uniq[:, 1].masked_fill(~uvalid, 0) != 0).any()
    w2_used = (uniq[:, 2].masked_fill(~uvalid, 0) != 0).any()
    fit32 = counts.masked_fill(~uvalid, 0).max() < 2**31
    return torch.stack([
        n_stack[-1], n_stack.max(), corrupt.to(torch.int32),
        w1_used.to(torch.int32), w2_used.to(torch.int32),
        fit32.to(torch.int32), sat.to(torch.int32),
    ]).to(torch.int32)


class DeviceLevel1:
    """Device-resident level-1 state of ONE superstep (DESIGN.md §10).

    Folds batches of quick codes — raw rows from a frontier wave
    (:meth:`fold_rows`) or pre-binned per-chunk partials emitted by the
    fused chunk programs (:meth:`fold_partial`) — into a device-side
    distinct table, without any host transfer. :meth:`finish` drains the
    O(Q) result: one (7,) scalar read, then the distinct codes packed to
    32-bit words (label words dropped when unused) and the counts (int32
    when they fit).

    Per-batch bins use the batch's own pow2 capacity (never overflow);
    cross-batch *merges* use ``merge_cap``, and an overflow is re-merged at
    the exact pow2 capacity from the retained partials. Only when eager
    compaction has already dropped partials does :meth:`finish` return
    ``None``, and the caller re-folds from the frontier waves.
    """

    def __init__(self, *, merge_cap: int, use_kernel: bool = False,
                 bin_method: str = "sort", pending_limit: int = 32) -> None:
        self.merge_cap = int(merge_cap)
        self.rows = 0                   # host-known rows folded so far
        self.parts: List[tuple] = []    # (uniq, counts i64, uvalid, cap, n)
        self.batches: List[tuple] = []  # (inv, part_idx)  [fold_rows]
        self._merge_ns: List = []       # device n of every cross-batch merge
        self._corrupt = None            # device flag: a partial overflowed
        self._sat = None                # device flag: int32 partial saturated
        self._compacted = False
        self._use_kernel = use_kernel
        self._bin_method = bin_method
        self._pending_limit = pending_limit
        self._final = None              # (uniq, counts, uvalid, cap, n)
        self._maps: Optional[List] = None

    # -- folding ------------------------------------------------------------
    def fold_rows(self, codes) -> None:
        """Fold one wave's (B, 3) quick codes (all rows valid); the per-row
        slots stay on the device for the alpha masks."""
        b = int(codes.shape[0])
        if b == 0:
            return
        cap = _next_pow2(b)
        u, c, inv, n, uv = _bin_all_valid(
            codes, cap, self._use_kernel, self._bin_method
        )
        self.parts.append((u, c, uv, cap, n))
        self.batches.append((inv, len(self.parts) - 1))
        self.rows += b

    def fold_partial(self, uniq, counts, n, cap: int, rows: int,
                     may_overflow: bool = False) -> None:
        """Fold one chunk program's pre-binned partial: ``uniq`` (cap, 3),
        ``counts`` (cap,) and the device distinct count ``n`` (unclamped).
        ``may_overflow`` marks partials binned below the chunk's child
        capacity: ``n > cap`` then sets a device flag that rides the finish
        drain, after which the caller re-folds from the waves."""
        uv = torch.arange(cap, dtype=torch.int32, device=n.device) < n.clamp(max=cap)
        if counts.dtype == torch.int32:
            # a narrowed partial: the I32_SAT sentinel means the true count
            # was clipped — the step re-folds in int64 (DESIGN.md §13)
            hit = (counts.masked_fill(~uv, 0) >= agg_kernel.I32_SAT).any()
            self._sat = hit if self._sat is None else (self._sat | hit)
        self.parts.append((uniq, counts.to(torch.int64), uv, cap, n))
        self.rows += rows
        if may_overflow:
            bad = n > cap
            self._corrupt = bad if self._corrupt is None else (
                self._corrupt | bad
            )
        if len(self.parts) >= self._pending_limit:
            self._compact()

    def _merge(self, parts, cap: int):
        u = torch.cat([p[0] for p in parts])
        c = torch.cat([p[1] for p in parts])
        v = torch.cat([p[2] for p in parts])
        mu, mc, minv, mn, muv = _bin_weighted(
            u, v, c, cap, self._use_kernel, self._bin_method
        )
        self._merge_ns.append(mn)
        return mu, mc, minv, mn, muv

    def _compact(self) -> None:
        mu, mc, _, mn, muv = self._merge(self.parts, self.merge_cap)
        self.parts = [(mu, mc, muv, self.merge_cap, mn)]
        self._compacted = True

    # -- the O(Q) drain -----------------------------------------------------
    def _finalize(self, cap: int):
        if len(self.parts) == 1:
            # a lone batch bin (cap >= rows) or an eager compaction: never
            # re-merged — overflow of the latter is caught via _merge_ns
            u, c, uv, pcap, n = self.parts[0]
            self._maps = [None]
            return u, c, uv, pcap, n
        mu, mc, minv, mn, muv = self._merge(self.parts, cap)
        off, maps = 0, []
        for p in self.parts:
            maps.append(minv[off: off + p[3]])
            off += p[3]
        self._maps = maps
        return mu, mc, muv, cap, mn

    def finish(self):
        """Drain the folded state to the host: ``(uniq (Q, 3) int64,
        counts (Q,) int64, bytes_to_host)`` — or ``None`` when the state is
        unrecoverable on the device (re-fold from the frontier waves).
        ``observed_n`` afterwards holds the true distinct total."""
        if not self.parts:
            self.observed_n = 0
            return np.zeros((0, 3), np.int64), np.zeros((0,), np.int64), 0
        u, c, uv, cap, n = self._finalize(self.merge_cap)
        dev = u.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        corrupt = self._corrupt if self._corrupt is not None else false
        sat = self._sat if self._sat is not None else false
        stack = torch.stack([x.to(torch.int32) for x in (self._merge_ns + [n])])
        flags = _finish_flags(u, c, uv, stack, corrupt, sat).cpu().numpy()
        nbytes = flags.nbytes
        self.observed_n = n_final = int(flags[0])
        max_n = int(flags[1])
        if flags[2]:
            return None             # a chunk partial overflowed its bin
        if flags[6]:
            # an int32 partial saturated at I32_SAT: its totals are floors;
            # the wave re-fold re-bins everything in int64 (DESIGN.md §13)
            return None
        if max_n > cap:
            if self._compacted:
                return None
            # exact re-merge from the retained partials: the unclamped
            # distinct total rode the scalar read, no extra sync
            u, c, uv, cap, n = self._finalize(_next_pow2(max_n))
            stack = torch.stack([self._merge_ns[-1].to(torch.int32)])
            flags = _finish_flags(u, c, uv, stack, false, false).cpu().numpy()
            nbytes += flags.nbytes
            self.observed_n = n_final = int(flags[0])
        # packed transfer: only used code words cross, counts narrowed
        uniq, counts, tbytes = drain_distinct(
            u, c, n_final,
            w1_used=bool(flags[3]), w2_used=bool(flags[4]),
            fit32=bool(flags[5]),
        )
        self._final = (u, c, uv, cap, n)
        return uniq, counts, nbytes + tbytes

    # -- per-row slots (alpha masks) ------------------------------------------
    def batch_slots(self, i: int):
        """Device per-row slot ids of batch ``i`` in FINAL table order."""
        inv, pidx = self.batches[i]
        m = self._maps[pidx] if self._maps is not None else None
        return m[inv] if m is not None else inv

    @property
    def final_cap(self) -> int:
        return self._final[3] if self._final is not None else self.merge_cap


def drain_distinct(u_dev, c_dev, n: int, w1_used: bool, w2_used: bool,
                   fit32: bool):
    """The packed O(Q) device→host drain: distinct codes as 32-bit words
    with unused label words dropped (lossless by the encoding), counts
    narrowed to int32 when they fit. Returns ``(uniq (n, 3) int64, counts
    (n,) int64, bytes_transferred)``."""
    cols = [0] + ([1] if w1_used else []) + ([2] if w2_used else [])
    packed = agg_kernel.pack_codes_u32(u_dev[:n][:, cols]).cpu().numpy()
    uniq = np.zeros((n, 3), np.int64)
    uniq[:, cols] = agg_kernel.unpack_codes_u32(packed)
    cdev = c_dev[:n]
    counts = (cdev.to(torch.int32) if fit32 else cdev).cpu().numpy()
    return uniq, counts.astype(np.int64), packed.nbytes + counts.nbytes


def build_step_aggregates(table: pattern_lib.PatternTable,
                          counts: np.ndarray, supports, n_quick: int,
                          st) -> StepAggregates:
    """Assemble a step's :class:`StepAggregates` from level-2 output and
    mirror the pattern counters into the step stats."""
    agg = StepAggregates(
        canon_codes=table.canon_codes,
        counts=counts,
        supports=np.asarray(supports).astype(np.int64),
        n_quick=n_quick,
        n_canonical=len(table.canon_codes),
        n_iso_checks=table.n_iso_checks,
    )
    obs.set_stat(st, "n_quick_patterns", agg.n_quick)
    obs.set_stat(st, "n_canonical_patterns", agg.n_canonical)
    obs.set_stat(st, "n_iso_checks", agg.n_iso_checks)
    return agg


def finish_quick_level2(uniq: np.ndarray, counts_q: np.ndarray,
                        canon_fn=None):
    """Host level 2 over level-1 state: canonicalise the Q distinct quick
    codes (memoised, :func:`pattern.build_pattern_table`) and fold the
    quick counts to canonical slots. Returns ``(table, counts (Pc,)
    int64)``."""
    table = pattern_lib.build_pattern_table(uniq, canon_fn=canon_fn)
    counts = np.zeros(len(table.canon_codes), dtype=np.int64)
    np.add.at(counts, table.quick_to_canon, counts_q.astype(np.int64))
    return table, counts


# ---------------------------------------------------------------------------
# Level-2 placement (DESIGN.md §15): device re-bin + async host overlap
# ---------------------------------------------------------------------------

def async_level2_ok(app) -> bool:
    """True when level 2 may run off the critical path (``host_async``).

    The deferred table must not be consulted mid-step: apps that override
    ``pattern_filter`` or the per-row ``aggregation_filter``, or that
    consume orbit domains, need the table before expansion — they run the
    synchronous host placement instead (bit-identical output either
    way)."""
    from repro_torch.core.api import MiningApp

    return (
        app.wants_patterns
        and not app.wants_domains
        and type(app).pattern_filter is MiningApp.pattern_filter
        and type(app).aggregation_filter is MiningApp.aggregation_filter
    )


_ASYNC_EXECUTOR = None


def _async_executor():
    global _ASYNC_EXECUTOR
    if _ASYNC_EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor

        # one worker: supersteps submit at most one level-2 batch each and
        # join it at the next seal, and FIFO keeps memo writes ordered
        _ASYNC_EXECUTOR = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-canon"
        )
    return _ASYNC_EXECUTOR


class PendingLevel2:
    """An in-flight ``host_async`` level-2 batch: the backend submits the
    drained O(Q) table to the background thread and the loop joins the
    future at the seal boundary — canonicalisation overlaps the next
    superstep's expansion instead of sitting on the critical path."""

    def __init__(self, future, n_quick: int):
        self._future = future
        self.n_quick = n_quick

    def done(self) -> bool:
        return self._future.done()

    def result(self):
        """Block until the batch lands: ``(table, counts (Pc,) int64)``."""
        return self._future.result()


def submit_level2(uniq: np.ndarray, counts_q: np.ndarray) -> PendingLevel2:
    """Queue one step's host level 2 on the background thread. It gets
    numpy arrays only: the thread never touches a device tensor."""
    fut = _async_executor().submit(finish_quick_level2, uniq, counts_q)
    return PendingLevel2(fut, len(uniq))


def _level2_program(u, c, uv, cap: int, nvs: tuple, use_kernel: bool,
                    method: str):
    """The device level 2: batched canonical refine of the O(Q) distinct
    table + weighted quick→canonical re-bin. ``bin_rows`` emits distinct
    codes in ascending lexicographic order — the same order as the host's
    ``np.unique`` — so every output is bit-identical to the host path.
    (The reference also refines the canonical table's orbits here for
    FSM's domains; vertex mode has none.)"""
    canon, sigma, _ = canonical_refine.refine_codes(
        u, uv, nvs, use_kernel=use_kernel,
    )
    canon = canon.masked_fill(~uv[:, None], 0)
    cu, cc, q2c, cn, _ = agg_kernel.bin_rows(
        canon, uv, cap, weights=c, use_kernel=use_kernel, method=method,
    )
    return canon, sigma, cu, cc, q2c, cn


def device_level2(u, c, uv, cap: int, n_final: int, quick_codes: np.ndarray,
                  counts_q: np.ndarray, *, nvs: tuple,
                  use_kernel: bool = False, method: str = "sort"):
    """Device-placed level 2 over the finalized device level-1 state.

    ``u``/``c``/``uv`` are the device distinct table (capacity ``cap``),
    ``n_final`` the already-drained distinct count, ``quick_codes`` /
    ``counts_q`` the host copies from the level-1 drain (the quick table
    still crosses — the memo needs it; what this path removes is the host
    permutation search). The canonical table can never overflow ``cap``
    (Pc ≤ Q ≤ cap). Vertex mode only: no orbit domains.

    Returns ``(table, counts (Pc,) int64, bytes_to_host)``.
    """
    canon_d, sigma_d, cu_d, cc_d, q2c_d, cn_d = _level2_program(
        u, c, uv, cap, nvs, use_kernel, method
    )
    q = int(n_final)
    pc = int(cn_d)
    sigma = sigma_d[:q].cpu().numpy().astype(np.int32)
    q2c = q2c_d[:q].cpu().numpy().astype(np.int32)
    cu = cu_d[:pc].cpu().numpy().astype(np.int64)
    cc = cc_d[:pc].cpu().numpy().astype(np.int64)
    canon_rows = canon_d[:q].cpu().numpy().astype(np.int64)
    orbits = np.tile(
        np.arange(pattern_lib.MAX_PATTERN_VERTICES, dtype=np.int32), (pc, 1)
    )
    nbytes = (sigma.nbytes + q2c.nbytes + cu.nbytes + cc.nbytes
              + canon_rows.nbytes + 4)
    table = pattern_lib.PatternTable(
        quick_codes=quick_codes,
        canon_codes=cu,
        quick_to_canon=q2c,
        sigma=sigma,
        canon_n_verts=(cu[:, 0] & 0xF).astype(np.int32),
        canon_orbits=orbits,
        n_iso_checks=q,
    )
    # warm the host memo with the device results: a later host placement
    # over the same patterns is then pure cache hits
    pattern_lib.seed_memo(quick_codes, canon_rows, sigma)
    return table, cc, nbytes


def level2_nvs(app, size: int) -> tuple:
    """The nv set of the patterns a step of ``size`` may emit: vertex mode
    (the only mode the port runs) explores fixed-size embeddings, so
    nv == size."""
    return (min(int(size), pattern_lib.MAX_PATTERN_VERTICES),)
