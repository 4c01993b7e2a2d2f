"""Pattern-keyed aggregation (paper §4.1 map/reduce + §5.4 two levels),
port of ``repro.core.aggregation``.

Level 1 runs on the device over all embeddings of the step: quick-pattern
codes are binned into distinct codes and counts (:class:`DeviceLevel1`,
``kernels/aggregate.py`` sort + segment-reduce), and only O(Q) bytes — the
distinct codes packed to 32-bit words, their counts and, for FSM, the
(Pc, 8, N) canonical domain bitmaps — cross to the host.
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def quick_slot_ids(codes, valid):
    """Host-side unique over the (B, 3) quick codes -> (unique (Q,3), inv
    (B,)); rows with ``valid == False`` are mapped to slot -1."""
    codes_np = _host(codes)
    valid_np = _host(valid)
    if not valid_np.any():
        return np.zeros((0, 3), np.int64), np.full(len(codes_np), -1, np.int32)
    uniq, inv = _unique_rows3(codes_np[valid_np])
    full_inv = np.full(len(codes_np), -1, dtype=np.int32)
    full_inv[valid_np] = inv.astype(np.int32)
    return uniq, full_inv


def _scatter_flat(flat, canon_slot, verts_canonical, ok, n_vertices: int):
    """Set the bits of one batch in the flat (Pc * 8 * N + 1,) bool domain
    buffer: vertex ``v`` at canonical position ``p`` of slot ``pc`` lands
    at ``(pc * 8 + p) * N + v``; rows or positions not ``ok`` land in the
    last slot, the dump (JAX drops such scatters; the port routes them
    there, so no index is ever out of range)."""
    kmax = verts_canonical.shape[1]
    dump = flat.shape[0] - 1
    idx = (
        canon_slot[:, None].to(torch.int64) * (kmax * n_vertices)
        + torch.arange(kmax, device=flat.device)[None, :] * n_vertices
        + verts_canonical.clamp(min=0).to(torch.int64)
    )
    idx = torch.where(ok, idx, dump)
    return flat.index_fill_(0, idx.reshape(-1), True)


def domain_bitmaps(
    canon_slot: torch.Tensor,       # (B,) int32 canonical slot per embedding
    verts_canonical: torch.Tensor,  # (B, 8) int32 graph vertex at canonical pos
    valid: torch.Tensor,            # (B,) bool
    n_canon: int,
    n_vertices: int,
) -> torch.Tensor:
    """FSM min-image domains (level 1): bool (Pc, 8, N) — vertex v appears
    at canonical position p of some embedding of pattern pc. One scatter
    into a flat buffer with a dump slot."""
    kmax = verts_canonical.shape[1]
    size = n_canon * kmax * n_vertices
    flat = torch.zeros((size + 1,), dtype=torch.bool,
                       device=verts_canonical.device)
    ok = (valid[:, None] & (verts_canonical >= 0)
          & (canon_slot[:, None] >= 0))
    flat = _scatter_flat(flat, canon_slot, verts_canonical, ok, n_vertices)
    return flat[:-1].reshape(n_canon, kmax, n_vertices)


def min_image_support(bitmaps, canon_n_verts: np.ndarray,
                      canon_orbits: np.ndarray) -> np.ndarray:
    """Support(p) = min over pattern positions of |domain(position)| [7].

    Domains are defined over *all* isomorphisms pattern->embedding; with
    one fixed isomorphism per embedding the missing mappings are recovered
    by OR-ing domains across each position's automorphism orbit
    (``canon_math.automorphism_orbits``). Host numpy over the (Pc, 8, N)
    bitmap that crossed to the host."""
    bm = _host(bitmaps)                               # (Pc, 8, N) bool
    pc, kmax, n = bm.shape
    if pc == 0:
        return np.zeros((0,), np.int64)
    # orbit merge as one batched boolean matmul: eq[p, i, j] marks
    # positions in the same orbit, so (eq @ bm)[p, pos] > 0 ORs the
    # orbit-mates' domains; uint8 is safe, row sums are at most 8
    orb = np.asarray(canon_orbits)[:, :kmax]
    eq = (orb[:, :, None] == orb[:, None, :]).astype(np.uint8)   # (Pc, 8, 8)
    merged = np.matmul(eq, bm.astype(np.uint8)) > 0              # (Pc, 8, N)
    counts = merged.sum(axis=2)                       # (Pc, 8)
    pos_ok = np.arange(kmax)[None, :] < np.asarray(canon_n_verts)[:, None]
    counts = np.where(pos_ok, counts, np.iinfo(np.int64).max)
    return counts.min(axis=1).astype(np.int64)


def map_to_canonical_positions(
    table: pattern_lib.PatternTable,
    quick_slot: np.ndarray,       # (B,) int32
    local_verts,                  # (B, 8) int32
) -> tuple[np.ndarray, torch.Tensor]:
    """Per-embedding canonical slot + vertices re-ordered to canonical
    positions (position p holds the local vertex with sigma[local] = p).
    The vertices come back as a tensor on ``local_verts``' device (the
    CPU for a numpy input)."""
    sigma = table.sigma[np.maximum(quick_slot, 0)]    # (B, 8) local -> canon
    sigma_inv = np.argsort(sigma, axis=1)             # canon -> local
    lv = _host(local_verts)
    verts_canon = np.take_along_axis(lv, sigma_inv, axis=1)
    canon_slot = np.where(
        quick_slot >= 0, table.quick_to_canon[np.maximum(quick_slot, 0)], -1
    ).astype(np.int32)
    dev = (local_verts.device if isinstance(local_verts, torch.Tensor)
           else "cpu")
    return canon_slot, torch.from_numpy(np.ascontiguousarray(verts_canon)).to(
        dev)


def aggregate_rows(
    g_n_vertices: int,
    codes: np.ndarray,        # (B, 3) int64 quick codes (host)
    local_verts,              # (B, 8) int32 (host); None iff not with_domains
    with_domains: bool,
    canon_fn=None,            # level-2 miss hook (device placement)
) -> tuple[StepAggregates, np.ndarray]:
    """Full two-level aggregation for one step's embeddings over host
    quick codes — the ``device_aggregate=False`` reference path, with the
    FSM domains scattered on the host. ``canon_fn`` is the level-2 miss
    hook of the device placement. Returns (aggregates, per-embedding
    canonical slot)."""
    codes = np.asarray(codes)
    b = len(codes)
    uniq, inv = quick_slot_ids(codes, np.ones(b, dtype=bool))
    q = len(uniq)
    if q == 0:
        empty = StepAggregates(
            canon_codes=np.zeros((0, 3), np.int64),
            counts=np.zeros((0,), np.int64),
            supports=np.zeros((0,), np.int64),
            n_quick=0,
            n_canonical=0,
            n_iso_checks=0,
        )
        return empty, np.full(b, -1, np.int32)
    table, counts = finish_quick_level2(
        uniq, np.bincount(inv, minlength=q), with_domains, canon_fn=canon_fn
    )
    pc = len(table.canon_codes)
    if with_domains:
        # domains need every embedding's vertices re-ordered to canonical
        # positions; without them the slot lookup is the whole mapping
        canon_slot, verts_canon = map_to_canonical_positions(
            table, inv, np.asarray(local_verts)
        )
        verts_canon = verts_canon.numpy()
        kmax = verts_canon.shape[1]
        bm = np.zeros((pc, kmax, g_n_vertices), dtype=bool)
        ok = (verts_canon >= 0) & (canon_slot[:, None] >= 0)
        rows, pos = np.nonzero(ok)
        bm[canon_slot[rows], pos, verts_canon[rows, pos]] = True
        supports = min_image_support(bm, table.canon_n_verts,
                                     table.canon_orbits)
    else:
        canon_slot = table.quick_to_canon[inv].astype(np.int32)
        supports = counts.copy()
    agg = StepAggregates(
        canon_codes=table.canon_codes,
        counts=counts,
        supports=np.asarray(supports).astype(np.int64),
        n_quick=q,
        n_canonical=pc,
        n_iso_checks=table.n_iso_checks,
    )
    return agg, canon_slot


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
        self.batches: List[tuple] = []  # (inv, lv, part_idx)  [fold_rows]
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
    def fold_rows(self, codes, lv=None) -> None:
        """Fold one wave's (B, 3) quick codes (all rows valid); the per-row
        slots stay on the device for the alpha masks, and ``lv`` (device)
        is retained for the FSM phase-2 domain scatter."""
        b = int(codes.shape[0])
        if b == 0:
            return
        cap = _next_pow2(b)
        u, c, inv, n, uv = _bin_all_valid(
            codes, cap, self._use_kernel, self._bin_method
        )
        self.parts.append((u, c, uv, cap, n))
        self.batches.append((inv, lv, len(self.parts) - 1))
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

    # -- per-row slots (alpha masks, FSM phase 2) ---------------------------
    def batch_slots(self, i: int):
        """Device per-row slot ids of batch ``i`` in FINAL table order."""
        inv, _, pidx = self.batches[i]
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
                        with_domains: bool = False, canon_fn=None):
    """Host level 2 over level-1 state: canonicalise the Q distinct quick
    codes (memoised, :func:`pattern.build_pattern_table`, with the
    canonical codes' orbits when domains are asked for) and fold the quick
    counts to canonical slots. Returns ``(table, counts (Pc,) int64)``."""
    table = pattern_lib.build_pattern_table(
        uniq, with_orbits=with_domains, canon_fn=canon_fn
    )
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
    """Queue one step's host level 2 on the background thread (domains are
    never requested here — ``async_level2_ok`` excludes domain apps). It
    gets numpy arrays only: the thread never touches a device tensor."""
    fut = _async_executor().submit(finish_quick_level2, uniq, counts_q, False)
    return PendingLevel2(fut, len(uniq))


def _level2_program(u, c, uv, cap: int, nvs: tuple, with_orbits: bool,
                    use_kernel: bool, method: str):
    """The device level 2: batched canonical refine of the O(Q) distinct
    table + weighted quick→canonical re-bin (+ the orbit pass over the
    canonical table for FSM). ``bin_rows`` emits distinct codes in
    ascending lexicographic order — the same order as the host's
    ``np.unique`` — so every output is bit-identical to the host path."""
    canon, sigma, _ = canonical_refine.refine_codes(
        u, uv, nvs, use_kernel=use_kernel,
    )
    canon = canon.masked_fill(~uv[:, None], 0)
    cu, cc, q2c, cn, cuv = agg_kernel.bin_rows(
        canon, uv, cap, weights=c, use_kernel=use_kernel, method=method,
    )
    if with_orbits:
        _, _, rep = canonical_refine.refine_codes(
            cu, cuv, nvs, with_orbits=True, use_kernel=use_kernel,
        )
    else:
        rep = None
    return canon, sigma, cu, cc, q2c, cn, rep


def device_level2(u, c, uv, cap: int, n_final: int, quick_codes: np.ndarray,
                  counts_q: np.ndarray, *, nvs: tuple, with_domains: bool,
                  use_kernel: bool = False, method: str = "sort"):
    """Device-placed level 2 over the finalized device level-1 state.

    ``u``/``c``/``uv`` are the device distinct table (capacity ``cap``),
    ``n_final`` the already-drained distinct count, ``quick_codes`` /
    ``counts_q`` the host copies from the level-1 drain (the quick table
    still crosses — phase 2 and the memo need it; what this path removes
    is the host permutation search). The canonical table can never
    overflow ``cap`` (Pc ≤ Q ≤ cap). ``with_domains`` adds the orbit pass
    over the canonical table and brings its (Pc, 8) orbits across.

    Returns ``(table, counts (Pc,) int64, bytes_to_host)``.
    """
    canon_d, sigma_d, cu_d, cc_d, q2c_d, cn_d, rep_d = _level2_program(
        u, c, uv, cap, nvs, with_domains, use_kernel, method
    )
    q = int(n_final)
    pc = int(cn_d)
    sigma = sigma_d[:q].cpu().numpy().astype(np.int32)
    q2c = q2c_d[:q].cpu().numpy().astype(np.int32)
    cu = cu_d[:pc].cpu().numpy().astype(np.int64)
    cc = cc_d[:pc].cpu().numpy().astype(np.int64)
    canon_rows = canon_d[:q].cpu().numpy().astype(np.int64)
    if with_domains:
        orbits = rep_d[:pc].cpu().numpy().astype(np.int32)
    else:
        orbits = np.tile(
            np.arange(pattern_lib.MAX_PATTERN_VERTICES, dtype=np.int32),
            (pc, 1),
        )
    nbytes = (sigma.nbytes + q2c.nbytes + cu.nbytes + cc.nbytes
              + canon_rows.nbytes + (orbits.nbytes if with_domains else 0) + 4)
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
    pattern_lib.seed_memo(
        quick_codes, canon_rows, sigma,
        canon_codes=cu if with_domains else None,
        orbits=orbits if with_domains else None,
    )
    return table, cc, nbytes


def level2_nvs(app, size: int) -> tuple:
    """The nv set of the patterns a step of ``size`` may emit. Vertex mode
    explores fixed-size embeddings (nv == size); edge mode's connected
    embeddings of k edges span 2..min(k+1, 8) vertices (the tree upper
    bound, capped at the 8-vertex encoding limit)."""
    if getattr(app, "mode", "vertex") == "edge":
        hi = min(int(size) + 1, pattern_lib.MAX_PATTERN_VERTICES)
        return tuple(range(2, hi + 1))
    return (min(int(size), pattern_lib.MAX_PATTERN_VERTICES),)


def level2_device_tables(table: pattern_lib.PatternTable, cap: int, device):
    """Upload the level-2 mapping for device phase-2 consumers (the domain
    scatter): ``q2c`` (cap,) int32 padded with -1 and ``sigma_inv``
    (cap, 8) int32 (canonical pos -> local pos)."""
    q = len(table.quick_codes)
    q2c = np.full(cap, -1, np.int32)
    q2c[:q] = table.quick_to_canon
    si = np.zeros((cap, pattern_lib.MAX_PATTERN_VERTICES), np.int32)
    si[:q] = np.argsort(table.sigma, axis=1)
    return (torch.from_numpy(q2c).to(device),
            torch.from_numpy(si).to(device))


#: rows of one slice of :func:`scatter_canon_bitmaps`: its temporaries,
#: about 250 bytes a row, stay near 1 GiB however large the batch.
SCATTER_SLICE_ROWS = 1 << 22


def scatter_canon_bitmaps(bm_flat, slot, lv, q2c, sigma_inv,
                          pc_cap: int, n_vertices: int):
    """Phase-2 FSM domain scatter (device): accumulate one batch of rows,
    in place, into the flat (pc_cap * 8 * N + 1,) bool canonical-position
    bitmap threaded across batches (last slot = dump).

    ``slot`` is the per-row quick slot (final table order), ``q2c`` /
    ``sigma_inv`` the uploaded level-2 tables; vertex ``lv[r,
    sigma_inv[p]]`` lands at canonical position ``p`` — the same
    re-ordering :func:`map_to_canonical_positions` applies on the host.
    Rows scatter in slices of :data:`SCATTER_SLICE_ROWS` (setting bits is
    order-free, so the result is the one scatter's)."""
    want = pc_cap * pattern_lib.MAX_PATTERN_VERTICES * n_vertices + 1
    if bm_flat.shape[0] != want:
        raise ValueError(f"bm_flat: expected ({want},), got "
                         f"{tuple(bm_flat.shape)}")
    for lo in range(0, slot.shape[0], SCATTER_SLICE_ROWS):
        part = slot[lo: lo + SCATTER_SLICE_ROWS]
        safe = part.clamp(min=0).to(torch.int64)
        cs = torch.where(part >= 0, q2c[safe], -1)                 # (b,)
        vc = torch.gather(lv[lo: lo + SCATTER_SLICE_ROWS], 1,
                          sigma_inv[safe].to(torch.int64))         # (b, 8)
        ok = (vc >= 0) & (cs[:, None] >= 0)
        bm_flat = _scatter_flat(bm_flat, cs, vc, ok, n_vertices)
    return bm_flat
