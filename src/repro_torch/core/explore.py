"""Vectorised embedding expansion — the inner loop of Algorithm 1, port of
``repro.core.explore`` (vertex mode).

One exploration step takes a frontier of canonical embeddings (each a row of
vertex ids in visit order) and produces every canonical child obtained by
adding one neighbouring vertex, deduplicated within the parent and filtered
by the embedding-canonicality check. Candidates form a dense padded tensor
``(C, k, D)`` from the padded neighbour table, and every pruning rule is a
mask expression; the engine chunks the frontier so this tensor stays
bounded.

:func:`fused_chunk_step` is the single device pass of the fused superstep
pipeline (DESIGN.md §8): expansion + canonicality + app filter + stream
compaction + the children's quick-pattern codes. On a
:class:`PartitionedGraph` it opens with the tile-gather stage
(:func:`build_tile_view`, DESIGN.md §11). Edge mode is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitset, canonical, pattern as pattern_lib
from repro_torch.core.graph import DeviceGraph, PartitionedGraph
from repro_torch.kernels import aggregate as aggregate_kernel_lib
from repro_torch.kernels import compact as compact_kernel_lib
from repro_torch.kernels import gather as gather_kernel_lib
from repro_torch.kernels.canonical_check.canonical_check import expand_masks
from repro_torch.kernels.canonical_check import ops as cc_ops


def _require_vertex(mode: str) -> None:
    if mode != "vertex":
        raise NotImplementedError(
            "edge-mode exploration comes with FSM; see ROADMAP.md"
        )


class TileView(NamedTuple):
    """One chunk's gathered halo of a :class:`PartitionedGraph`
    (DESIGN.md §11): the ascending unique member vertices with their
    neighbour and packed-adjacency rows gathered into dense tiles, plus the
    whole id/label payload. Everything downstream of expansion
    (canonicality, app filters, the children's quick patterns) reads this
    view instead of a whole-graph table.

    Rows are *tile-local*; columns of ``adj_t`` stay global, so one
    resident endpoint resolves any pairwise adjacency query —
    :meth:`is_edge` tries both sides, and every pair the pipeline asks
    about (member↔candidate, child-embedding pairs) has at most one
    non-member vertex."""

    uniq: torch.Tensor         # (U,) int32 ascending halo ids, pad sentinel n
    labels: torch.Tensor       # (n,) int32
    edge_uv: torch.Tensor      # (m, 2) int32
    edge_labels: torch.Tensor  # (m,) int32
    nbr_t: torch.Tensor        # (U, D) int32 gathered neighbour rows, pad -1
    nbr_eid_t: torch.Tensor    # (U, 0) int32: edge mode (not ported) reads it
    adj_t: torch.Tensor        # (U, W) int32 gathered adjacency rows

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    @property
    def m(self) -> int:
        return self.edge_uv.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr_t.shape[1]

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def rank(self, v):
        """(tile row of each global id, hit mask). ``uniq`` is ascending
        with sentinel-``n`` padding, so translation is one searchsorted;
        misses return a clamped-safe row with ``hit=False``."""
        key = v.clamp(0, self.n).to(self.uniq.dtype)
        r = torch.searchsorted(self.uniq, key)
        r = r.clamp(max=self.uniq.shape[0] - 1).to(torch.int32)
        return r, (self.uniq[r] == v) & (v >= 0)

    def is_edge(self, u, v):
        """Symmetric O(1) edge query resolved from whichever endpoint is
        tile-resident (False when neither is, or for out-of-range ids) —
        the total-graph contract every generic caller (quick patterns, app
        filters) relies on."""
        ru, hu = self.rank(u)
        rv, hv = self.rank(v)
        return (
            bitset.test_bit(self.adj_t, torch.where(hu, ru, -1), v)
            | bitset.test_bit(self.adj_t, torch.where(hv, rv, -1), u)
        )


def halo_cap(members_shape, mode: str, n: int) -> int:
    """Static tile capacity for a chunk: the distinct halo can never exceed
    min(member-vertex slots, n), so the pow2 of that bound makes tile
    overflow impossible by construction — no new host syncs, no retry."""
    c, k = members_shape
    slots = c * k * (2 if mode == "edge" else 1)
    # pow2 bucket (config.next_pow2 inlined: runtime.config imports would
    # cycle through the runtime package __init__)
    return 1 << max(0, (max(min(slots, int(n)), 1) - 1).bit_length())


def halo_vertices(g, members, n_valid, mode: str):
    """Flat (possibly duplicated) halo vertex ids of a chunk: the members
    themselves (vertex mode); invalid slots -1. Edge mode (member-edge
    endpoints) comes with FSM."""
    _require_vertex(mode)
    k = members.shape[1]
    valid = torch.arange(k, device=members.device)[None, :] < n_valid[:, None]
    return members.masked_fill(~valid, -1).reshape(-1)


def build_tile_view(
    g: PartitionedGraph,
    members: torch.Tensor,
    n_valid: torch.Tensor,
    mode: str,
    *,
    use_pallas: bool = False,
    compact_kernel: bool = False,
) -> TileView:
    """The tile-gather stage of the fused pipeline on one process: halo
    unique (presence table + stream compaction, ``kernels/gather.py``)
    followed by row gathers from the shard-stacked tables through the
    global->flat translation of ``PartitionedGraph.flat_index``. No host
    sync: the tile capacity is a static function of the chunk shape."""
    _require_vertex(mode)
    cap = halo_cap(members.shape, mode, g.n)
    verts = halo_vertices(g, members, n_valid, mode)
    uniq, _ = gather_kernel_lib.halo_unique(
        verts, g.n, cap, use_kernel=compact_kernel
    )
    fi, ok = g.flat_index(uniq)
    fi = torch.where(ok, fi, -1)
    d, w = g.max_degree, g.adj_sh.shape[2]
    nbr_t = gather_kernel_lib.gather_rows(
        g.nbr_sh.reshape(-1, d), fi, -1, use_kernel=use_pallas
    )
    adj_t = gather_kernel_lib.gather_rows(
        g.adj_sh.reshape(-1, w), fi, 0, use_kernel=use_pallas
    )
    return TileView(
        uniq=uniq,
        labels=g.labels,
        edge_uv=g.edge_uv,
        edge_labels=g.edge_labels,
        nbr_t=nbr_t,
        nbr_eid_t=torch.zeros((cap, 0), dtype=torch.int32,
                              device=members.device),
        adj_t=adj_t,
    )


def member_tile_rows(view: TileView, members, n_valid):
    """(tile row of each member slot, -1 where the slot is invalid or
    missed the tile; the mask of slots whose row is read). Members are
    halo-resident by construction, so every valid slot hits."""
    k = members.shape[1]
    member_ok = (torch.arange(k, device=members.device)[None, :]
                 < n_valid[:, None])
    ranks, in_tile = view.rank(members)
    row_ok = member_ok & in_tile
    return torch.where(row_ok, ranks, -1), row_ok


class Expansion(NamedTuple):
    """Flattened candidate set for one frontier chunk (before compaction)."""

    rows: torch.Tensor         # (Ncand,) int32 parent row in the chunk
    cand: torch.Tensor         # (Ncand,) int32 extension vertex id
    keep: torch.Tensor         # (Ncand,) bool — canonical, deduped, valid
    n_generated: torch.Tensor  # () int32 raw candidate slots that were valid
    n_canonical: torch.Tensor  # () int32 survivors of the canonicality check


def _flat_rows(c: int, per_row: int, device) -> torch.Tensor:
    return torch.arange(c, dtype=torch.int32, device=device).repeat_interleave(
        per_row
    )


def expand_vertex(
    g: DeviceGraph,
    members: torch.Tensor,   # (C, k) int32, pad -1
    n_valid: torch.Tensor,   # (C,) int32
    *,
    use_pallas: bool = False,
    fused: bool = False,
) -> Expansion:
    """Candidates for vertex-induced exploration.

    A candidate slot (c, i, j) is neighbour j of member i of embedding c.
    Kept iff: slot valid; vertex not already a member; this is the *first*
    occurrence (no earlier member is adjacent to it); and the extended
    embedding passes the incremental canonicality check.

    ``use_pallas`` routes the canonicality check through the
    ``canonical_check`` kernel; ``fused`` additionally evaluates the
    validity masks inside the ``expand_canonical`` kernel, skipping the
    ``(C, k, k, D)`` intermediate. (The knob keeps the JAX package's name.)

    On a :class:`TileView` the member-rooted lookups go through the
    members' tile ranks while ids stay global, and the check is the
    tile-indexed ``canonical_check_tiles``; ``fused`` does not apply there
    (the view has no whole-graph tables), as in the reference.
    """
    tiled = isinstance(g, TileView)
    if use_pallas and fused and not tiled:
        return _expand_vertex_fused(g, members, n_valid)
    c, k = members.shape
    d = g.max_degree
    dev = members.device
    if tiled:
        mrow, row_ok = member_tile_rows(g, members, n_valid)
        cand, valid = expand_masks(members, n_valid, g.nbr_t, g.adj_t,
                                   rows=mrow, row_ok=row_ok)
    else:
        cand, valid = expand_masks(members, n_valid, g.nbr, g.adj_bits)

    flat_cand = cand.reshape(c * k * d)
    flat_rows = _flat_rows(c, k * d, dev)
    flat_valid = valid.reshape(c * k * d)

    if tiled:
        canon = cc_ops.canonical_check_tiles(
            members[flat_rows], mrow[flat_rows], n_valid[flat_rows],
            flat_cand, g.adj_t, use_pallas=use_pallas,
        )
    elif use_pallas:
        canon = cc_ops.canonical_check(
            g, members[flat_rows], n_valid[flat_rows], flat_cand,
            mode="vertex",
        )
    else:
        canon = canonical.vertex_check(
            g, members[flat_rows], n_valid[flat_rows], flat_cand
        )
    keep = flat_valid & canon
    return Expansion(
        rows=flat_rows,
        cand=flat_cand,
        keep=keep,
        n_generated=flat_valid.sum(dtype=torch.int32),
        n_canonical=keep.sum(dtype=torch.int32),
    )


def _expand_vertex_fused(g, members, n_valid) -> Expansion:
    """Vertex expansion through the fused ``expand_canonical`` kernel:
    validity + dedup + Alg.-2 in one pass, flattened to the same Expansion
    contract as the unfused path."""
    c, k = members.shape
    d = g.max_degree
    cand, valid, keep = cc_ops.expand_canonical(g, members, n_valid)
    keep = keep.reshape(c * k * d)
    return Expansion(
        rows=_flat_rows(c, k * d, members.device),
        cand=cand.reshape(c * k * d),
        keep=keep,
        n_generated=valid.sum(dtype=torch.int32),
        n_canonical=keep.sum(dtype=torch.int32),
    )


def compact(
    members: torch.Tensor,   # (C, k) parents of the chunk
    exp: Expansion,
    keep: torch.Tensor,      # (Ncand,) final keep mask (after app filter)
    out_cap: int,
    *,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather kept candidates into a dense (out_cap, k+1) child frontier.

    Returns (children, count). ``count`` may exceed ``out_cap``: the caller
    must then retry with a larger capacity. ``use_kernel`` routes the
    keep-mask compaction through the stream-compaction kernel instead of the
    plain cumsum + scatter; both honour the same contract."""
    dev = members.device
    if use_kernel:
        idx, count = compact_kernel_lib.stream_compact_cuda(keep, out_cap)
    else:
        idx, count = compact_kernel_lib.stream_compact_ref(keep, out_cap)
    slot_valid = torch.arange(out_cap, device=dev) < count
    rows = exp.rows[idx]
    cand = exp.cand[idx]
    children = torch.cat([members[rows], cand[:, None]], dim=1)
    children = children.masked_fill(~slot_valid[:, None], -1)
    return children, count


def expand_and_compact(
    g: DeviceGraph,
    members: torch.Tensor,
    n_valid: torch.Tensor,
    mode: str,
    out_cap: int,
    use_pallas: bool = False,
    fused: bool = False,
    compact_kernel: bool = False,
):
    """Expand + canonicality + compaction (no app filter). Returns
    ``(children, count, n_generated, n_canonical)``."""
    _require_vertex(mode)
    if isinstance(g, PartitionedGraph):
        g = build_tile_view(g, members, n_valid, mode, use_pallas=use_pallas,
                            compact_kernel=compact_kernel)
    exp = expand_vertex(g, members, n_valid, use_pallas=use_pallas,
                        fused=fused)
    children, count = compact(
        members, exp, exp.keep, out_cap, use_kernel=compact_kernel
    )
    return children, count, exp.n_generated, exp.n_canonical


def fused_chunk_step(
    g: DeviceGraph,
    members: torch.Tensor,   # (C, k) int32 frontier chunk, pad -1
    n_valid: torch.Tensor,   # (C,) int32
    out_cap: int,
    *,
    mode: str,
    app=None,
    with_patterns: bool = False,
    with_aggregates: bool = False,
    agg_qcap: int = 4096,
    with_local_verts: bool = True,
    use_pallas: bool = False,
    fused: bool = False,
    compact_kernel: bool = False,
    aggregate_kernel: bool = False,
    aggregate_bin: str = "sort",
):
    """ONE device pass of the fused superstep pipeline (DESIGN.md §8):
    expansion + canonicality + the app's phi filter + stream compaction +
    (optionally) the children's quick-pattern codes. No host sync.

    Returns ``(children, count, codes, local_verts, n_generated,
    n_canonical)``. ``count`` is the unclamped kept total; with
    ``with_patterns`` the codes/local-vertex tables are ``(out_cap, 3)`` /
    ``(out_cap, 8)`` aligned with ``children``, else 0-row placeholders.

    ``with_aggregates`` (DESIGN.md §10, exclusive with ``with_patterns``)
    bins the children's quick codes into a per-chunk level-1 PARTIAL in the
    same pass and returns the 7-tuple ``(children, count, uniq (acap, 3),
    ucounts (acap,) int32, n_uniq, n_generated, n_canonical)`` where
    ``acap = min(out_cap, agg_qcap)``; ``n_uniq`` is unclamped, so an
    overflowing partial is detected at the fold.

    With a :class:`PartitionedGraph` the pass opens with the tile-gather
    stage (:func:`build_tile_view`) and every downstream consumer —
    expansion, canonicality, the app filter, the children's quick patterns
    — runs on the :class:`TileView`; the output contract is unchanged. A
    pre-built ``TileView`` is accepted too."""
    _require_vertex(mode)
    dev = members.device
    if isinstance(g, PartitionedGraph):
        g = build_tile_view(g, members, n_valid, mode, use_pallas=use_pallas,
                            compact_kernel=compact_kernel)
    exp = expand_vertex(g, members, n_valid, use_pallas=use_pallas,
                        fused=fused)
    keep = exp.keep
    if app is not None:
        keep = keep & app.filter(g, members, n_valid, exp.rows, exp.cand)
    children, count = compact(
        members, exp, keep, out_cap, use_kernel=compact_kernel
    )
    if with_patterns or with_aggregates:
        child_k = members.shape[1] + 1
        child_nv = torch.where(
            torch.arange(out_cap, device=dev) < count, child_k, 0
        ).to(torch.int32)
        qp = pattern_lib.quick_pattern_vertex(g, children, child_nv)
        if with_aggregates:
            uniq, ucounts, _, n_uniq, _ = aggregate_kernel_lib.bin_rows(
                qp.codes, child_nv > 0, min(out_cap, agg_qcap),
                use_kernel=aggregate_kernel, method=aggregate_bin,
            )
            # the partial crosses chunks as int32: SATURATE at the I32_SAT
            # sentinel instead of wrapping — fold_partial detects the
            # sentinel and the step re-folds wide (DESIGN.md §13)
            ucounts32 = ucounts.clamp(max=aggregate_kernel_lib.I32_SAT).to(
                torch.int32
            )
            return (children, count, uniq, ucounts32,
                    n_uniq, exp.n_generated, exp.n_canonical)
        codes = qp.codes
        local_verts = (
            qp.local_verts
            if with_local_verts
            else torch.zeros((0, pattern_lib.MAX_PATTERN_VERTICES),
                             dtype=torch.int32, device=dev)
        )
    else:
        codes = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        local_verts = torch.zeros((0, pattern_lib.MAX_PATTERN_VERTICES),
                                  dtype=torch.int32, device=dev)
    return children, count, codes, local_verts, exp.n_generated, exp.n_canonical
