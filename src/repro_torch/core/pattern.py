"""Quick patterns and canonical patterns (port of ``repro.core.pattern``).

Level 1 (device, per embedding, linear time): a *quick pattern* is the
order-dependent encoding of an embedding's structure — local vertex labels
in visit order plus the adjacency bits among local positions.

Level 2 (once per distinct quick pattern, on the host): canonicalisation —
the minimum encoding over all vertex-position permutations, batched and
memoised process-wide in an LRU, and for FSM's min-image domains the
automorphism orbits of each canonical pattern, memoised the same way. The
pure math lives in :mod:`repro_torch.core.canon_math`, a copy of the JAX
package's module.

Encoding (3 × int64 per pattern):
  w0 = n_vertices | adj_bits << 4     (pair (a<b) -> bit b*(b-1)/2 + a)
  w1 = labels[0..3], 8 bits each      (labels must be < 256)
  w2 = labels[4..7], 8 bits each
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph import DeviceGraph
from repro_torch.core.canon_math import (
    MAX_PATTERN_VERTICES,
    _canonicalize_batch,
    _pair_bit,
    automorphism_orbits,
    decode,
)


class QuickPatterns(NamedTuple):
    codes: torch.Tensor        # (B, 3) int64 quick-pattern code per embedding
    local_verts: torch.Tensor  # (B, 8) int32 graph vertex at local position, pad -1
    n_verts: torch.Tensor      # (B,) int32


def quick_pattern_vertex(
    g: DeviceGraph, members: torch.Tensor, n_valid: torch.Tensor
) -> QuickPatterns:
    """Quick patterns of vertex-induced embeddings: local positions are the
    members in visit order; adjacency = all graph edges among members."""
    b, k = members.shape
    pos = torch.arange(k, device=members.device)
    valid = pos[None, :] < n_valid[:, None]
    mem = members.masked_fill(~valid, -1)

    adj = g.is_edge(mem[:, :, None], mem[:, None, :])            # (B, k, k)
    bits = torch.zeros((b,), dtype=torch.int64, device=members.device)
    for a in range(k):
        for c in range(a + 1, k):
            bits = bits | (adj[:, a, c].to(torch.int64) << _pair_bit(a, c))

    labels = g.labels[mem.clamp(min=0)].masked_fill(~valid, 0)   # (B, k)
    w1 = torch.zeros((b,), dtype=torch.int64, device=members.device)
    w2 = torch.zeros((b,), dtype=torch.int64, device=members.device)
    for i in range(min(k, 4)):
        w1 = w1 | (labels[:, i].to(torch.int64) << (8 * i))
    for i in range(4, min(k, 8)):
        w2 = w2 | (labels[:, i].to(torch.int64) << (8 * (i - 4)))

    w0 = n_valid.to(torch.int64) | (bits << 4)
    codes = torch.stack([w0, w1, w2], dim=1)
    lv = torch.full((b, MAX_PATTERN_VERTICES), -1, dtype=torch.int32,
                    device=members.device)
    lv[:, :k] = mem.to(torch.int32)
    return QuickPatterns(codes=codes, local_verts=lv, n_verts=n_valid)


#: device bytes the temporaries of one row slice of
#: :func:`quick_pattern_edge` may take (about 1 GiB).
QUICK_EDGE_SLICE_BYTES = 1 << 30


def quick_edge_slice_rows(k: int) -> int:
    """Rows of one :func:`quick_pattern_edge` slice at ``k`` member edges:
    its temporaries, about two (B, 2k, 2k) byte tensors and forty bytes a
    slot of (B, 2k) ones, stay under :data:`QUICK_EDGE_SLICE_BYTES`
    (2,396,745 rows at k = 4)."""
    k2 = 2 * k
    return max(1, QUICK_EDGE_SLICE_BYTES // (2 * k2 * k2 + 40 * k2))


def quick_pattern_edge(
    g: DeviceGraph, members: torch.Tensor, n_valid: torch.Tensor,
    slice_rows: Optional[int] = None,
) -> QuickPatterns:
    """Quick patterns of edge-induced embeddings.

    Local vertices = endpoint sequence deduplicated in first-appearance
    order; adjacency bits cover *member edges only* (edge-induced
    semantics: non-member graph edges between the same vertices are
    excluded). ``g`` may be a :class:`DeviceGraph` or a tile view: only
    ``edge_uv`` and ``labels`` are read.

    A per-row function: it runs over slices of ``slice_rows`` rows
    (:func:`quick_edge_slice_rows` by default) written into outputs
    allocated once, so a large wave's temporaries stay bounded. The slices
    need no host sync.
    """
    b, k = members.shape
    dev = members.device
    step = slice_rows or quick_edge_slice_rows(k)
    if b <= step:
        return _quick_pattern_edge_rows(g, members, n_valid)
    codes = torch.empty((b, 3), dtype=torch.int64, device=dev)
    lv = torch.empty((b, MAX_PATTERN_VERTICES), dtype=torch.int32,
                     device=dev)
    n_verts = torch.empty((b,), dtype=torch.int32, device=dev)
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        part = _quick_pattern_edge_rows(g, members[lo:hi], n_valid[lo:hi])
        codes[lo:hi] = part.codes
        lv[lo:hi] = part.local_verts
        n_verts[lo:hi] = part.n_verts
        del part
    return QuickPatterns(codes=codes, local_verts=lv, n_verts=n_verts)


def _quick_pattern_edge_rows(g, members, n_valid) -> QuickPatterns:
    """:func:`quick_pattern_edge` on one slice. Local ids, ranks and first
    slots are int8 (2k <= 16)."""
    b, k = members.shape
    k2 = 2 * k
    dev = members.device
    pos = torch.arange(k, device=dev)
    valid_e = pos[None, :] < n_valid[:, None]                    # (B, k)
    safe = members.clamp(0, g.edge_uv.shape[0] - 1)
    verts = g.edge_uv[safe].reshape(b, k2)                       # (B, 2k)
    vert_ok = valid_e.repeat_interleave(2, dim=1)
    verts = verts.masked_fill(~vert_ok, -1)

    # first-appearance local ids: the first slot holding each vertex
    t = torch.arange(k2, dtype=torch.int8, device=dev)
    same = verts[:, :, None] == verts[:, None, :]
    same &= vert_ok[:, :, None]
    same &= vert_ok[:, None, :]
    # argmax of the first True (0 where none, as jnp.argmax gives); int8
    # keeps the (B, 2k, 2k) temporary at a byte a pair
    first_idx = torch.where(same, t[:, None], k2).amin(dim=1)   # (B, 2k)
    del same
    first_idx = first_idx.masked_fill(first_idx == k2, 0)
    is_first = (first_idx == t[None, :]) & vert_ok
    rank = torch.cumsum(is_first, dim=1, dtype=torch.int8) - 1  # local ids
    local_id = torch.gather(rank, 1, first_idx.to(torch.int64))  # (B, 2k)
    local_id = local_id.masked_fill(~vert_ok, -1)
    n_verts = is_first.sum(dim=1, dtype=torch.int32)

    # local vertex table: first-appearance vertices scattered to their rank,
    # every other slot (a -1) to the dump column 8, so each kept column is
    # written once and the scatter is deterministic
    scatter_pos = torch.where(is_first, rank, MAX_PATTERN_VERTICES)
    lv = torch.full((b, MAX_PATTERN_VERTICES + 1), -1, dtype=torch.int32,
                    device=dev)
    lv.scatter_(1, scatter_pos.to(torch.int64), verts.masked_fill(
        ~is_first, -1).to(torch.int32))
    lv = lv[:, :MAX_PATTERN_VERTICES].contiguous()

    # adjacency bits from member edges
    a_id = local_id[:, 0::2].long()                              # (B, k)
    b_id = local_id[:, 1::2].long()
    lo = torch.minimum(a_id, b_id)
    hi = torch.maximum(a_id, b_id)
    bit = torch.where(valid_e, (hi * (hi - 1)) // 2 + lo, 0)
    bits = torch.zeros((b,), dtype=torch.int64, device=dev)
    for j in range(k):
        contrib = torch.where(valid_e[:, j], torch.ones_like(bits) << bit[:, j],
                              0)
        bits = bits | contrib

    labels = g.labels[lv.clamp(min=0)].masked_fill(lv < 0, 0)    # (B, 8)
    w1 = torch.zeros((b,), dtype=torch.int64, device=dev)
    w2 = torch.zeros((b,), dtype=torch.int64, device=dev)
    for i in range(4):
        w1 = w1 | (labels[:, i].to(torch.int64) << (8 * i))
        w2 = w2 | (labels[:, i + 4].to(torch.int64) << (8 * i))
    w0 = n_verts.to(torch.int64) | (bits << 4)
    return QuickPatterns(
        codes=torch.stack([w0, w1, w2], dim=1), local_verts=lv,
        n_verts=n_verts,
    )


# ---------------------------------------------------------------------------
# Process-wide quick -> canonical memo (thread-safe, bounded LRU)
# ---------------------------------------------------------------------------

#: default LRU cap: generous (a million distinct patterns ≈ 50 MB of memo)
#: but finite — labeled-graph workloads otherwise grow the memo without
#: bound for the lifetime of the process.
DEFAULT_MEMO_CAP = 1 << 20

_MEMO_LOCK = threading.Lock()
#: quick code-row bytes -> (canon (3,) int64, sigma (8,) int32). Quick
#: patterns recur across supersteps and runs (the paper's engine accumulates
#: exactly this map), so level 2 pays the permutation search once per
#: distinct pattern per process, not per step.
_CANON_CACHE: "OrderedDict[bytes, tuple]" = OrderedDict()
#: canonical code tuple -> orbit representatives (8,) int32 (FSM domains).
_ORBIT_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_MEMO_CAP = DEFAULT_MEMO_CAP


def set_memo_cap(cap: Optional[int]) -> int:
    """Set the LRU cap of the canonical/orbit memos; returns the old cap.

    ``None`` restores :data:`DEFAULT_MEMO_CAP`. Shrinking evicts
    least-recently-used entries immediately.
    """
    global _MEMO_CAP
    with _MEMO_LOCK:
        old = _MEMO_CAP
        _MEMO_CAP = DEFAULT_MEMO_CAP if cap is None else max(1, int(cap))
        while len(_CANON_CACHE) > _MEMO_CAP:
            _CANON_CACHE.popitem(last=False)
        while len(_ORBIT_CACHE) > _MEMO_CAP:
            _ORBIT_CACHE.popitem(last=False)
    return old


def clear_memo() -> None:
    """Drop every memoised canonicalisation (cold timing, parity tests)."""
    with _MEMO_LOCK:
        _CANON_CACHE.clear()
        _ORBIT_CACHE.clear()


def memo_sizes() -> tuple[int, int]:
    """(canon entries, orbit entries) currently memoised."""
    with _MEMO_LOCK:
        return len(_CANON_CACHE), len(_ORBIT_CACHE)


def _memo_get_canon(keys: list) -> dict:
    """Snapshot memo hits for ``keys`` (marks them recently used)."""
    out = {}
    with _MEMO_LOCK:
        for k in keys:
            got = _CANON_CACHE.get(k)
            if got is not None:
                _CANON_CACHE.move_to_end(k)
                out[k] = got
    return out


def _memo_put_canon(items) -> None:
    with _MEMO_LOCK:
        for k, v in items:
            _CANON_CACHE[k] = v
            _CANON_CACHE.move_to_end(k)
        while len(_CANON_CACHE) > _MEMO_CAP:
            _CANON_CACHE.popitem(last=False)


class PatternTable(NamedTuple):
    """Mapping of the step's unique quick patterns to canonical patterns."""

    quick_codes: np.ndarray      # (Q, 3) int64 unique quick codes
    canon_codes: np.ndarray      # (Pc, 3) int64 unique canonical codes
    quick_to_canon: np.ndarray   # (Q,) int32 canonical slot per quick slot
    sigma: np.ndarray            # (Q, 8) int32 local pos -> canonical pos
    canon_n_verts: np.ndarray    # (Pc,) int32
    canon_orbits: np.ndarray     # (Pc, 8) int32 orbit representative per pos
    n_iso_checks: int            # == Q: graph-isomorphism invocations (Table 4)


def build_pattern_table(
    unique_quick: np.ndarray,
    with_orbits: bool = True,
    canon_fn: Optional[Callable[[np.ndarray], tuple]] = None,
) -> PatternTable:
    """Level 2 for one step's distinct quick patterns, batched + memoised.

    Uncached codes are canonicalised in vectorised per-``n_verts`` batches
    (:func:`canon_math._canonicalize_batch`) and remembered process-wide, so
    the permutation search runs once per distinct pattern per process —
    across supersteps AND runs. ``n_iso_checks`` stays the *conceptual*
    per-step invocation count (Table 4 semantics), not the cache-miss
    count.

    ``canon_fn`` (optional) replaces the host permutation search for the
    cache *misses*: it receives the (M, 3) int64 miss codes (mixed nv) and
    returns ``(canon (M, 3) int64, sigma (M, 8) int32)`` under the exact
    :func:`canonicalize_one` contract — the hook the device placement
    (``kernels/canonical_refine``) plugs into. Memoisation still applies.

    ``with_orbits=False`` skips the automorphism-orbit search (only FSM's
    min-image domains consume orbits) and returns identity representatives.
    """
    q = len(unique_quick)
    canon = np.zeros((q, 3), dtype=np.int64)
    sigma = np.zeros((q, MAX_PATTERN_VERTICES), dtype=np.int32)
    rows64 = np.ascontiguousarray(unique_quick, dtype=np.int64)
    keys = [row.tobytes() for row in rows64]
    # hits snapshotted into a local dict so concurrent eviction can never
    # drop an entry between the miss pass and the fill loop below.
    local = _memo_get_canon(keys)
    misses = [i for i, k in enumerate(keys) if k not in local]
    if misses:
        miss_codes = rows64[misses]
        if canon_fn is not None:
            ck, sg = canon_fn(miss_codes)
            fresh = [(keys[i], (ck[j], sg[j])) for j, i in enumerate(misses)]
        else:
            fresh = []
            by_nv: dict[int, list] = {}
            for j in range(len(misses)):
                by_nv.setdefault(int(miss_codes[j, 0]) & 0xF, []).append(j)
            for js in by_nv.values():
                ck, sg = _canonicalize_batch(miss_codes[js])
                for row, j in enumerate(js):
                    fresh.append((keys[misses[j]], (ck[row], sg[row])))
        local.update(fresh)
        _memo_put_canon(fresh)
    for i, k in enumerate(keys):
        canon[i], sigma[i] = local[k]
    uniq_canon, inv = np.unique(canon.reshape(q, 3), axis=0, return_inverse=True)
    if with_orbits and len(uniq_canon):
        orbits = np.stack([_orbits_cached(c) for c in uniq_canon], axis=0)
    else:
        orbits = np.tile(
            np.arange(MAX_PATTERN_VERTICES, dtype=np.int32),
            (len(uniq_canon), 1),
        )
    return PatternTable(
        quick_codes=unique_quick,
        canon_codes=uniq_canon,
        quick_to_canon=inv.astype(np.int32),
        sigma=sigma,
        canon_n_verts=(uniq_canon[:, 0] & 0xF).astype(np.int32),
        canon_orbits=orbits,
        n_iso_checks=q,
    )


def _orbits_cached(code: np.ndarray) -> np.ndarray:
    key = tuple(int(x) for x in code)
    with _MEMO_LOCK:
        got = _ORBIT_CACHE.get(key)
        if got is not None:
            _ORBIT_CACHE.move_to_end(key)
            return got
    got = automorphism_orbits(code)
    with _MEMO_LOCK:
        _ORBIT_CACHE[key] = got
        while len(_ORBIT_CACHE) > _MEMO_CAP:
            _ORBIT_CACHE.popitem(last=False)
    return got


def seed_memo(quick_codes: np.ndarray, canon: np.ndarray, sigma: np.ndarray,
              canon_codes: Optional[np.ndarray] = None,
              orbits: Optional[np.ndarray] = None) -> None:
    """Warm the memo with externally computed (device) canonicalisations
    (and, for FSM, the canonical codes' orbits) so later host passes over
    the same patterns are cache hits."""
    rows64 = np.ascontiguousarray(quick_codes, dtype=np.int64)
    _memo_put_canon(
        (rows64[i].tobytes(), (canon[i], sigma[i])) for i in range(len(rows64))
    )
    if canon_codes is not None and orbits is not None:
        with _MEMO_LOCK:
            for i in range(len(canon_codes)):
                key = tuple(int(x) for x in canon_codes[i])
                _ORBIT_CACHE[key] = np.asarray(orbits[i], dtype=np.int32)
            while len(_ORBIT_CACHE) > _MEMO_CAP:
                _ORBIT_CACHE.popitem(last=False)


def pattern_to_networkx(code):
    """A canonical (or quick) code as a labelled ``networkx.Graph``."""
    import networkx as nx

    nv, adj, labels = decode(np.asarray(code))
    g = nx.Graph()
    for i in range(nv):
        g.add_node(i, label=int(labels[i]))
    for i in range(nv):
        for j in range(i + 1, nv):
            if adj[i, j]:
                g.add_edge(i, j)
    return g
