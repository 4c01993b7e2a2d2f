"""Vectorised incremental embedding-canonicality checks (paper Alg. 2),
port of ``repro.core.canonical``.

Uniqueness + extendibility (paper Appendix, Thm 2/3) guarantee that pruning
non-canonical candidates removes every automorphic duplicate while keeping
exactly one representative, with no cross-worker coordination. The checks
are branch-free mask expressions over a whole batch of candidates at once.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.core.graph import DeviceGraph


def vertex_check_bits(
    adj_bits: torch.Tensor,  # (N, W) int32 packed adjacency
    members: torch.Tensor,   # (B, k) int32 parent vertices in visit order, pad -1
    n_valid: torch.Tensor,   # (B,) int32 number of valid members
    cand: torch.Tensor,      # (B,) int32 candidate extension vertex
) -> torch.Tensor:
    """True iff ``members[:n_valid] + [cand]`` is canonical (Alg. 2), with
    adjacency read from the packed bitmap. Rows with ``n_valid == 0`` are
    the bootstrap case: every single vertex is canonical."""
    b, k = members.shape
    pos = torch.arange(k, device=members.device)[None, :]
    valid = pos < n_valid[:, None]

    # Alg.2 line 1: if v1 > v -> false.
    first_ok = torch.where(n_valid > 0, members[:, 0] < cand, True)

    # neighbour mask of cand among the (valid) members.
    neigh = bitset.test_bit(adj_bits, members, cand[:, None]) & valid

    # foundNeighbour becomes true strictly *after* the first neighbour index:
    # elements before/at the first neighbour are exempt from the id test.
    found_after = torch.cumsum(neigh.to(torch.int32), dim=1, dtype=torch.int32) > 0
    found_before = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=members.device),
         found_after[:, :-1]], dim=1,
    )
    violation = valid & found_before & (members > cand[:, None])
    return first_ok & ~violation.any(dim=1)


def vertex_check(
    g: DeviceGraph,
    members: torch.Tensor,
    n_valid: torch.Tensor,
    cand: torch.Tensor,
) -> torch.Tensor:
    """Alg. 2 against ``g`` (see :func:`vertex_check_bits`). Assumes the
    parent itself is canonical and that ``cand`` is adjacent to at least one
    member (true by construction of the candidate set)."""
    return vertex_check_bits(g.adj_bits, members, n_valid, cand)


def edge_check(
    g,
    members: torch.Tensor,   # (B, k) int32 parent edge ids in visit order, pad -1
    n_valid: torch.Tensor,   # (B,) int32
    cand: torch.Tensor,      # (B,) int32 candidate extension edge id
) -> torch.Tensor:
    """Edge-based analogue of Alg. 2 (paper §5.1 "the edge-based case is
    analogous").

    Canonical order: start from the smallest incident-edge id and
    recursively append the smallest-id edge sharing an endpoint with the
    current subgraph. Incrementally: scan members for the first edge
    sharing an endpoint with ``cand``; afterwards no member id may exceed
    ``cand``. Endpoints come from ``g.edge_uv``, so ``g`` may be a
    :class:`DeviceGraph` or a tile view."""
    b, k = members.shape
    pos = torch.arange(k, device=members.device)[None, :]
    valid = pos < n_valid[:, None]

    first_ok = torch.where(n_valid > 0, members[:, 0] < cand, True)

    last = g.edge_uv.shape[0] - 1
    mu = g.edge_uv[members.clamp(0, last)]        # (B, k, 2)
    cu = g.edge_uv[cand.clamp(0, last)]           # (B, 2)
    shares = (
        (mu[..., 0] == cu[:, None, 0])
        | (mu[..., 0] == cu[:, None, 1])
        | (mu[..., 1] == cu[:, None, 0])
        | (mu[..., 1] == cu[:, None, 1])
    ) & valid

    found_after = torch.cumsum(shares.to(torch.int32), dim=1,
                               dtype=torch.int32) > 0
    found_before = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=members.device),
         found_after[:, :-1]], dim=1,
    )
    violation = valid & found_before & (members > cand[:, None])
    return first_ok & ~violation.any(dim=1)


# ---------------------------------------------------------------------------
# Reference (non-incremental) canonical forms — host helpers used by the
# oracles and the tests.
# ---------------------------------------------------------------------------

def canonical_order_vertices(adj_query, vertices):
    """Host-side reference: canonical visit order of a vertex set (Appendix
    Thm 3 construction): start at min id; repeatedly append the min-id
    vertex adjacent to the prefix. None when the set is disconnected."""
    vs = sorted(int(v) for v in vertices)
    order = [vs[0]]
    rest = set(vs[1:])
    while rest:
        nxt = min(
            (v for v in rest if any(adj_query(u, v) for u in order)),
            default=None,
        )
        if nxt is None:  # disconnected: not a valid embedding
            return None
        order.append(nxt)
        rest.remove(nxt)
    return order


def canonical_order_edges(edge_uv, edge_ids):
    """Host-side reference canonical order for an edge set (None when the
    edges do not form a connected subgraph)."""
    es = sorted(int(e) for e in edge_ids)
    order = [es[0]]
    verts = set(edge_uv[es[0]])
    rest = set(es[1:])
    while rest:
        nxt = min(
            (
                e
                for e in rest
                if edge_uv[e][0] in verts or edge_uv[e][1] in verts
            ),
            default=None,
        )
        if nxt is None:
            return None
        order.append(nxt)
        verts.update(edge_uv[nxt])
        rest.remove(nxt)
    return order
