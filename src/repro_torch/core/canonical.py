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


def edge_check(g, members, n_valid, cand):
    """Edge-based Alg. 2: edge mode (FSM) is not ported yet (ROADMAP.md)."""
    raise NotImplementedError("edge-mode canonicality comes with FSM; "
                              "see ROADMAP.md")
