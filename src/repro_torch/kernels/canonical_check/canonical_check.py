"""Embedding-canonicality check (paper Alg. 2) as hand-written CUDA kernels,
port of ``repro.kernels.canonical_check.canonical_check``.

Three kernels (``csrc/canonical_check.cu``, ``csrc/canonical_check_tiles.cu``,
``csrc/expand_canonical.cu``):

  * :func:`canonical_check_cuda` — the standalone Alg.-2 check over a flat
    batch of (members, cand) pairs;
  * :func:`canonical_check_tiles_cuda` — the same check over a gathered
    halo tile of the partitioned layout: adjacency read at the members'
    tile ranks, order tests on the global ids;
  * :func:`expand_canonical_cuda` — the *fused* expansion kernel: for every
    parent it enumerates the neighbour-table candidates and evaluates slot
    validity, not-a-member, first-occurrence dedup and the Alg.-2 check in
    one pass, reading each member↔candidate adjacency bit once: from the
    members' bitmap rows staged in shared memory where they fit the
    kernel's budget, else from device memory (:func:`expand_variant`).

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version beside it (same contract) for CPU tensors. The Hopper
kernels read the tables from device memory, so no graph-size guard routes
anything elsewhere: only the shapes the kernels cannot take raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.core.canonical import vertex_check_bits
from repro_torch.kernels import build, counting
from repro_torch.kernels.dispatch import on_cuda

#: most members a row may hold (the 8-vertex pattern encoding).
MAX_K = 8
INT32_MAX = 2**31 - 1


def _check_int32(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-d int32, got {t.dim()}-d "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def canonical_check_cost(members, adj_bits):
    """(operations, bytes) of one launch on B rows: members, n_valid and
    cand read and the flags written once, and at most one 32-byte sector
    of the bitmap a (member, candidate) test, never more than the whole
    bitmap; about 8 integer operations a test."""
    b, k = members.shape
    table = adj_bits.numel() * adj_bits.element_size()
    return 8.0 * b * k, b * k * 4.0 + 2 * b * 4 + b + min(32.0 * b * k,
                                                         table)


def canonical_check_ref(members, n_valid, cand, adj_bits):
    """Plain version of :func:`canonical_check_cuda` (the jnp route of the
    JAX package, ``canonical.vertex_check``)."""
    return vertex_check_bits(adj_bits, members, n_valid, cand)


def canonical_check_cuda(members, n_valid, cand, adj_bits):
    """members (B, k) int32; n_valid (B,) int32; cand (B,) int32; adj_bits
    (N, W) int32. Returns (B,) bool — True iff members[:n_valid]+[cand] is
    canonical. Any ``B`` is accepted, including 0. While the dry run
    counts (``kernels.counting``), the kernel's charge."""
    if counting.active() is not None:
        counting.active().charge("canonical_check", *canonical_check_cost(
            members, adj_bits))
        return counting.like(members, (members.shape[0],), torch.bool)
    if not on_cuda(members):
        return canonical_check_ref(members, n_valid, cand, adj_bits)
    b, k = members.shape
    dev = members.device
    _check_int32("members", members, 2, dev)
    _check_int32("n_valid", n_valid, 1, dev)
    _check_int32("cand", cand, 1, dev)
    _check_int32("adj_bits", adj_bits, 2, dev)
    if not 1 <= k <= MAX_K or n_valid.shape[0] != b or cand.shape[0] != b:
        raise ValueError(f"bad shapes: members {tuple(members.shape)}, "
                         f"n_valid {tuple(n_valid.shape)}, cand "
                         f"{tuple(cand.shape)}")
    members, n_valid = members.contiguous(), n_valid.contiguous()
    cand, adj_bits = cand.contiguous(), adj_bits.contiguous()
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        build.count_launch("canonical_check")
        build.check(lib.repro_canonical_check(
            members.data_ptr(), n_valid.data_ptr(), cand.data_ptr(),
            adj_bits.data_ptr(), b, k, adj_bits.shape[0], adj_bits.shape[1],
            out.data_ptr(), build.stream_of(members),
        ), "canonical_check")
    return out


def canonical_check_tiles_ref(members, ranks, n_valid, cand, adj_tile):
    """Plain version of :func:`canonical_check_tiles_cuda` (the jnp route
    of the JAX package, ``ops.canonical_check_tiles_ref``): adjacency read
    at the members' halo-tile ``ranks`` (< 0 = not in the tile = not
    adjacent), order tests on the global ids."""
    b, k = members.shape
    pos = torch.arange(k, device=members.device)[None, :]
    valid = pos < n_valid[:, None]
    first_ok = torch.where(n_valid > 0, members[:, 0] < cand, True)
    neigh = (
        bitset.test_bit(adj_tile, ranks, cand[:, None])
        & valid & (members >= 0)
    )
    found_after = torch.cumsum(neigh.to(torch.int32), dim=1,
                               dtype=torch.int32) > 0
    found_before = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=members.device),
         found_after[:, :-1]], dim=1,
    )
    violation = valid & found_before & (members > cand[:, None])
    return first_ok & ~violation.any(dim=1)


def canonical_check_tiles_cuda(members, ranks, n_valid, cand, adj_tile):
    """members, ranks (B, k) int32; n_valid, cand (B,) int32; adj_tile
    (U, W) int32 gathered halo rows (``ranks`` index it; ranks < 0 read as
    not adjacent). Returns (B,) bool. Any ``B`` is accepted, including 0."""
    if not on_cuda(members):
        return canonical_check_tiles_ref(members, ranks, n_valid, cand,
                                         adj_tile)
    b, k = members.shape
    dev = members.device
    _check_int32("members", members, 2, dev)
    _check_int32("ranks", ranks, 2, dev)
    _check_int32("n_valid", n_valid, 1, dev)
    _check_int32("cand", cand, 1, dev)
    _check_int32("adj_tile", adj_tile, 2, dev)
    u, w = adj_tile.shape
    if (not 1 <= k <= MAX_K or ranks.shape != members.shape
            or n_valid.shape[0] != b or cand.shape[0] != b
            or (b and not (u and w))):
        raise ValueError(f"bad shapes: members {tuple(members.shape)}, ranks "
                         f"{tuple(ranks.shape)}, n_valid "
                         f"{tuple(n_valid.shape)}, cand {tuple(cand.shape)}, "
                         f"adj_tile {(u, w)}")
    members, ranks = members.contiguous(), ranks.contiguous()
    n_valid, cand = n_valid.contiguous(), cand.contiguous()
    adj_tile = adj_tile.contiguous()
    out = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        build.count_launch("canonical_check_tiles")
        build.check(lib.repro_canonical_check_tiles(
            members.data_ptr(), ranks.data_ptr(), n_valid.data_ptr(),
            cand.data_ptr(), adj_tile.data_ptr(), b, k, u, w,
            out.data_ptr(), build.stream_of(members),
        ), "canonical_check_tiles")
    return out


def expand_masks(members, n_valid, nbr, adj_bits, rows=None, row_ok=None):
    """The candidate table and validity mask of the unfused vertex
    expansion (the jnp route of ``explore.expand_vertex``): ``cand``
    (C, k, D) is neighbour j of member i (-1 past the row's members or the
    member's degree); ``valid`` is slot-ok & not-a-member &
    first-occurrence (no earlier member adjacent).

    ``rows`` (C, k) are the members' rows of ``nbr`` / ``adj_bits`` and
    ``row_ok`` the slots whose row is read: by default the members
    themselves and the valid slots; on a halo tile their tile ranks (-1
    where the slot is invalid or missed the tile)."""
    k = members.shape[1]
    pos = torch.arange(k, device=members.device)
    member_ok = pos[None, :] < n_valid[:, None]                    # (C, k)
    if rows is None:
        rows, row_ok = members, member_ok
    safe = rows.clamp(0, nbr.shape[0] - 1)
    cand = nbr[safe].masked_fill(~row_ok[:, :, None], -1)          # (C, k, D)
    slot_ok = cand >= 0
    # not already a member of the embedding
    is_member = (cand[:, :, :, None] == members[:, None, None, :]).any(-1)
    # first-occurrence dedup: drop if an *earlier* member is adjacent to cand
    adj_em = bitset.test_bit(
        adj_bits, rows[:, :, None, None], cand[:, None, :, :]
    ) & member_ok[:, :, None, None]                                # (C, k_m, k_i, D)
    earlier = pos[None, :, None, None] < pos[None, None, :, None]
    seen_earlier = (adj_em & earlier).any(dim=1)                   # (C, k_i, D)
    return cand, slot_ok & ~is_member & ~seen_earlier


def expand_canonical_ref(members, n_valid, nbr, adj_bits):
    """Plain version of :func:`expand_canonical_cuda`: the unfused vertex
    expansion, reshaped to the kernel's (C, k, D) outputs."""
    c, k = members.shape
    d = nbr.shape[1]
    cand, valid = expand_masks(members, n_valid, nbr, adj_bits)
    rows = torch.arange(c, dtype=torch.int32, device=members.device)
    flat_rows = rows.repeat_interleave(k * d)
    canon = vertex_check_bits(
        adj_bits, members[flat_rows], n_valid[flat_rows], cand.reshape(-1)
    ).reshape(c, k, d)
    return cand, valid, valid & canon


def expand_variant(k: int, words: int) -> str:
    """The variant of the expansion kernel that a batch of ``k`` members
    over a bitmap of ``words`` words a row takes: ``"staged"`` when the k
    bitmap rows fit the kernel's shared-memory budget, else ``"global"``
    (bit tests read from device memory). Needs the built library."""
    budget = build.library().repro_expand_stage_bytes()
    return "staged" if k * words * 4 <= budget else "global"


def expand_canonical_cuda(members, n_valid, nbr, adj_bits):
    """Fused vertex expansion: members (C, k) int32, n_valid (C,) int32,
    nbr (N, D) int32 padded neighbour table, adj_bits (N, W) int32.

    Returns ``(cand, valid, keep)``, each ``(C, k, D)``: the candidate
    vertex per slot, the pre-canonicality validity mask (slot-ok &
    not-member & first-occurrence) and the final keep mask (valid &
    Alg.-2 canonical). Any ``C`` is accepted, including 0."""
    if not on_cuda(members):
        return expand_canonical_ref(members, n_valid, nbr, adj_bits)
    c, k = members.shape
    n, d = nbr.shape
    dev = members.device
    _check_int32("members", members, 2, dev)
    _check_int32("n_valid", n_valid, 1, dev)
    _check_int32("nbr", nbr, 2, dev)
    _check_int32("adj_bits", adj_bits, 2, dev)
    w = adj_bits.shape[1]
    if (not 1 <= k <= MAX_K or n_valid.shape[0] != c or adj_bits.shape[0] != n
            or (c and d and not (n and w))):
        raise ValueError(f"bad shapes: members {tuple(members.shape)}, "
                         f"n_valid {tuple(n_valid.shape)}, nbr {(n, d)}, "
                         f"adj_bits {tuple(adj_bits.shape)}")
    if c * k * d > INT32_MAX:
        raise ValueError(f"{c}x{k}x{d} candidate slots exceed the int32 "
                         "index range of the compaction that follows")
    members, n_valid = members.contiguous(), n_valid.contiguous()
    nbr, adj_bits = nbr.contiguous(), adj_bits.contiguous()
    cand = torch.empty((c, k, d), dtype=torch.int32, device=dev)
    valid = torch.empty((c, k, d), dtype=torch.bool, device=dev)
    keep = torch.empty((c, k, d), dtype=torch.bool, device=dev)
    if c == 0 or d == 0:
        return cand, valid, keep
    staged = expand_variant(k, w) == "staged"
    build.launch("expand_canonical", build.library().repro_expand_canonical,
                 members.get_device(), members.data_ptr(), n_valid.data_ptr(),
                 nbr.data_ptr(), adj_bits.data_ptr(), c, k, d, n, w,
                 int(staged), cand.data_ptr(), valid.data_ptr(),
                 keep.data_ptr())
    return cand, valid, keep
