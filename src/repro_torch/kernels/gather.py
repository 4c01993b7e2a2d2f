"""Halo-tile gather for the partitioned graph layout (DESIGN.md §11), port
of ``repro.kernels.gather``.

The partitioned pipeline never walks the whole graph: each chunk program
first derives its *halo* — the ascending unique set of member vertices
whose neighbour / adjacency rows the chunk will touch — and then gathers
exactly those rows out of the shard-stacked tables into dense tiles
(``explore.build_tile_view``).

  * :func:`halo_unique` — presence scatter + stream compaction. The
    compaction is ``kernels/compact.py`` (kernel or plain version), so it
    keeps the unclamped-count contract: ``count`` is the true number of
    distinct vertices even when it exceeds ``cap``. Pad slots hold the
    sentinel ``n``, which keeps the tile ascending — rank translation in
    the tile view is one ``searchsorted``. No host read.
  * :func:`gather_rows_cuda` — the hand-written kernel
    (``csrc/gather_rows.cu``): the table stays in device memory and each
    block copies rows of it; out-of-range row ids give ``fill`` rows.
    :func:`gather_rows_ref` is its plain version, the reference's clipped
    take with the same fill.

The JAX package keeps the table resident in the TPU's VMEM and routes
larger tables (``fits_vmem``) to XLA's gather; the Hopper kernel reads
from device memory, so no size guard routes anything elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import compact as compact_lib
from repro_torch.kernels.dispatch import on_cuda

INT32_MAX = 2**31 - 1


def gather_rows_ref(table: torch.Tensor, rows: torch.Tensor, fill: int):
    """Plain version: the clipped take ``table[clip(rows)]`` with rows
    outside ``[0, N)`` replaced by ``fill``."""
    n = table.shape[0]
    out = table[rows.clamp(0, max(n - 1, 0))]
    ok = (rows >= 0) & (rows < n)
    return out.masked_fill(~ok[:, None], fill)


def gather_rows_cuda(table: torch.Tensor, rows: torch.Tensor, fill: int):
    """table (N, R) int32; rows (U,) int32 -> (U, R) int32: ``table[rows[i]]``
    where ``0 <= rows[i] < N``, else a row of ``fill``. Any ``U`` is
    accepted, including 0."""
    if not on_cuda(table):
        return gather_rows_ref(table, rows, fill)
    dev = table.device
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table: expected 2-d int32, got {table.dim()}-d "
                        f"{table.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 1 or rows.device != dev:
        raise TypeError(f"rows: expected 1-d int32 on {dev}, got "
                        f"{rows.dim()}-d {rows.dtype} on {rows.device}")
    n, r = table.shape
    u = rows.shape[0]
    if n > INT32_MAX or not -2**31 <= int(fill) <= INT32_MAX:
        raise ValueError(f"table rows {n} / fill {fill} exceed int32")
    table, rows = table.contiguous(), rows.contiguous()
    out = torch.empty((u, r), dtype=torch.int32, device=dev)
    if u == 0 or r == 0:
        return out.fill_(fill)
    lib = build.library()
    with torch.cuda.device(dev):
        build.count_launch("gather_rows")
        build.check(lib.repro_gather_rows(
            table.data_ptr(), n, r, rows.data_ptr(), u, int(fill),
            out.data_ptr(), build.stream_of(table),
        ), "gather_rows")
    return out


def gather_rows(table, rows, fill, *, use_kernel: bool = False):
    """Gather ``table[rows]`` with out-of-range rows replaced by ``fill``:
    through :func:`gather_rows_cuda` with ``use_kernel``, else the plain
    version. Both routes return identical values."""
    if use_kernel:
        return gather_rows_cuda(table, rows, fill)
    return gather_rows_ref(table, rows, fill)


def halo_unique(verts, n: int, cap: int, *, use_kernel: bool = False):
    """Ascending distinct vertex ids of ``verts`` (invalid ids < 0 or >= n
    ignored), padded with the sentinel ``n``.

    Returns ``(uniq (cap,) int32 ascending, count () int32)`` where
    ``count`` is the UNCLAMPED distinct total (the ``compact.py`` overflow
    contract; the engine's static ``cap = next_pow2(min(slots, n))`` makes
    overflow impossible on the hot path). The presence scatter writes an
    ``(n + 1,)`` bool table; the compaction is ``kernels/compact.py``."""
    verts = verts.reshape(-1)
    ok = (verts >= 0) & (verts < n)
    slot = torch.where(ok, verts, n).to(torch.int64)
    presence = torch.zeros((n + 1,), dtype=torch.bool, device=verts.device)
    presence.scatter_(0, slot, True)
    presence = presence[:n]
    if use_kernel:
        idx, count = compact_lib.stream_compact_cuda(presence, cap)
    else:
        idx, count = compact_lib.stream_compact_ref(presence, cap)
    valid = torch.arange(cap, device=verts.device) < count.clamp(max=cap)
    uniq = torch.where(valid, idx, n).to(torch.int32)
    return uniq, count
