"""Public wrappers of the Alg.-2 kernels, port of
``repro.kernels.canonical_check.ops``.

The JAX package's VMEM guards (``fits_vmem``, ``fits_vmem_fused``,
``_fused_block_c``) are TPU budgets: the Hopper kernels read the bitmap and
the neighbour table from device memory, so every graph takes the kernel
when the knob is on. Edge mode has no kernel (the reference routes it to
the jnp ``edge_check`` too) and is not ported yet. The tile-indexed check
of the partitioned layout has no ``VMEM_BITMAP_LIMIT`` guard either: with
the knob on it launches whatever the halo tile's size.
"""
from __future__ import annotations

from repro_torch.core.graph import DeviceGraph
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda,
    canonical_check_tiles_cuda,
    canonical_check_tiles_ref,
    expand_canonical_cuda,
)


def canonical_check(g: DeviceGraph, members, n_valid, cand, *,
                    mode: str = "vertex"):
    """Alg.-2 check through the kernel (vertex mode). Accepts any batch
    size, including 0."""
    if mode == "edge":
        raise NotImplementedError("edge mode comes with FSM; see ROADMAP.md")
    return canonical_check_cuda(members, n_valid, cand, g.adj_bits)


def expand_canonical(g: DeviceGraph, members, n_valid):
    """Fused vertex expansion + canonicality (see
    :func:`expand_canonical_cuda`). Returns ``(cand, valid, keep)`` each
    ``(C, k, D)``."""
    return expand_canonical_cuda(members, n_valid, g.nbr, g.adj_bits)


def canonical_check_tiles(members, ranks, n_valid, cand, adj_tile, *,
                          use_pallas: bool = False):
    """Tile-indexed Alg.-2 check (vertex mode, partitioned layout): the
    ``canonical_check_tiles`` kernel with ``use_pallas``, else its plain
    version. Accepts any batch size, including 0."""
    if use_pallas:
        return canonical_check_tiles_cuda(members, ranks, n_valid, cand,
                                          adj_tile)
    return canonical_check_tiles_ref(members, ranks, n_valid, cand, adj_tile)
