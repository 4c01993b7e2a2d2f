"""Shared device-program machinery of the superstep runtime, port of
``repro.core.runtime.programs``: the chunk program, device-side chunk
slicing, quick-pattern dispatch, buffer retirement and the store-facing
app filter adapter.

PyTorch runs eagerly, so a "chunk program" is a closure over
:func:`explore.fused_chunk_step` with the run's knobs bound; there is no
compile cache to share or count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import explore, pattern as pattern_lib
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.runtime.config import next_pow2


def make_expand_fn(app: MiningApp, mode: str, use_pallas: bool = False,
                   fused: bool = False, compact_kernel: bool = False,
                   with_patterns: bool = False, with_aggregates: bool = False,
                   agg_qcap: int = 4096, aggregate_kernel: bool = False,
                   aggregate_bin: str = "sort", with_local_verts: bool = True):
    """Chunk program of the superstep pipeline: expand + canonicality + app
    filter + compaction (+ child quick patterns when the pipeline is fused,
    or the binned per-chunk level-1 partial with ``with_aggregates``)."""

    def fn(g: DeviceGraph, members, n_valid, out_cap: int):
        return explore.fused_chunk_step(
            g, members, n_valid, out_cap,
            mode=mode,
            app=app,
            with_patterns=with_patterns,
            with_aggregates=with_aggregates,
            agg_qcap=agg_qcap,
            with_local_verts=with_local_verts,
            use_pallas=use_pallas,
            fused=fused,
            compact_kernel=compact_kernel,
            aggregate_kernel=aggregate_kernel,
            aggregate_bin=aggregate_bin,
        )

    return fn


def initial_frontier(g: DeviceGraph, mode: str) -> np.ndarray:
    """Superstep-1 frontier: every vertex (vertex mode) or edge (edge mode)."""
    n0 = g.n if mode == "vertex" else g.m
    return np.arange(n0, dtype=np.int32)[:, None]


def quick_patterns(g: DeviceGraph, mode: str, members, n_valid):
    if mode == "vertex":
        return pattern_lib.quick_pattern_vertex(g, members, n_valid)
    return pattern_lib.quick_pattern_edge(g, members, n_valid)


def upload(rows: np.ndarray, device) -> torch.Tensor:
    """Host int32 rows -> device tensor."""
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(
        device
    )


def device_chunk(wave_dev, lo: int, cb: int, bucket: int, k: int):
    """Slice chunk ``[lo, lo+cb)`` out of a device-resident wave and pad it
    to its pow2 ``bucket`` on the device — no host round-trip per chunk."""
    dev = wave_dev.device
    chunk = wave_dev[lo: lo + cb]
    n_valid = torch.full((cb,), k, dtype=torch.int32, device=dev)
    if bucket > cb:
        chunk = torch.cat([
            chunk,
            torch.full((bucket - cb, k), -1, dtype=torch.int32, device=dev),
        ])
        n_valid = torch.cat([
            n_valid, torch.zeros((bucket - cb,), dtype=torch.int32, device=dev)
        ])
    return chunk, n_valid


def retire(buffers: list, indices=None) -> None:
    """Drop the references ``buffers`` holds at ``indices`` (all of them
    when None), so the caching allocator can reuse the device memory of
    drained waves at once — the spill path's peak-memory control."""
    for i in range(len(buffers)) if indices is None else indices:
        buffers[i] = None


def iter_chunks(waves, wave_dev, chunk_size: int, size: int, device):
    """Yield device-sliced, pow2-padded chunks over all waves, uploading
    each wave at most once (reusing the aggregation pass's upload)."""
    for wi, w in enumerate(waves):
        if not len(w):
            continue
        if wave_dev[wi] is None:
            wave_dev[wi] = upload(w, device)
        wd = wave_dev[wi]
        for lo in range(0, len(w), chunk_size):
            cb = min(chunk_size, len(w) - lo)
            bucket = min(chunk_size, next_pow2(max(cb, 1)))
            chunk, n_valid = device_chunk(wd, lo, cb, bucket, size)
            yield wi, lo, cb, bucket, chunk, n_valid


def store_app_filter(app: MiningApp, g: DeviceGraph):
    """Adapt ``app.filter`` to the per-candidate signature ODAG extraction
    re-applies (DESIGN.md §7): extraction rows are already one member set
    per candidate, so the parent-row indirection is the identity. Returns
    None for the base accept-all filter (nothing to re-apply)."""
    if type(app).filter is MiningApp.filter:
        return None

    def phi(mem, nv, cnd):
        rows = torch.arange(int(mem.shape[0]), dtype=torch.int32,
                            device=mem.device)
        return app.filter(g, mem, nv, rows, cnd)

    return phi
