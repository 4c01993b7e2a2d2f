"""Stream compaction (tile scan + scatter) as a hand-written CUDA kernel,
port of ``repro.kernels.compact``.

The chunk program of the fused superstep pipeline (DESIGN.md §8) turns a
flat keep mask over candidate slots into the dense child frontier.
:func:`stream_compact_cuda` launches ``csrc/stream_compact.cu``; CUDA
blocks run in no fixed order, so where the Pallas kernel carried a running
total across a grid that runs in order, this one scans tile counts in a
second pass.

Contract (identical between the kernel and :func:`stream_compact_ref`):

  * ``idx[:count]`` are the kept positions in ascending order; slots past
    ``count`` hold 0 (the callers mask them out via ``count``).
  * ``count`` is the TOTAL number of kept slots, *not* clamped to
    ``out_cap``, and stays on the device as a 0-d int32 tensor — overflow
    detection is a host decision on the already-drained count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import on_cuda

INT32_MAX = 2**31 - 1


def stream_compact_ref(keep: torch.Tensor, out_cap: int):
    """Plain version: inclusive cumsum + scatter into the static ``out_cap``
    window (last slot = dump, sliced off); no ``nonzero``, so no host sync."""
    dev = keep.device
    n = keep.shape[0]
    if n == 0:
        return (torch.zeros((out_cap,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    incl = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    pos = torch.where(keep & (incl <= out_cap), incl - 1, out_cap)
    src = torch.arange(n, dtype=torch.int32, device=dev).masked_fill(~keep, 0)
    idx = torch.zeros((out_cap + 1,), dtype=torch.int32, device=dev)
    idx.scatter_(0, pos.to(torch.int64), src)
    return idx[:out_cap], incl[-1]


def stream_compact_cuda(keep: torch.Tensor, out_cap: int):
    """keep (B,) bool -> (idx (out_cap,) int32, count () int32).

    ``idx[:min(count, out_cap)]`` are the kept positions of ``keep`` in
    ascending order (pad slots 0); ``count`` is the unclamped kept total.
    Accepts any ``B`` including 0. Never synchronises."""
    if not on_cuda(keep):
        return stream_compact_ref(keep, out_cap)
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"keep: expected 1-d bool, got {keep.dim()}-d "
                        f"{keep.dtype}")
    n = keep.shape[0]
    if n > INT32_MAX or not 0 <= out_cap <= INT32_MAX:
        raise ValueError(f"batch {n} / out_cap {out_cap} exceed int32")
    dev = keep.device
    keep = keep.contiguous()
    idx = torch.zeros((out_cap,), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return idx, count
    lib = build.library()
    tiles = torch.empty((-(-n // build.scan_tile()),), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        build.count_launch("stream_compact")
        build.check(lib.repro_stream_compact(
            keep.data_ptr(), n, out_cap, idx.data_ptr(), count.data_ptr(),
            tiles.data_ptr(), build.stream_of(keep),
        ), "stream_compact")
    return idx, count
