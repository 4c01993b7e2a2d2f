"""Stream compaction (one-pass scan with a decoupled look-back) as a
hand-written CUDA kernel, port of ``repro.kernels.compact``.

The chunk program of the fused superstep pipeline (DESIGN.md §8) turns a
flat keep mask over candidate slots into the dense child frontier.
:func:`stream_compact_cuda` launches ``csrc/stream_compact.cu``; CUDA
blocks run in no fixed order, so where the Pallas kernel carried a running
total across a grid that runs in order, each tile of this one takes its
offset from the sums its predecessors publish.

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

#: (the C entry ``repro_stream_compact``, flags per tile), bound at the
#: first launch; the kernel's scratch is one 8-byte word a tile, plus one
_kernel = None


def _bind():
    global _kernel
    lib = build.library()
    _kernel = (lib.repro_stream_compact, int(lib.repro_compact_tile()))
    return _kernel


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
    if not (keep.is_cuda or on_cuda(keep)):
        return stream_compact_ref(keep, out_cap)
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"keep: expected 1-d bool, got {keep.dim()}-d "
                        f"{keep.dtype}")
    n = keep.shape[0]
    if n > INT32_MAX or not 0 <= out_cap <= INT32_MAX:
        raise ValueError(f"batch {n} / out_cap {out_cap} exceed int32")
    dev = keep.device
    if n == 0:
        return (torch.zeros((out_cap,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    if not keep.is_contiguous():
        keep = keep.contiguous()
    fn, tile = _kernel or _bind()
    idx = torch.empty((out_cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty((-(-n // tile) + 1,), dtype=torch.int64,
                          device=dev)
    build.launch("stream_compact", fn, keep.get_device(), keep.data_ptr(), n,
                 out_cap, idx.data_ptr(), count.data_ptr(),
                 scratch.data_ptr())
    return idx, count
