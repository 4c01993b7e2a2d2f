"""The dry run's counting mode for the kernel wrappers.

The hand-written kernels cannot run on fake tensors, and their plain
versions do other work (the flash kernel's plain version builds the
(B, H, Sq, Sk) scores and the masked half). So while the dry run counts a
step (:func:`counting`, only there), each wrapper that the step reaches
charges its kernel's own FLOPs and bytes, the formulas of the kernel
table's bound column in ``PERF.md``, to the active counter
(``roofline.counter.StepCounter``), and returns empty outputs of the
kernel's shapes. Nothing is launched and nothing is computed. Outside
:func:`counting`, :func:`active` is ``None`` and the wrappers route by
device as they always do (``kernels.dispatch``).

The inputs may be DTensors: a kernel runs on each device's local shards,
so the charge is of the local shapes, and the outputs are DTensors with
the inputs' placements.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

#: the counter of the step being counted, or None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("counter",
                                                         default=None)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` the kernel wrappers' counter for the block."""
    token = _ACTIVE.set(counter)
    try:
        yield counter
    finally:
        _ACTIVE.reset(token)


def active():
    return _ACTIVE.get()


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def like(ref: torch.Tensor, local_shape, dtype: Optional[torch.dtype] = None,
         placements=None) -> torch.Tensor:
    """An empty output of ``local_shape`` (one device's shard) beside
    ``ref``: a DTensor on ``ref``'s mesh with ``ref``'s placements (or
    ``placements``) when ``ref`` is one, counted as an allocation."""
    loc = local(ref)
    out = torch.empty(tuple(local_shape), dtype=dtype or loc.dtype,
                      device=loc.device)
    counter = _ACTIVE.get()
    if counter is not None:
        counter.track(out)
    if hasattr(ref, "to_local"):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(out, ref.device_mesh,
                                  placements or ref.placements,
                                  run_check=False)
    return out


def reduced_placements(x: torch.Tensor, w: torch.Tensor):
    """The placements of the gradient of a weight ``w`` that met an
    activation ``x``: partial sums over the mesh dimensions that shard
    ``x`` and not ``w`` (the batch's), ``w``'s own elsewhere."""
    from torch.distributed.tensor import Partial, Shard

    return [Partial() if isinstance(px, Shard) and not isinstance(pw, Shard)
            else pw for px, pw in zip(x.placements, w.placements)]
