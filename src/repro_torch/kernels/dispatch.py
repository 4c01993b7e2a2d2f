"""Device resolution and the route rule shared by every kernel wrapper.

One rule, stated once:

  * a kernel knob that is off (``use_pallas=False``, ``compact_kernel=False``,
    ...) takes the plain PyTorch route on any device — the same choice the
    JAX package offers with its jnp routes;
  * a knob that is on routes to the hand-written CUDA kernel when the tensor
    lies on a CUDA device, and to the kernel's plain version, which has the
    same contract, when it lies on the CPU. Any other device raises.

Entry points run on the card unless the caller asks for the CPU
(:func:`resolve_device`): with no card and no explicit ``device="cpu"``
they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def on_cuda(t: torch.Tensor) -> bool:
    """True -> launch the kernel, False -> the plain version (CPU tensor)."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel route for tensors on {t.device}")


#: halo-exchange strategies of the partitioned layout (DESIGN.md §11).
HALO_STRATEGIES = ("alltoall", "gather")


def resolve_halo(halo: Optional[str] = None) -> str:
    """Map the halo knob (``RunConfig.halo``) to a concrete strategy:
    ``None``/``"auto"`` -> ``"alltoall"``, the request/response exchange
    that ships only the rows each worker asked for (O(halo) a worker);
    ``"gather"`` is the fallback that all-gathers the whole shard tables
    (O(n) a worker), kept as the equivalence oracle and the supervisor's
    rung after a failed exchange."""
    if halo is None or halo == "auto":
        return "alltoall"
    if halo not in HALO_STRATEGIES:
        raise ValueError(
            f"unknown halo strategy {halo!r} (expected one of "
            f"{HALO_STRATEGIES} or 'auto')"
        )
    return halo


#: level-2 canonicalisation placements (DESIGN.md §15).
CANONICAL_PLACEMENTS = ("device", "host", "host_async")


def resolve_canonical_placement(placement: Optional[str] = None) -> str:
    """Map the level-2 placement knob (``RunConfig.canonical_placement``)
    to a concrete choice: ``None``/``"auto"`` -> ``"host"``, the memoised
    host batch (the reference placement)."""
    if placement is None or placement == "auto":
        return "host"
    if placement not in CANONICAL_PLACEMENTS:
        raise ValueError(
            f"unknown canonical placement {placement!r} (expected one of "
            f"{CANONICAL_PLACEMENTS} or 'auto')"
        )
    return placement


def device_scope(name: str):
    """A ``torch.profiler.record_function("repro/<name>")`` range around a
    stage of a worker body (the fused chunk program, the halo exchange, the
    aggregation bin), made only while a tracer is installed, as
    ``obs.annotate`` is: the disabled path touches no profiler machinery."""
    from repro_torch.core import obs

    return obs.annotate(f"repro/{name}")
