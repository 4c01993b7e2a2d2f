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
