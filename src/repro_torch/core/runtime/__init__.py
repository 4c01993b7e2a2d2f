"""Unified superstep runtime (DESIGN.md §9), port of
``repro.core.runtime``: one :class:`SuperstepRuntime` BSP loop driven by the
:class:`SerialBackend`, configured by one :class:`RunConfig`."""
from repro_torch.core.runtime.backend import ExecutionBackend
from repro_torch.core.runtime.config import RunConfig, next_pow2
from repro_torch.core.runtime.loop import MiningResult, SuperstepRuntime
from repro_torch.core.runtime.serial import SerialBackend

__all__ = [
    "ExecutionBackend",
    "MiningResult",
    "RunConfig",
    "SerialBackend",
    "SuperstepRuntime",
    "next_pow2",
]
