"""Unified superstep runtime (DESIGN.md §9), port of
``repro.core.runtime``: one :class:`SuperstepRuntime` BSP loop driven by the
:class:`SerialBackend` or, over a mesh of workers, the
:class:`ShardMapBackend`, configured by one :class:`RunConfig`, with
superstep-granular checkpoint/resume (``checkpoint_dir=`` /
:func:`resume`) and the fault-tolerant :func:`run_supervised`
(DESIGN.md §13)."""
from repro_torch.core.runtime import checkpoint, faults
from repro_torch.core.runtime.backend import ExecutionBackend
from repro_torch.core.runtime.checkpoint import (
    CheckpointCorruptError,
    CheckpointState,
    app_fingerprint,
    graph_fingerprint,
    latest_checkpoint,
    load_latest_valid,
    sweep_stale_tmp,
)
from repro_torch.core.runtime.config import RunConfig, next_pow2
from repro_torch.core.runtime.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.core.runtime.loop import (
    MiningResult, SuperstepRuntime, resume, run_supervised,
)
from repro_torch.core.runtime.serial import SerialBackend
from repro_torch.core.runtime.shard import (
    DeviceMesh, ShardMapBackend, make_mesh,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointState",
    "DeviceMesh",
    "ExecutionBackend",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "MiningResult",
    "RunConfig",
    "SerialBackend",
    "ShardMapBackend",
    "SuperstepRuntime",
    "app_fingerprint",
    "checkpoint",
    "faults",
    "graph_fingerprint",
    "latest_checkpoint",
    "load_latest_valid",
    "make_mesh",
    "next_pow2",
    "resume",
    "run_supervised",
    "sweep_stale_tmp",
]
