"""Arabesque's filter-process mining engine in PyTorch for one NVIDIA H100
(port of ``repro.core``; the JAX package stays the reference)."""
from repro_torch.core.api import MiningApp
from repro_torch.core.engine import EngineConfig, MiningResult, run
from repro_torch.core.graph import (
    DeviceGraph, Graph, PartitionedGraph, to_device, to_partitioned,
)
from repro_torch.core.runtime import (
    DeviceMesh, FaultPlan, FaultSpec, RunConfig, ShardMapBackend,
    SuperstepRuntime, checkpoint, faults, make_mesh, resume, run_supervised,
)

__all__ = [
    "MiningApp",
    "DeviceMesh",
    "EngineConfig",
    "FaultPlan",
    "FaultSpec",
    "MiningResult",
    "RunConfig",
    "ShardMapBackend",
    "SuperstepRuntime",
    "checkpoint",
    "faults",
    "make_mesh",
    "resume",
    "run",
    "run_supervised",
    "DeviceGraph",
    "Graph",
    "PartitionedGraph",
    "to_device",
    "to_partitioned",
]
