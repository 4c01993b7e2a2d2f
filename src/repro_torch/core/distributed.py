"""Distributed mining entry point, port of ``repro.core.distributed``: a
thin wrapper over the unified runtime.

The shard-map superstep (paper §5.1–§5.3: coordination-free expansion on
every worker, the two-level aggregation collective, the halo exchange and
the dense ODAG exchange) lives in :mod:`repro_torch.core.runtime.shard`
behind the :class:`~repro_torch.core.runtime.backend.ExecutionBackend`
protocol; the BSP loop around it is the same
:class:`~repro_torch.core.runtime.SuperstepRuntime` the serial engine
drives. ``run_distributed`` and ``DistConfig`` keep the reference's public
names.

``run_distributed`` gives the serial run's results. A checkpoint is
worker-count free: a run cut under W workers resumes on a mesh of any
other size, since every worker's slice is re-partitioned from the restored
store.

The reference's ``mining_step_for_dryrun`` (the fixed-shape program its
multi-pod dry-run lowers for a 512-chip mesh) is not ported; it waits for
the port of ``launch/dryrun.py`` (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.api import MiningApp
from repro_torch.core.graph import DeviceGraph, Graph, PartitionedGraph
from repro_torch.core.runtime import (
    MiningResult,
    RunConfig,
    ShardMapBackend,
    SuperstepRuntime,
)
from repro_torch.core.runtime.shard import (  # noqa: F401  (canonical home)
    DeviceMesh,
    make_mesh,
    make_sharded_aggregate,
    make_sharded_expand,
    mesh_axis_size as _mesh_axis_size,
    pad_parts,
    partition_frontier,
)

__all__ = ["DistConfig", "run_distributed"]


@dataclasses.dataclass
class DistConfig(RunConfig):
    """Deprecated alias of :class:`repro_torch.core.runtime.RunConfig`, kept
    as the reference keeps it: new code constructs ``RunConfig``."""


def run_distributed(
    graph: Graph | DeviceGraph | PartitionedGraph,
    app: MiningApp,
    mesh: DeviceMesh,
    config: Optional[RunConfig] = None,
) -> MiningResult:
    """Mine ``graph`` with ``app`` sharded over ``mesh`` (the
    ``MiningResult`` contract of ``engine.run``). A host ``Graph`` is
    uploaded to the mesh's worker-0 device (``make_mesh(..., device=)``)."""
    return SuperstepRuntime(graph, app, config, ShardMapBackend(mesh)).run()
