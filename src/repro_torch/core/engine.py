"""Serial mining entry point, port of ``repro.core.engine``: a thin wrapper
over the unified runtime (:mod:`repro_torch.core.runtime`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.api import MiningApp
from repro_torch.core.graph import DeviceGraph, Graph, PartitionedGraph
from repro_torch.core.runtime import (
    MiningResult,
    RunConfig,
    SerialBackend,
    SuperstepRuntime,
)

__all__ = ["EngineConfig", "MiningResult", "run"]


@dataclasses.dataclass
class EngineConfig(RunConfig):
    """Alias of :class:`repro_torch.core.runtime.RunConfig`, kept under the
    JAX package's public name."""


def run(
    graph: Graph | DeviceGraph | PartitionedGraph,
    app: MiningApp,
    config: Optional[RunConfig] = None,
    device=None,
) -> MiningResult:
    """Mine ``graph`` with ``app`` on the serial backend. A host ``Graph``
    is uploaded to ``device`` — the current CUDA device when None, raising
    when there is none; pass ``device="cpu"`` for the CPU. A
    ``DeviceGraph`` or ``PartitionedGraph`` runs where its tensors are;
    ``config.graph_partition`` lays a ``Graph`` or ``DeviceGraph`` out
    partitioned first."""
    return SuperstepRuntime(graph, app, config, SerialBackend(), device).run()
