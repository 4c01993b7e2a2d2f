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

``mining_step_for_dryrun`` is the reference's fixed-shape exploration
step: expansion with the Algorithm-2 check, compaction, the quick
patterns, their counts against a static dictionary, summed over the
workers. It runs over a virtual-worker mesh (``make_mesh``), launching
the ``canonical_check`` kernel on the card; the dry run
(``launch.dryrun.lower_mining``) counts one worker's program of it
(:func:`mining_worker`) on fake tensors at the production shape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import explore, pattern as pattern_lib
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
    psum,
    replicate_graph,
)

__all__ = ["DistConfig", "run_distributed", "mining_step_for_dryrun",
           "mining_worker", "random_frontier"]


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


# ---------------------------------------------------------------------------
# Fixed-shape mining step (the dry run's mining cell)
# ---------------------------------------------------------------------------

def mining_worker(g: DeviceGraph, members, n_valid, quick_dict,
                  use_pallas: bool):
    """One worker's step on its slice: members (per, k) int32, n_valid
    (per,) int32, quick_dict (Q, 3) int64 -> (children (per, k+1), count
    () int32, counts (Q,) int32), the reference's worker body: the
    children's capacity is the slice's size, and a child's quick code
    counts in the first dictionary slot equal to it (none if no slot is)."""
    exp = explore.expand_vertex(g, members, n_valid, use_pallas=use_pallas)
    out_cap = members.shape[0]
    children, count = explore.compact(members, exp, exp.keep, out_cap)
    slots = torch.arange(out_cap, device=members.device)
    child_nv = torch.where(slots < count, n_valid.max() + 1,
                           0).to(torch.int32)
    qp = pattern_lib.quick_pattern_vertex(g, children, child_nv)
    q = quick_dict.shape[0]
    eq = (qp.codes[:, None, :] == quick_dict[None, :, :]).all(-1)
    # the first equal slot: argmax returns the first of equal maxima
    slot = torch.where(eq.any(1), eq.to(torch.uint8).argmax(1), q)
    counts = torch.zeros((q + 1,), dtype=torch.int32, device=members.device)
    counts.index_add_(0, slot, (child_nv > 0).to(torch.int32))
    return children, count, counts[:q]


def mining_step_for_dryrun(mesh: DeviceMesh, axes=("pod", "data"),
                           use_pallas: Optional[bool] = None):
    """The reference's fixed-shape distributed exploration step over the
    workers of ``mesh`` that shard over ``axes``:
    ``step(g, members, n_valid, quick_dict)`` with members (W, per, k)
    int32 and n_valid (W, per) int32 (a slice a worker), quick_dict (Q, 3)
    int64 replicated, returns (children (W, per, k+1), count (W,), counts
    (W, Q)), the counts summed over the workers (the reference's psum:
    each worker's row is the total), all on worker 0's device.
    ``use_pallas=None`` takes the kernel on the card and its plain version
    on the CPU (the engines' rule)."""
    devices = mesh.worker_devices(axes)
    on_card = devices[0].type == "cuda"
    resolved = RunConfig(use_pallas=use_pallas).resolve_use_pallas(on_card)

    def step(g: DeviceGraph, members, n_valid, quick_dict):
        if members.shape[0] != len(devices):
            raise ValueError(f"{members.shape[0]} slices for "
                             f"{len(devices)} workers")
        outs = [mining_worker(replicate_graph(g, dev), members[w].to(dev),
                              n_valid[w].to(dev), quick_dict.to(dev),
                              resolved)
                for w, dev in enumerate(devices)]
        totals = psum([o[2] for o in outs], devices)
        home = devices[0]
        return (torch.stack([o[0].to(home) for o in outs]),
                torch.stack([o[1].to(home) for o in outs]),
                torch.stack([t.to(home) for t in totals]))

    return step


def random_frontier(g: Graph, rows: int, k: int, seed: int = 0):
    """A seeded frontier for the mining step: ``rows`` connected vertex
    sets grown one vertex at a time from a random start, each new vertex a
    random neighbour of a random member. A row stops growing at its first
    draw that repeats a member (or meets a vertex without neighbours):
    members past ``n_valid`` are -1. Returns (members (rows, k) int32,
    n_valid (rows,) int32), numpy."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([g.edges, g.edges[:, ::-1]]).astype(np.int64)
    e = e[np.argsort(e[:, 0], kind="stable")]
    start = np.searchsorted(e[:, 0], np.arange(g.n + 1))
    deg = np.diff(start)
    members = np.full((rows, k), -1, dtype=np.int64)
    members[:, 0] = rng.integers(0, g.n, size=rows)
    alive = np.ones(rows, dtype=bool)
    n_valid = np.ones(rows, dtype=np.int32)
    for i in range(1, k):
        src = members[np.arange(rows), rng.integers(0, i, size=rows)]
        d = deg[src]
        pick = start[src] + (rng.random(rows) * np.maximum(d, 1)).astype(
            np.int64)
        nxt = np.where(d > 0, e[np.minimum(pick, len(e) - 1), 1], -1)
        alive &= (nxt >= 0) & ~(members[:, :i] == nxt[:, None]).any(1)
        members[:, i] = np.where(alive, nxt, -1)
        n_valid += alive
    return members.astype(np.int32), n_valid
