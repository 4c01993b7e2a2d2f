"""The ONE superstep loop (DESIGN.md §9): Algorithm 1, BFS
level-synchronous, port of ``repro.core.runtime.loop``.

``SuperstepRuntime`` owns the BSP loop — init frontier → (fused or chunk
loop) expand → store seal → pattern aggregate → app post-step —
parameterised by an :class:`~repro_torch.core.runtime.backend.ExecutionBackend`.
The runtime follows the tensors of its :class:`DeviceGraph` or
:class:`PartitionedGraph`: a host :class:`Graph` is uploaded to ``device``
(the card unless the caller asks for the CPU), and with
``RunConfig.graph_partition`` it is laid out partitioned (DESIGN.md §11).
Checkpoint/resume, fault injection and the supervisor are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, obs
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import (
    DeviceGraph, Graph, PartitionedGraph, to_device, to_partitioned,
)
from repro_torch.core.runtime import programs
from repro_torch.core.runtime.backend import ExecutionBackend
from repro_torch.core.runtime.config import RunConfig
from repro_torch.core.stats import RunStats, StepStats, Timer


@dataclasses.dataclass
class MiningResult:
    patterns: Dict[tuple, int]                    # canon code -> count/support
    aggregates: List[aggregation.StepAggregates]
    stats: RunStats
    embeddings: Dict[int, np.ndarray]             # size -> (B, size) arrays

    def pattern_count(self, code) -> int:
        return self.patterns.get(tuple(int(x) for x in code), 0)


class SuperstepRuntime:
    """One BSP mining run: a graph, an app, a config, and a backend."""

    def __init__(
        self,
        graph: Graph | DeviceGraph | PartitionedGraph,
        app: MiningApp,
        config: Optional[RunConfig] = None,
        backend: Optional[ExecutionBackend] = None,
        device=None,
    ) -> None:
        from repro_torch.core.runtime.serial import SerialBackend

        self.config = config if config is not None else RunConfig()
        if isinstance(graph, (DeviceGraph, PartitionedGraph)):
            if device is not None and torch.device(device) != graph.device:
                raise ValueError(
                    f"graph tensors are on {graph.device}, device={device!r}"
                )
        elif not isinstance(graph, Graph):
            raise TypeError(f"{type(graph).__name__}: expected a Graph, "
                            "DeviceGraph or PartitionedGraph")
        if isinstance(graph, PartitionedGraph):
            self.g = graph
        elif self.config.graph_partition:
            # partitioned layout (DESIGN.md §11): CSR shards + adjacency
            # tiles replace the whole-graph DeviceGraph; a DeviceGraph input
            # is re-partitioned where its tensors are
            self.g = to_partitioned(
                graph,
                self.config.graph_partition,
                self.config.partition_balance,
                device,
            )
        elif isinstance(graph, Graph):
            self.g = to_device(graph, device)
        else:
            self.g = graph
        self.app = app
        self.backend = backend if backend is not None else SerialBackend()
        self.store = self.backend.bind(self.g, self.app, self.config)
        # bind resolved every tri-state knob through the cost model — the
        # runtime sees the same concrete config the backend built from
        self.config = self.backend.config

    def _join_level2(self, pending, result: MiningResult, st) -> None:
        """Join an overlapped ``host_async`` level-2 batch (DESIGN.md §15):
        replace the step's placeholder aggregate and record its patterns.
        ``t_canon`` here is the *residual* blocking wait, and the join does
        not count as a host sync (only control-flow reads do)."""
        t0 = time.perf_counter()
        with obs.span("canonicalize", placement="host_async",
                      n_quick=pending.n_quick, step=st.step):
            table, counts = pending.result()
        obs.count(st, "t_canon", time.perf_counter() - t0)
        agg = aggregation.build_step_aggregates(
            table, counts, counts.copy(), pending.n_quick, st
        )
        assert result.aggregates and result.aggregates[-1] is None
        result.aggregates[-1] = agg
        # beta/outputs deferred from alpha: async eligibility means no
        # pattern pruning, so the surviving patterns are the live ones
        for pc in np.flatnonzero(agg.counts > 0):
            code = tuple(int(x) for x in agg.canon_codes[pc])
            result.patterns[code] = (
                result.patterns.get(code, 0) + int(agg.counts[pc])
            )

    def run(self) -> MiningResult:
        """Mine from scratch (superstep 1 seeds every vertex)."""
        config, app, store, backend = (
            self.config, self.app, self.store, self.backend,
        )
        observer = obs.RunObserver(config, backend.name)
        observer.start()
        t_start = time.perf_counter()
        result = MiningResult(
            patterns={}, aggregates=[], stats=RunStats(), embeddings={}
        )
        result.stats.cost_model = backend.decisions.as_dict()
        store.append(programs.initial_frontier(self.g, app.mode))
        store.seal(1)
        size = 1

        #: fused mode: level-1 state of the sealed frontier, carried from
        #: the previous superstep's chunk programs
        carried: Optional[object] = None

        for step in range(1, config.max_steps + 1):
            b = store.n_rows
            if b == 0:
                break
            st = StepStats(step=step, size=size, n_frontier=b)
            st.frontier_bytes = store.raw_bytes
            timer = Timer()
            done = False
            with obs.span("superstep", step=step, size=size, frontier=b):
                # ---- re-materialise the frontier ----------------------------
                blocks = backend.begin_step(store, st)
                st.n_frontier = sum(len(blk) for blk in blocks)
                obs.set_stat(st, "t_storage", timer.lap())

                # ---- pattern aggregation of this step's embeddings (end of
                # the step that generated them, per Algorithm 1); a None
                # canon_slot means level 1 stayed on the device ----------
                canon_slot = None
                agg = None
                pending = None
                if app.wants_patterns:
                    with obs.span("aggregate", step=step):
                        agg, canon_slot = backend.aggregate_step(
                            blocks, size, carried, st
                        )
                        if isinstance(agg, aggregation.PendingLevel2):
                            # host_async placement: the level-2 batch runs
                            # on a background thread; the placeholder is
                            # replaced at the join after the next seal
                            pending, agg = agg, None
                        result.aggregates.append(agg)
                carried = None
                obs.set_stat(st, "t_aggregate", timer.lap())

                # ---- alpha: aggregation filter on the frontier ------------
                if agg is not None:
                    if canon_slot is not None:
                        # host path: per-row alpha over per-row slots
                        alpha = app.aggregation_filter(canon_slot, agg)
                        surviving = (
                            np.unique(canon_slot[alpha]) if alpha.any() else []
                        )
                    else:
                        # device path: alpha at pattern granularity; the
                        # O(B) row mask only materialises when pruning fires
                        pk = app.pattern_filter(agg)
                        live = agg.counts > 0
                        if pk is None:
                            surviving = np.flatnonzero(live)
                            alpha = None
                        else:
                            pk = np.asarray(pk, dtype=bool)
                            surviving = np.flatnonzero(live & pk)
                            alpha = (
                                backend.alpha_rows(pk, st)
                                if not pk.all()
                                else None
                            )
                    # beta / outputs: aggregates of surviving patterns
                    for pc in surviving:
                        code = tuple(int(x) for x in agg.canon_codes[pc])
                        value = int(
                            agg.supports[pc]
                            if app.wants_domains
                            else agg.counts[pc]
                        )
                        result.patterns[code] = (
                            result.patterns.get(code, 0) + value
                        )
                    if alpha is not None and not alpha.all():
                        blocks = backend.prune(blocks, alpha)
                b_live = sum(len(blk) for blk in blocks)
                if app.collect_embeddings and b_live:
                    live_blocks = [blk for blk in blocks if len(blk)]
                    result.embeddings[size] = (
                        np.asarray(live_blocks[0])
                        if len(live_blocks) == 1
                        else np.concatenate(live_blocks, axis=0)
                    )

                # ---- termination ------------------------------------------
                if (
                    app.termination_filter(size)
                    or b_live == 0
                    or step == config.max_steps
                ):
                    if pending is not None:
                        # no next superstep to overlap with: join now
                        self._join_level2(pending, result, st)
                    result.stats.steps.append(st)
                    done = True
                else:
                    # ---- expansion: children appended to the store --------
                    with obs.span("expand", step=step):
                        carried = backend.expand(store, blocks, size, st)
                        obs.fence(carried)
                    obs.set_stat(st, "t_expand", timer.lap())
                    store.seal(size + 1)
                    st.n_children = store.n_rows
                    obs.count(st, "t_storage", timer.lap())
                    if pending is not None:
                        # join the overlapped level-2 batch at the seal
                        # boundary: only the residual wait lands on the
                        # critical path
                        self._join_level2(pending, result, st)
                    backend.end_step(store, st)
                    result.stats.steps.append(st)
            observer.step_done(st)
            if done or store.n_rows == 0:
                break
            size += 1

        result.stats.wall_time = time.perf_counter() - t_start
        backend.finalize(result.stats)
        observer.finish(wall_time=result.stats.wall_time)
        return result
