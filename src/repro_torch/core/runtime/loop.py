"""The ONE superstep loop (DESIGN.md §9): Algorithm 1, BFS
level-synchronous, port of ``repro.core.runtime.loop``.

``SuperstepRuntime`` owns the BSP loop — init frontier → (fused or chunk
loop) expand → store seal → pattern aggregate → app post-step —
parameterised by an :class:`~repro_torch.core.runtime.backend.ExecutionBackend`.
The runtime follows the tensors of its :class:`DeviceGraph` or
:class:`PartitionedGraph`: a host :class:`Graph` is uploaded to ``device``
(the card unless the caller asks for the CPU), and with
``RunConfig.graph_partition`` it is laid out partitioned (DESIGN.md §11).

The seal boundary is a checkpointable cut: with ``checkpoint_dir`` set the
runtime persists {sealed store payload, stats, patterns, superstep cursor,
app + graph fingerprints} every ``checkpoint_every`` supersteps, and
:func:`resume` (or :meth:`SuperstepRuntime.resume`) continues an
interrupted run. :func:`run_supervised` retries a failed run from its last
valid checkpoint (DESIGN.md §13).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, obs
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import (
    DeviceGraph, Graph, PartitionedGraph, to_device, to_partitioned,
)
from repro_torch.core.runtime import checkpoint as checkpoint_lib
from repro_torch.core.runtime import faults as faults_lib
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
    #: Chrome trace exported by this run (``trace=True`` + ``trace_dir``;
    #: DESIGN.md §12), None otherwise.
    trace_path: Optional[str] = None
    #: recovery report of a supervised run that retried (DESIGN.md §13):
    #: {n_retries, t_recovery, degradations, rolled_back, resumed_step}.
    #: None for a clean run (or one not under ``run_supervised``).
    recovery: Optional[Dict] = None

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
        if backend is None:
            backend = SerialBackend()
        if device is None and isinstance(graph, Graph):
            # a backend may name where a host graph goes (the shard-map
            # backend: its worker 0's device)
            device = backend.home_device()
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
        self.backend = backend
        self.store = self.backend.bind(self.g, self.app, self.config)
        # bind resolved every tri-state knob through the cost model — the
        # runtime sees the same concrete config the backend built from
        self.config = self.backend.config

    # -- entry points -------------------------------------------------------
    def run(self) -> MiningResult:
        """Mine from scratch (superstep 1 seeds every vertex/edge)."""
        return self._run(None)

    def resume(self, checkpoint: Optional[str] = None) -> MiningResult:
        """Continue an interrupted run from a checkpoint file or directory
        (directory -> the latest checkpoint in it; None -> the configured
        ``checkpoint_dir``). Graph and app must fingerprint-match what the
        checkpoint was written with."""
        state = checkpoint_lib.load_for(
            checkpoint if checkpoint is not None else self.config.checkpoint_dir,
            g=self.g,
            app=self.app,
        )
        self._restore(state)
        return self._run(state)

    def _restore(self, state) -> None:
        """Put a checkpoint's sealed frontier and capacity bucket in place
        (the carried level-1 state is re-derived from the store)."""
        self.store.from_state_dict(state.store_state)
        self.backend.capacity = max(int(state.capacity), 1)

    def _join_level2(self, pending, result: MiningResult, st) -> None:
        """Join an overlapped ``host_async`` level-2 batch (DESIGN.md §15):
        replace the step's placeholder aggregate and record its patterns.
        ``t_canon`` here is the *residual* blocking wait, and the join does
        not count as a host sync (only control-flow reads do). The wait is
        the step's aggregation finishing, so the trace shows it as a second
        ``aggregate`` phase span around the ``canonicalize`` span (the
        reference leaves it outside every phase span)."""
        with obs.span("aggregate", step=st.step, join="host_async"):
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

    # -- the unified loop ---------------------------------------------------
    def _run(self, state) -> MiningResult:
        config, app, store, backend = (
            self.config, self.app, self.store, self.backend,
        )
        ckpt = (
            checkpoint_lib.Checkpointer(config, self.g, app)
            if config.checkpoint_dir is not None
            else None
        )
        #: the run's observability bundle (DESIGN.md §12): tracer + metrics
        #: registry + exporters, all no-ops unless ``config.trace`` /
        #: ``log_every`` asked for them. Kept on the runtime so tests and
        #: tools can read the spans of an in-memory traced run.
        observer = obs.RunObserver(config, backend.name, self.g.device)
        self.observer = observer
        observer.start()
        t_start = time.perf_counter()

        #: fault-injection plan (DESIGN.md §13): None (default) makes every
        #: trip a single attribute read. ``self.failed_phase`` names the
        #: phase an exception escaped from — the supervisor's ladder key.
        plan: Optional[faults_lib.FaultPlan] = config.faults
        self.failed_phase: Optional[str] = None
        #: recovery attribution stamped by ``run_supervised`` before a
        #: retry attempt: lands on the first step this attempt executes
        #: (StepStats.n_retries / t_recovery) + an instant trace span.
        recovery = getattr(self, "recovery", None)
        self.recovery = None
        if recovery is not None:
            with obs.span("recovery", **recovery):
                pass

        #: the effective cost-model table (DESIGN.md §14): an instant span
        #: in the trace + a RunStats record.
        decisions = backend.decisions
        with obs.span(
            "cost_model", source=decisions.source, **decisions.decisions(),
        ):
            pass

        if state is None:
            result = MiningResult(
                patterns={}, aggregates=[], stats=RunStats(), embeddings={}
            )
            prior_wall = 0.0
            store.append(programs.initial_frontier(self.g, app.mode))
            store.seal(1)
            size, first_step = 1, 1
        else:
            result = MiningResult(
                patterns=dict(state.patterns),
                aggregates=list(state.aggregates),
                stats=RunStats(steps=list(state.stats_steps)),
                embeddings=dict(state.embeddings),
            )
            prior_wall = state.wall_time
            size, first_step = state.size, state.step
        result.stats.cost_model = decisions.as_dict()

        #: fused mode: level-1 state of the sealed frontier, carried from
        #: the previous superstep's chunk programs. Dropped across a resume
        #: (recomputed from the store, same result).
        carried: Optional[object] = None

        try:
            for step in range(first_step, config.max_steps + 1):
                b = store.n_rows
                if b == 0:
                    break
                st = StepStats(step=step, size=size, n_frontier=b)
                if recovery is not None:
                    st.n_retries = int(recovery.get("n_retries", 0))
                    st.t_recovery = float(recovery.get("t_recovery", 0.0))
                    recovery = None
                st.frontier_bytes = store.raw_bytes
                if store.kind == "odag":
                    st.odag_bytes = store.stored_bytes
                timer = Timer()
                done = False
                with obs.span("superstep", step=step, size=size, frontier=b):
                    # ---- re-materialise the frontier (waves) --------------
                    with obs.span("materialize", step=step):
                        self.failed_phase = "materialize"
                        faults_lib.trip(plan, "materialize", step)
                        blocks = backend.begin_step(store, st)
                        # extraction may resurrect pattern-pruned rows (a
                        # superset of the appended rows; see ODAGStore) —
                        # stats count what is actually mined
                        st.n_frontier = sum(len(blk) for blk in blocks)
                    obs.set_stat(st, "t_storage", timer.lap())

                    # ---- pattern aggregation of this step's embeddings
                    # (end of the step that generated them, per Algorithm
                    # 1); a None canon_slot means level 1 stayed on the
                    # device (DESIGN.md §10) ----------------------------
                    canon_slot = None
                    agg = None
                    pending = None
                    if app.wants_patterns:
                        with obs.span(
                            "aggregate", step=step, frontier=st.n_frontier
                        ), obs.annotate("aggregate"):
                            self.failed_phase = "aggregate"
                            faults_lib.trip(plan, "aggregate", step)
                            agg, canon_slot = backend.aggregate_step(
                                blocks, size, carried, st
                            )
                            if isinstance(agg, aggregation.PendingLevel2):
                                # host_async placement: the level-2 batch
                                # runs on a background thread; the
                                # placeholder is replaced at the join after
                                # the next seal
                                pending, agg = agg, None
                            result.aggregates.append(agg)
                    carried = None
                    obs.set_stat(st, "t_aggregate", timer.lap())

                    # ---- alpha: aggregation filter on the frontier --------
                    with obs.span("alpha", step=step):
                        self.failed_phase = "alpha"
                        faults_lib.trip(plan, "alpha", step)
                        if agg is not None:
                            if canon_slot is not None:
                                # host path: per-row alpha over per-row
                                # canonical slots
                                alpha = app.aggregation_filter(canon_slot, agg)
                                surviving = (
                                    np.unique(canon_slot[alpha])
                                    if alpha.any()
                                    else []
                                )
                            else:
                                # device path: alpha at pattern granularity;
                                # the O(B) row mask only materialises when
                                # pruning fires
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
                            # beta / outputs: aggregates of surviving
                            # patterns
                            for pc in surviving:
                                code = tuple(
                                    int(x) for x in agg.canon_codes[pc]
                                )
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

                    # ---- termination ---------------------------------------
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
                        # ---- expansion: children appended to the store ---
                        with obs.span(
                            "expand", step=step, frontier=b_live
                        ), obs.annotate("expand"):
                            self.failed_phase = "expand"
                            faults_lib.trip(plan, "expand", step)
                            carried = backend.expand(store, blocks, size, st)
                            obs.fence(carried)
                        obs.set_stat(st, "t_expand", timer.lap())
                        with obs.span("seal", step=step):
                            self.failed_phase = "seal"
                            faults_lib.trip(plan, "seal", step)
                            store.seal(size + 1)
                            st.n_children = store.n_rows
                        obs.count(st, "t_storage", timer.lap())
                        if pending is not None:
                            # join the overlapped level-2 batch at the seal
                            # boundary: only the residual wait lands on the
                            # critical path, and the cut below never
                            # carries an in-flight future
                            self._join_level2(pending, result, st)
                        backend.end_step(store, st)
                        result.stats.steps.append(st)

                        # ---- checkpoint at the seal boundary (§9) --------
                        if (
                            ckpt is not None
                            and store.n_rows
                            and step % max(config.checkpoint_every, 1) == 0
                        ):
                            with obs.span(
                                "checkpoint", step=step
                            ), obs.annotate("checkpoint"):
                                self.failed_phase = "checkpoint"
                                faults_lib.trip(plan, "checkpoint", step)
                                obs.set_stat(
                                    st, "t_checkpoint",
                                    ckpt.save(
                                        step=step + 1,
                                        size=size + 1,
                                        capacity=backend.capacity,
                                        store=store,
                                        result=result,
                                        wall_time=prior_wall
                                        + (time.perf_counter() - t_start),
                                    ),
                                )
                                # benign corruption fault: tamper the cut
                                # just written (keeps the stale checksum)
                                # so a resume must detect + roll back past it
                                if faults_lib.take(
                                    plan, "checkpoint", step, "corrupt"
                                ):
                                    faults_lib.corrupt_checkpoint(
                                        checkpoint_lib.checkpoint_path(
                                            ckpt.directory, step + 1
                                        )
                                    )
                observer.step_done(st)
                if done or store.n_rows == 0:
                    break
                size += 1

            result.stats.wall_time = prior_wall + (
                time.perf_counter() - t_start
            )
            backend.finalize(result.stats)
            self.failed_phase = None
            result.trace_path = observer.finish(
                wall_time=result.stats.wall_time
            )
            return result
        finally:
            # exception path: uninstall the tracer/registry so a failed
            # traced run can't leak observation into later runs; exports
            # the partial trace (idempotent after a normal finish), marked
            # aborted
            observer.finish(
                wall_time=prior_wall + (time.perf_counter() - t_start),
                aborted=True,
            )


def resume(
    graph: Graph | DeviceGraph | PartitionedGraph,
    app: MiningApp,
    checkpoint: str,
    config: Optional[RunConfig] = None,
    backend: Optional[ExecutionBackend] = None,
    device=None,
) -> MiningResult:
    """Resume a checkpointed run to completion.

    ``checkpoint`` is a checkpoint file or a directory (the latest one in
    it wins). ``config`` may differ from the interrupted run's, but the
    store kind must match the payload and graph/app must fingerprint-match.
    A host ``Graph`` is uploaded to ``device`` as :func:`engine.run` does."""
    return SuperstepRuntime(graph, app, config, backend, device).resume(
        checkpoint
    )


def _release_attempt(exc: BaseException, kind: str, device) -> None:
    """Free what a failed attempt holds before the next one binds: its
    exception's traceback frames (they reference the attempt's runtime,
    store and level-1 tables), the garbage cycles among them, and after an
    ``oom`` the CUDA caching allocator's free blocks."""
    traceback.clear_frames(exc.__traceback__)
    exc.__traceback__ = None
    gc.collect()
    if kind == "oom" and device is not None and device.type == "cuda":
        torch.cuda.empty_cache()


def run_supervised(
    graph: Graph | DeviceGraph | PartitionedGraph,
    app: MiningApp,
    config: Optional[RunConfig] = None,
    backend: Optional[ExecutionBackend] = None,
    device=None,
) -> MiningResult:
    """The fault-tolerant entry point (DESIGN.md §13): the BSP loop under
    a supervisor with bounded retry from the last *valid* checkpoint.

    On a failed attempt the supervisor classifies the failure
    (``faults.classify_failure``), sleeps the exponential backoff
    (``retry_backoff * 2**(k-1)``), reloads the newest checkpoint whose
    SHA-256 verifies (``checkpoint.load_latest_valid`` — corrupt cuts are
    rolled back past), and re-runs. When the SAME phase fails repeatedly —
    or at once for an OOM — it takes one rung of the degradation ladder
    (``faults.apply_degradation``) and retries under a strictly safer
    config; every downshift is recorded in the recovery report and the
    trace's recovery span, and the retry stamps ``StepStats.n_retries`` /
    ``t_recovery`` on its first step. After ``max_retries`` failed retries
    the last failure re-raises. Fingerprint mismatches (wrong graph/app)
    and ``fatal`` failures (a kernel build error, a CUDA runtime error)
    raise at once: no retry, no rung. On the card the ladder ends before
    the rungs that move a kernel's work to its plain version or the host
    (``faults.CPU_ONLY_RUNGS``).

    Before a retry binds, the failed attempt's runtime and its exception's
    frames are dropped (after an OOM the caching allocator's free blocks
    too), so two attempts never hold their device tables at once.

    With no ``checkpoint_dir`` configured, a private temporary directory
    with ``checkpoint_every=1`` provides the retry cut (cleaned up on
    return); a configured directory is used as-is, cadence included.
    ``backend`` is reused by every attempt (its ``bind`` starts afresh);
    ``device`` is where a host ``Graph`` is uploaded."""
    import tempfile

    config = config if config is not None else RunConfig()
    owned_dir = None
    if config.checkpoint_dir is None:
        owned_dir = tempfile.TemporaryDirectory(prefix="repro-supervise-")
        config = dataclasses.replace(
            config, checkpoint_dir=owned_dir.name, checkpoint_every=1
        )
    try:
        attempt = 0              # retries consumed so far
        fail_counts: Dict[tuple, int] = {}
        degradations: List[str] = []
        pending_t = 0.0          # recovery seconds accrued in the except arm
        while True:
            t0 = time.perf_counter()
            runtime = SuperstepRuntime(graph, app, config, backend, device)
            state = None
            if attempt:
                # newest checkpoint that passes its checksum; corrupt cuts
                # (including one the failure itself tore) are skipped
                state, _, skipped = checkpoint_lib.load_latest_valid(
                    config.checkpoint_dir, runtime.g, app
                )
                if state is not None:
                    runtime._restore(state)
                runtime.recovery = {
                    "n_retries": attempt,
                    "t_recovery": round(
                        pending_t + (time.perf_counter() - t0), 6
                    ),
                    "degradations": list(degradations),
                    "rolled_back": len(skipped),
                    "resumed_step": int(state.step) if state else 0,
                }
            recovery_report = getattr(runtime, "recovery", None)
            try:
                result = runtime._run(state)
                result.recovery = recovery_report
                return result
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:
                attempt += 1
                kind = faults_lib.classify_failure(exc)
                if kind == faults_lib.FATAL or attempt > max(
                    int(config.max_retries), 0
                ):
                    raise
                t_fail = time.perf_counter()
                phase = getattr(runtime, "failed_phase", None) or "expand"
                run_device = runtime.g.device
                runtime = state = None
                _release_attempt(exc, kind, run_device)
                key = (phase, kind)
                fail_counts[key] = fail_counts.get(key, 0) + 1
                # the ladder: repeated failure of the same phase — or any
                # deterministic resource failure — downshifts the config
                if fail_counts[key] >= 2 or kind in ("oom", "halo"):
                    config, event = faults_lib.apply_degradation(
                        config, phase, kind,
                        on_card=run_device.type == "cuda",
                    )
                    if event is not None:
                        degradations.append(event)
                if config.retry_backoff > 0:
                    time.sleep(config.retry_backoff * 2 ** (attempt - 1))
                pending_t = time.perf_counter() - t_fail
    finally:
        if owned_dir is not None:
            owned_dir.cleanup()
