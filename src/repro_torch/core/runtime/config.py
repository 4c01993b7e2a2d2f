"""The one run configuration of the superstep runtime (DESIGN.md §9), port
of ``repro.core.runtime.config``.

Same knobs and defaults as the JAX package's ``RunConfig``, less
``pallas_interpret``, which has no meaning here. The serial backend ignores
the shard-map backend's knobs (``halo``, ``axes``, ``naive_aggregation``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.dispatch import (
    resolve_canonical_placement, resolve_halo,
)

#: level-1 row-binning algorithms (``RunConfig.aggregate_bin``).
AGGREGATE_BINS = ("sort", "radix")


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1): THE capacity-bucket rule.

    Chunk widths and output capacities are bucketed to powers of two so the
    set of chunk-program shapes stays O(log) per size (DESIGN.md §8)."""
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass
class RunConfig:
    """Configuration of one mining run (DESIGN.md §9)."""

    chunk_size: int = 4096        # frontier rows per expansion program
    initial_capacity: int = 4096  # starting output-capacity bucket
    max_steps: int = 16           # hard cap on exploration depth
    #: route the Alg.-2 canonicality check through the ``canonical_check``
    #: kernel (vertex mode). None -> cost model: on for CUDA tensors.
    use_pallas: Optional[bool] = None
    #: with use_pallas, fuse candidate validity + dedup + Alg.-2 into the
    #: single-pass ``expand_canonical`` kernel (vertex mode).
    fused_expand: bool = False
    #: how the frontier lives between supersteps: "raw" keeps the dense
    #: embedding list, "odag" stores per-size ODAGs (paper §5.2) and
    #: re-materialises them with cost-balanced extraction (§5.3).
    store: str = "raw"
    #: device byte budget for one materialised frontier wave; when set, the
    #: frontier store is wrapped in a SpillStore and each superstep is mined
    #: in waves of at most this many bytes of rows.
    device_budget_bytes: Optional[int] = None
    #: fused superstep pipeline (DESIGN.md §8): a pilot chunk plus stacked
    #: drains, at most two host syncs per superstep. False = the chunk loop
    #: with one host sync per chunk. None -> cost model (True).
    async_chunks: Optional[bool] = None
    #: route chunk compaction through the ``stream_compact`` kernel.
    #: None -> cost model: on for CUDA tensors.
    compact_kernel: Optional[bool] = None
    #: device-resident level-1 pattern aggregation (DESIGN.md §10); False =
    #: the host reference path. None -> cost model (True).
    device_aggregate: Optional[bool] = None
    #: route the level-1 segment-unique/reduce through the ``seg_unique``
    #: kernel. None -> cost model: on for CUDA tensors.
    aggregate_kernel: Optional[bool] = None
    #: row-binning algorithm of the level-1 bin: "sort" (library sort +
    #: ``seg_unique``) or "radix" (the radix kernels). None -> cost model.
    aggregate_bin: Optional[str] = None
    #: where level-2 canonicalisation runs: "host", "host_async" (a
    #: background thread joined at the next seal) or "device" (the
    #: canonical-refine kernel). None -> cost model.
    canonical_placement: Optional[str] = None
    #: LRU cap of the process-wide quick->canonical memo
    #: (``pattern.set_memo_cap``); None keeps the default.
    canonical_memo_cap: Optional[int] = None
    #: how the None/auto knobs resolve (DESIGN.md §14): "auto" runs the
    #: pilot-calibrated cost model on graphs of at least
    #: ``cost_model_min_edges`` edges (probe timings pick the fastest
    #: implementation per phase, cached per (device type, app, graph,
    #: config) signature) and the static table below that; "off" pins the
    #: static table; "force_device" / "force_host" pin the placement
    #: extremes.
    cost_model: str = "auto"
    #: directory the calibrated decision tables persist in (JSON, one file
    #: per signature), so a fresh process skips the pilot. None -> the
    #: table is cached process-wide only.
    cost_model_dir: Optional[str] = None
    #: graphs with fewer edges than this resolve through the static table
    #: without calibrating.
    cost_model_min_edges: int = 2048
    #: starting capacity of the cross-batch level-1 merge table, grown pow2
    #: on overflow.
    agg_qcap: int = 4096
    #: number of graph shards of the partitioned layout (DESIGN.md §11):
    #: the graph lives as stacked per-shard CSR tables + packed adjacency
    #: tiles (``core.graph.PartitionedGraph``) and the fused pipeline opens
    #: with a halo-tile gather instead of whole-graph lookups. None keeps
    #: the whole-graph layout.
    graph_partition: Optional[int] = None
    #: partition boundary placement: "degree" balances adjacency payload
    #: per shard, "vertex" splits the id space evenly.
    partition_balance: str = "degree"
    #: halo-exchange strategy of the partitioned shard-map superstep:
    #: "alltoall" (request/response all-to-all, O(halo) bytes a worker),
    #: "gather" (all-gather of the shard tables, O(n)), or None/"auto" ->
    #: "alltoall" (``kernels.dispatch.resolve_halo``).
    halo: Optional[str] = None
    #: mesh axes the shard-map backend shards the frontier over.
    axes: tuple = ("data",)
    #: disable two-level aggregation (the shard-map backend's baseline):
    #: every worker ships all embeddings' quick codes and each embedding's
    #: pattern is canonicalised on its own — the paper's Fig. 11 naive
    #: scheme.
    naive_aggregation: bool = False
    #: directory for superstep-granular checkpoints (DESIGN.md §9): the
    #: runtime writes {sealed store payload, stats, patterns, superstep
    #: cursor, app + graph fingerprints} at the seal boundary and
    #: ``runtime.resume`` continues from the latest one.
    checkpoint_dir: Optional[str] = None
    #: write a checkpoint every this-many supersteps (1 = every seal).
    checkpoint_every: int = 1
    #: collect host phase spans + metrics for this run (DESIGN.md §12);
    #: False adds no device sync and allocates no span.
    trace: bool = False
    #: directory the traced run exports to: a Chrome trace
    #: (``run-<pid>-<seq>.trace.json``) and a JSONL event stream
    #: (``.events.jsonl``). None keeps the spans in memory
    #: (``SuperstepRuntime.observer``).
    trace_dir: Optional[str] = None
    #: blocking phase boundaries (``torch.cuda.synchronize``): host phase
    #: laps measure device completion, and the partitioned layout's tile
    #: gather is probe-timed into ``StepStats.t_gather``. Diagnostic
    #: mode; never implied by ``trace`` alone.
    trace_sync: bool = False
    #: print one structured progress line every this-many supersteps
    #: (0 = silent), with or without ``trace``.
    log_every: int = 0
    #: deterministic fault-injection plan (DESIGN.md §13): a
    #: ``runtime.faults.FaultPlan`` tripped at the loop's phase boundaries.
    #: None costs one attribute read a phase.
    faults: Optional[object] = None
    #: retry budget of ``run_supervised``: failed attempts restart from the
    #: last valid checkpoint this many times before the failure re-raises.
    max_retries: int = 3
    #: base seconds of the supervisor's exponential backoff: retry k
    #: sleeps ``retry_backoff * 2**(k-1)``.
    retry_backoff: float = 0.0
    #: keep-last-K checkpoint retention (0 = keep every cut).
    keep_checkpoints: int = 0

    def validate(self) -> None:
        """Raise ``ValueError`` for an unknown knob value."""
        self.resolve_canonical_placement()
        self.resolve_aggregate_bin()
        self.resolve_halo()

    # The kernel knobs' resolvers: an unset knob is on where the
    # hand-written kernels run (``on_card``: the run's tensors are on a
    # CUDA device), as ``costmodel.static_table`` sets it. The degradation
    # ladder reads the user's unresolved config through them.
    def resolve_use_pallas(self, on_card: bool) -> bool:
        return on_card if self.use_pallas is None else self.use_pallas

    def resolve_compact_kernel(self, on_card: bool) -> bool:
        return on_card if self.compact_kernel is None else self.compact_kernel

    def resolve_aggregate_kernel(self, on_card: bool) -> bool:
        return (
            on_card if self.aggregate_kernel is None else self.aggregate_kernel
        )

    def resolve_aggregate_bin(self) -> str:
        got = "sort" if self.aggregate_bin is None else self.aggregate_bin
        if got not in AGGREGATE_BINS:
            raise ValueError(f"unknown aggregate_bin {got!r} (expected one "
                             f"of {AGGREGATE_BINS})")
        return got

    def resolve_canonical_placement(self) -> str:
        return resolve_canonical_placement(self.canonical_placement)

    def resolve_halo(self) -> str:
        return resolve_halo(self.halo)
