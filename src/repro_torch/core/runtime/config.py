"""The one run configuration of the superstep runtime (DESIGN.md §9), port
of ``repro.core.runtime.config``.

Same knobs and defaults as the JAX package's ``RunConfig``, less what has
no meaning here (``pallas_interpret``) or belongs to parts not ported yet
(the distributed backend, calibration, the supervisor). Knobs whose paths
are not ported keep their field so a config reads the same in both
packages; a run that sets them raises ``NotImplementedError``
(:meth:`RunConfig.check_ported`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.dispatch import resolve_canonical_placement

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
    #: how the frontier lives between supersteps; only "raw" is ported.
    store: str = "raw"
    #: device byte budget for one materialised frontier wave (spill store,
    #: not ported: must stay None).
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
    #: how the None/auto knobs resolve: "auto" and "off" give the static
    #: table (calibration is not ported yet, so "auto" resolves like it);
    #: "force_device" / "force_host" pin the placement extremes.
    cost_model: str = "auto"
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
    #: superstep checkpoints (not ported: must stay None).
    checkpoint_dir: Optional[str] = None
    #: tracing / progress log (not ported: must stay off).
    trace: bool = False
    log_every: int = 0
    #: fault-injection plan (not ported: must stay None).
    faults: Optional[object] = None

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a knob whose path the port
        does not have yet (ROADMAP.md lists them in order)."""
        unported = {
            "checkpoint_dir": self.checkpoint_dir is not None,
            "faults": self.faults is not None,
            "store": self.store != "raw",
            "device_budget_bytes": self.device_budget_bytes is not None,
        }
        # unknown values raise ValueError
        self.resolve_canonical_placement()
        self.resolve_aggregate_bin()
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{', '.join(bad)}: not ported to repro_torch yet; see "
                "ROADMAP.md"
            )

    def resolve_aggregate_bin(self) -> str:
        got = "sort" if self.aggregate_bin is None else self.aggregate_bin
        if got not in AGGREGATE_BINS:
            raise ValueError(f"unknown aggregate_bin {got!r} (expected one "
                             f"of {AGGREGATE_BINS})")
        return got

    def resolve_canonical_placement(self) -> str:
        return resolve_canonical_placement(self.canonical_placement)
