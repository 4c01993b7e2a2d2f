"""Per-step execution statistics (feeds paper Figs 9/12, Tables 3/4), a
copy of ``repro.core.stats``."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


@dataclasses.dataclass
class StepStats:
    step: int = 0
    size: int = 0                    # embedding size at this step's frontier
    n_frontier: int = 0              # embeddings expanded
    n_generated: int = 0             # valid candidate slots
    n_canonical: int = 0             # survivors of the canonicality check
    n_children: int = 0              # survivors of the app filter
    n_quick_patterns: int = 0
    n_canonical_patterns: int = 0
    n_iso_checks: int = 0
    n_chunks: int = 0                # chunk programs dispatched this step
    #: host→device control syncs: times the host *blocked on a device
    #: value to decide control flow* (capacity retries, chunk loops).
    #: The PR-2 chunk loop pays one per chunk; the fused pipeline
    #: (DESIGN.md §8) drains all counts once — O(1) per superstep.
    n_host_syncs: int = 0
    frontier_bytes: int = 0          # raw embedding-list bytes (Fig 9 baseline)
    odag_bytes: int = 0              # ODAG-compressed bytes (Fig 9)
    collective_bytes: int = 0        # bytes exchanged in the distributed step
    #: device→host bytes drained by PATTERN AGGREGATION this superstep:
    #: distinct codes + counts + domain bitmaps + alpha row masks under the
    #: device-resident path (O(#patterns), DESIGN.md §10), or the full
    #: frontier's quick codes / local-vertex tables under the host
    #: reference path (O(frontier)). ``bench_aggregate.py`` gates the
    #: device path at >=10x below the per-row code payload.
    bytes_to_host: int = 0
    t_expand: float = 0.0            # G+C phases of Fig 12
    t_aggregate: float = 0.0         # P phase
    #: seconds of level-2 canonicalisation on the CRITICAL PATH
    #: (DESIGN.md §15): the host batch or device refine under sync
    #: placements, but only the residual join wait under ``host_async`` —
    #: the overlap win is exactly the sync placement's value minus this.
    #: ``bench_canon.py`` gates host_async at <=1/5 of the host wall.
    t_canon: float = 0.0
    t_storage: float = 0.0           # W+R phases (ODAG build/extract)
    #: tile-gather seconds of the partitioned layout (DESIGN.md §11/§12):
    #: ``build_tile_view`` runs INSIDE the fused chunk program, so the
    #: split is measured by a dedicated probe dispatch ONLY under
    #: ``trace_sync=True`` (serial backend, partitioned graphs); 0.0
    #: otherwise — the cost then rides ``t_expand``, as before.
    t_gather: float = 0.0
    #: halo-exchange seconds of the partitioned shard-map superstep
    #: (request/response ``all_to_all`` or ragged all-gather): probe-
    #: measured under ``trace_sync=True`` only, else folded in
    #: ``t_expand``. The exchange's WIRE bytes are always accounted
    #: (``collective_bytes``), independent of this timing.
    t_exchange: float = 0.0
    #: seconds writing this step's superstep checkpoint (DESIGN.md §9);
    #: 0.0 when checkpointing is off or the cadence skipped the step.
    #: ``bench_checkpoint.py`` gates the sum at ≤5% of superstep wall time.
    t_checkpoint: float = 0.0
    #: supervisor retries that preceded this step's (re-)execution
    #: (DESIGN.md §13): stamped by ``run_supervised`` on the first step of
    #: each recovery attempt, 0 everywhere else.
    n_retries: int = 0
    #: seconds the supervisor spent RECOVERING before this step re-ran:
    #: checkpoint reload + validation + backend rebuild + backoff sleep —
    #: the pure fault-tolerance tax, excluding re-mined supersteps.
    #: ``bench_faults.py`` gates the sum at ≤15% of superstep wall.
    t_recovery: float = 0.0

    @property
    def compression(self) -> float:
        """Fig. 9 per-step ratio: raw embedding-list bytes over what the
        frontier store actually held between supersteps (1.0 for RawStore
        or an empty frontier)."""
        if self.odag_bytes <= 0 or self.frontier_bytes <= 0:
            return 1.0
        return self.frontier_bytes / self.odag_bytes


@dataclasses.dataclass
class RunStats:
    steps: List[StepStats] = dataclasses.field(default_factory=list)
    wall_time: float = 0.0
    #: distinct chunk-program signatures dispatched during this run (the
    #: JAX package counts its jit-cache growth here); the pow2 bucketing of
    #: chunk widths and output capacities bounds this to O(log) entries per
    #: embedding size (DESIGN.md §8).
    n_compiles: int = 0
    #: the distinct (embedding_size, chunk_width, out_cap) signatures
    #: actually dispatched — width and capacity must be powers of two
    #: (tested).
    chunk_signatures: List[tuple] = dataclasses.field(default_factory=list)
    #: the effective cost-model decision table of this run (DESIGN.md §14):
    #: every resolved knob + probe timings + provenance ("static" /
    #: "calibrated" / "cached" / "forced:<mode>") — placement decisions
    #: must be observable after the fact, not inferred from timings.
    cost_model: Dict = dataclasses.field(default_factory=dict)

    @property
    def total_embeddings(self) -> int:
        return sum(s.n_children for s in self.steps) + (
            self.steps[0].n_frontier if self.steps else 0
        )

    @property
    def total_host_syncs(self) -> int:
        return sum(s.n_host_syncs for s in self.steps)

    @property
    def total_bytes_to_host(self) -> int:
        return sum(s.bytes_to_host for s in self.steps)

    def phase_walls(self) -> Dict[str, float]:
        """Per-phase wall totals over the run (Fig. 12's split, seconds)."""
        out: Dict[str, float] = {}
        for name in (
            "t_expand", "t_aggregate", "t_canon", "t_storage",
            "t_gather", "t_exchange", "t_checkpoint",
        ):
            out[name] = round(sum(getattr(s, name) for s in self.steps), 4)
        return out

    def summary(self) -> Dict:
        return {
            "steps": len(self.steps),
            "total_embeddings": self.total_embeddings,
            "total_iso_checks": sum(s.n_iso_checks for s in self.steps),
            "wall_time_s": round(self.wall_time, 4),
            "max_compression": round(
                max((s.compression for s in self.steps), default=1.0), 1
            ),
            "host_syncs": self.total_host_syncs,
            "total_bytes_to_host": self.total_bytes_to_host,
            "phase_walls_s": self.phase_walls(),
            "chunk_programs": self.n_compiles,
        }

    def compression_by_size(self) -> Dict[int, float]:
        """Per-step Fig. 9 curve: embedding size -> frontier compression."""
        return {s.size: s.compression for s in self.steps if s.odag_bytes > 0}


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
