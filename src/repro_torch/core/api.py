"""The filter-process programming model (paper §3, §4.1), port of
``repro.core.api``.

Applications implement the paper's user-defined functions. The one device
adaptation: functions are *vectorised* — they receive a batch of embeddings
as arrays and return boolean masks, instead of being called per embedding.
Automorphism invariance and anti-monotonicity (paper §3.1 "Guarantees and
requirements") are still the application's obligation; the property tests
check them for the bundled apps.

Mapping to the paper's API (Figure 3):
  filter              -> :meth:`MiningApp.filter`           (phi)
  process             -> engine output collection + :meth:`process_outputs`
  aggregationFilter   -> :meth:`MiningApp.aggregation_filter` (alpha)
  aggregationProcess  -> :meth:`MiningApp.aggregation_process` (beta)
  terminationFilter   -> :meth:`MiningApp.termination_filter`
  map/reduce          -> pattern-keyed aggregation in the engine (§5.4)
  readAggregate       -> the ``agg`` argument handed to alpha/beta
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import DeviceGraph


@dataclasses.dataclass
class MiningApp:
    """Base class: explores everything up to ``max_size`` (no pruning)."""

    #: 'vertex' (vertex-induced) or 'edge' (edge-induced) exploration (§3.1)
    mode: str = "vertex"
    #: stop after embeddings reach this many vertices (vertex mode) or edges
    #: (edge mode); the terminationFilter optimisation of §4.1.
    max_size: Optional[int] = None
    #: run pattern aggregation each step (two-level, §5.4)
    wants_patterns: bool = True
    #: compute FSM-style min-image domains during aggregation
    wants_domains: bool = False
    #: keep explored embeddings in the result (paper ``output(e)``)
    collect_embeddings: bool = False

    # -- phi: candidate filter, vectorised ---------------------------------
    def filter(
        self,
        g: DeviceGraph,
        members: torch.Tensor,   # (C, k) parent embeddings of the chunk
        n_valid: torch.Tensor,   # (C,)
        rows: torch.Tensor,      # (Ncand,) parent row per candidate
        cand: torch.Tensor,      # (Ncand,) extension vertex/edge id
    ) -> torch.Tensor:
        """Anti-monotonic candidate predicate; default: accept all."""
        return torch.ones(rows.shape, dtype=torch.bool, device=rows.device)

    # -- alpha: aggregation filter, pattern-granular -----------------------
    def pattern_filter(self, agg) -> Optional[np.ndarray]:
        """Per-PATTERN keep mask ``(Pc,) bool`` over ``agg.canon_codes``,
        or None for keep-all (the default alpha). This is the granularity
        the device-resident aggregation evaluates alpha at (DESIGN.md §10):
        per-row masks are derived on device from per-pattern verdicts, so
        no per-row state has to cross to the host unless pruning actually
        fires. Apps that genuinely need per-*row* alpha override
        :meth:`aggregation_filter` instead (and the engine falls back to
        the host aggregation path for them)."""
        return None

    # -- alpha: aggregation filter on the frontier, host-side --------------
    def aggregation_filter(
        self,
        canon_slot: np.ndarray,     # (B,) canonical-pattern slot per frontier row
        agg,                        # StepAggregates from the generating step
    ) -> np.ndarray:
        """Prune frontier rows using aggregates of their generating step;
        default: broadcast :meth:`pattern_filter` to rows (keep all when it
        returns None — paper: alpha defaults to true)."""
        pk = self.pattern_filter(agg)
        if pk is None:
            return np.ones(canon_slot.shape, dtype=bool)
        pk = np.asarray(pk, dtype=bool)
        return np.where(
            canon_slot >= 0, pk[np.maximum(canon_slot, 0)], False
        )

    # -- beta: aggregation process (outputs keyed by pattern) --------------
    def aggregation_process(self, agg) -> Optional[dict]:
        """Return the per-pattern outputs for this step (or None)."""
        return None

    # -- termination filter -------------------------------------------------
    def termination_filter(self, size_after_step: int) -> bool:
        """True -> stop expanding after this size (default: max_size)."""
        return self.max_size is not None and size_after_step >= self.max_size
