"""The pluggable execution-backend protocol of the superstep runtime, port
of ``repro.core.runtime.backend``.

One :class:`repro_torch.core.runtime.loop.SuperstepRuntime` loop drives a
run; an :class:`ExecutionBackend` says how the sealed frontier is
re-materialised, how level-1 aggregation is reduced, and how the expansion
is dispatched: :class:`repro_torch.core.runtime.serial.SerialBackend` on
one device, :class:`repro_torch.core.runtime.shard.ShardMapBackend` on a
mesh of workers.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import obs
from repro_torch.core.aggregation import StepAggregates
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.runtime.config import RunConfig
from repro_torch.core.stats import RunStats, StepStats
from repro_torch.core.store import FrontierStore


class ExecutionBackend(abc.ABC):
    """One BSP superstep's execution strategy, behind the unified loop."""

    name: str = "base"

    def home_device(self):
        """Where the runtime uploads a host graph when the caller names no
        device: None -> the current CUDA device (``resolve_device``)."""
        return None

    def bind(self, g: DeviceGraph, app: MiningApp,
             config: RunConfig) -> FrontierStore:
        """Attach to one run: resolve every tri-state knob through the
        cost model, ONCE, and build the frontier store and the chunk
        programs. ``capacity`` is the persistent output-capacity bucket —
        it survives across supersteps."""
        from repro_torch.core.runtime import costmodel

        config, self.decisions = costmodel.resolve(config, g, app, self.name)
        config.validate()
        self.g = g
        self.app = app
        self.config = config
        self.capacity = max(config.initial_capacity, 1)
        return self._make_store()

    @abc.abstractmethod
    def _make_store(self) -> FrontierStore:
        """Build the store this backend mines through."""

    # -- one superstep, in loop order --------------------------------------
    @abc.abstractmethod
    def begin_step(self, store: FrontierStore,
                   st: StepStats) -> List[np.ndarray]:
        """Re-materialise the sealed frontier as row blocks."""

    @abc.abstractmethod
    def quick_codes(
        self, blocks: List[np.ndarray], size: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Quick-pattern ``(codes (B,3) int64, local_verts (B,8) int32)``
        of the materialised frontier — only called when the previous step's
        chunk programs did not carry them."""

    @abc.abstractmethod
    def aggregate(
        self, codes: np.ndarray, lv: np.ndarray, st: StepStats
    ) -> Tuple[StepAggregates, np.ndarray]:
        """Two-level pattern aggregation over the frontier's quick codes.
        Returns ``(aggregates, per-row canonical slot)``."""

    def aggregate_step(
        self, blocks: List[np.ndarray], size: int, carried, st: StepStats
    ) -> Tuple[StepAggregates, Optional[np.ndarray]]:
        """One superstep's pattern aggregation, end to end (the host
        reference flow). A ``None`` slot array means level 1 stayed on the
        device and alpha goes through ``app.pattern_filter`` +
        :meth:`alpha_rows`."""
        n_frontier = sum(len(blk) for blk in blocks)
        if (
            isinstance(carried, tuple)
            and len(carried) == 2
            and len(carried[0]) == n_frontier
        ):
            codes, lv = carried
        else:
            codes, lv = self.quick_codes(blocks, size)
        obs.count(st, "bytes_to_host", codes.nbytes + lv.nbytes)
        return self.aggregate(codes, lv, st)

    def alpha_rows(self, pk: np.ndarray, st: StepStats) -> np.ndarray:
        """Per-row alpha mask over the materialised frontier, derived from
        the per-pattern verdict ``pk``. Only called when ``pk`` prunes."""
        raise NotImplementedError(
            "per-row alpha requires the host aggregation path"
        )

    def prune(self, blocks: List[np.ndarray],
              alpha: np.ndarray) -> List[np.ndarray]:
        """Apply the app's aggregation filter to the materialised blocks
        (the mask spans their concatenation, in order)."""
        off, pruned = 0, []
        for blk in blocks:
            pruned.append(blk[alpha[off: off + len(blk)]])
            off += len(blk)
        return pruned

    @abc.abstractmethod
    def expand(self, store: FrontierStore, blocks: List[np.ndarray],
               size: int, st: StepStats) -> Optional[tuple]:
        """Expand the frontier one size, appending children to ``store``.
        Returns carried level-1 state of the children when the chunk
        programs computed it in the same pass (DESIGN.md §8), else None."""

    def end_step(self, store: FrontierStore, st: StepStats) -> None:
        """Post-seal accounting hook."""

    def finalize(self, stats: RunStats) -> None:
        """End-of-run accounting hook (chunk signatures)."""
