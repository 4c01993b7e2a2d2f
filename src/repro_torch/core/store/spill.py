"""Device-budgeted frontier waves: larger-than-memory mining (DESIGN.md §7),
port of ``repro.core.store.spill``.

``SpillStore`` wraps any :class:`FrontierStore` and bounds how many rows a
single ``chunks`` wave may materialise, derived from a byte budget for the
device-resident slice. The runtime then mines one wave at a time, so the
peak device footprint of a superstep is ``O(budget)`` instead of ``O(B·k)``
— frontiers larger than device memory are mined in waves while the
between-step representation stays whatever the inner store uses (dense rows
on the host, or an ODAG).

The inner store's cost-balanced chunking is reused when available (the
ODAG store's §5.3 partitions); waves it over-shoots (a single hub element
whose subtree exceeds the budget) are sliced down to the hard row bound
here.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core import obs
from repro_torch.core.store.base import FrontierStore


class SpillStore(FrontierStore):
    def __init__(self, inner: FrontierStore, device_budget_bytes: int) -> None:
        if device_budget_bytes <= 0:
            raise ValueError("device_budget_bytes must be positive")
        self._inner = inner
        self._budget_bytes = int(device_budget_bytes)

    @property
    def kind(self) -> str:  # type: ignore[override]
        return self._inner.kind

    @property
    def inner(self) -> FrontierStore:
        return self._inner

    def budget_rows(self) -> int:
        """Rows of the current width that fit the device byte budget."""
        return max(1, self._budget_bytes // (max(self._inner.size, 1) * 4))

    # -- delegation --------------------------------------------------------
    def append(self, rows, worker: int = 0, count=None) -> None:
        self._inner.append(rows, worker=worker, count=count)

    def seal(self, size: int) -> None:
        with obs.span("store.seal", kind=f"spill[{self._inner.kind}]",
                      size=size, budget_rows=self.budget_rows()):
            self._inner.seal(size)

    @property
    def n_rows(self) -> int:
        return self._inner.n_rows

    @property
    def size(self) -> int:
        return self._inner.size

    @property
    def stored_bytes(self) -> int:
        return self._inner.stored_bytes

    @property
    def exchange_bytes(self) -> int:
        return self._inner.exchange_bytes

    def materialize(self) -> np.ndarray:
        return self._inner.materialize()

    def worker_parts(self, n_workers: int) -> List[np.ndarray]:
        return self._inner.worker_parts(n_workers)

    def state_dict(self) -> dict:
        # the budget is config, not state: the payload is the inner store's,
        # so a run may resume with a different (or no) device budget
        return self._inner.state_dict()

    def from_state_dict(self, sd: dict) -> None:
        self._inner.from_state_dict(sd)

    # -- the point of the wrapper -----------------------------------------
    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        budget = self.budget_rows()
        if max_rows is not None:
            budget = min(budget, max_rows)
        for wave in self._inner.chunks(budget):
            for lo in range(0, len(wave), budget):
                yield wave[lo: lo + budget]
