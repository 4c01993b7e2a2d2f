"""ODAG-backed frontier store (paper §5.2/§5.3, DESIGN.md §7), port of
``repro.core.store.odag_store``.

Between supersteps the frontier lives as one per-size ODAG instead of a
dense embedding list: O(k·N²) bits instead of O(B·k) rows — the compression
that lets Arabesque's supersteps exceed memory (Fig. 9). The ODAG is built
on the host at ``seal``, with the CSR form of its connectivity that
extraction enumerates. Re-materialisation walks the ODAG back into rows on
the graph's device, re-applying exactly the Algorithm-1 filters (validity +
incremental canonicality + the app's phi), which by completeness removes
every spurious path.

Reads are cost-balanced (§5.3): ``worker_parts`` annotates first-level
elements with their path counts via
:func:`repro_torch.core.odag.partition_by_cost` and extracts one
approximately equal-cost partition per worker; ``chunks`` uses the same
machinery to bound the rows materialised per wave.

Frontier-set semantics: extraction returns a superset of the appended rows
only when earlier supersteps pruned embeddings by *pattern* (FSM's alpha);
such resurrected rows belong to unsupported patterns by anti-monotonicity,
so the next superstep's alpha re-prunes them and pattern outputs are
unchanged. The rows resurrected are exactly the reference's.

Only the single-worker seal is ported; the dense exchange of the
distributed backend waits (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core import obs
from repro_torch.core import odag as odag_lib
from repro_torch.core.store.base import FrontierStore, resolve_rows


class ODAGStore(FrontierStore):
    kind = "odag"

    def __init__(self, g, *, mode: str = "vertex", app_filter=None,
                 use_pallas: bool = False) -> None:
        self._g = g
        self._mode = mode
        self._app_filter = app_filter
        self._use_pallas = use_pallas
        self._staged: List[tuple] = []       # (rows, count) lazy blocks
        self._odag: Optional[odag_lib.ODAG] = None
        self._csr: List[odag_lib.CSR] = []
        self._n_rows = 0
        self._size = 1
        self._exchange_bytes = 0
        #: extraction counters summed over the run (``odag.extract``'s
        #: ``stats``: levels, chunks, pairs, kept, host_syncs)
        self.extract_stats: Dict[str, int] = {}

    # -- write side --------------------------------------------------------
    def append(self, rows, worker: int = 0, count=None) -> None:
        if len(rows) and (count is None or count):
            self._staged.append((rows, count))

    def seal(self, size: int) -> None:
        with obs.span("store.seal", kind="odag", size=size):
            blocks = [resolve_rows(r, c) for r, c in self._staged]
            blocks = [b for b in blocks if len(b)]
            self._staged = []
            self._size = size
            self._n_rows = sum(len(b) for b in blocks)
            if not self._n_rows:
                self._odag, self._csr = None, []
                self._exchange_bytes = 0
                return
            self._odag = odag_lib.build(np.concatenate(blocks, axis=0), k=size)
            self._csr = odag_lib.conn_csr(self._odag)
            self._exchange_bytes = self._odag.n_bytes

    # -- read side ---------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def size(self) -> int:
        return self._size

    @property
    def stored_bytes(self) -> int:
        return self._odag.n_bytes if self._odag is not None else 0

    @property
    def exchange_bytes(self) -> int:
        return self._exchange_bytes

    @property
    def odag(self) -> Optional[odag_lib.ODAG]:
        """The sealed per-size ODAG (None when the frontier is empty)."""
        return self._odag

    def _extract(self, mask: Optional[np.ndarray] = None) -> np.ndarray:
        kw = dict(app_filter=self._app_filter, mode=self._mode,
                  use_pallas=self._use_pallas, stats=self.extract_stats)
        with obs.span("odag.extract", rows=int(self._n_rows),
                      partition=mask is not None):
            if mask is None:
                return odag_lib.extract(self._g, self._odag, csr=self._csr,
                                        **kw)
            return odag_lib.extract_partition(self._g, self._odag, mask,
                                              csr=self._csr, **kw)

    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        if self._odag is None:
            return
        if max_rows is None:
            rows = self._extract()
            if len(rows):
                yield rows
            return
        # §5.3 cost-annotated waves: split the first-level domain into
        # approximately equal-cost runs, one extraction per run. The wave
        # count comes from the appended row count; the balancing uses the
        # cost annotation. A single over-budget first-level element (hub)
        # extracts as one partition whose rows are then sliced, so the
        # yielded waves honour the hard max_rows bound.
        n_parts = max(1, -(-self._n_rows // max(max_rows, 1)))
        n_parts = min(n_parts, max(len(self._odag.domains[0]), 1))
        for mask in odag_lib.partition_by_cost(self._odag, n_parts):
            if not mask.any():
                continue
            rows = self._extract(mask)
            for lo in range(0, len(rows), max_rows):
                yield rows[lo: lo + max_rows]

    def worker_parts(self, n_workers: int) -> List[np.ndarray]:
        """Cost-balanced per-worker slices (§5.3)."""
        if self._odag is None:
            return [np.zeros((0, self._size), np.int32)] * n_workers
        masks = odag_lib.partition_by_cost(self._odag, n_workers)
        return [
            self._extract(m) if m.any()
            else np.zeros((0, self._size), np.int32)
            for m in masks
        ]

    def state_dict(self) -> dict:
        """The per-level domains and bit-packed connectivity of the sealed
        ODAG, in the reference's payload format: the compressed form is
        what is persisted."""
        arrays = {}
        levels = 0
        if self._odag is not None:
            levels = self._odag.k
            for i, d in enumerate(self._odag.domains):
                arrays[f"domain{i}"] = d
            for i, c in enumerate(self._odag.conn):
                arrays[f"conn{i}"] = np.packbits(c, axis=1)
        return {
            "kind": "odag",
            "meta": {
                "size": int(self._size),
                "n_rows": int(self._n_rows),
                "exchange_bytes": int(self._exchange_bytes),
                "levels": levels,
                "conn_widths": (
                    [int(c.shape[1]) for c in self._odag.conn]
                    if self._odag is not None
                    else []
                ),
            },
            "arrays": arrays,
        }

    def from_state_dict(self, sd: dict) -> None:
        self._check_kind(sd)
        meta = sd["meta"]
        self._size = int(meta["size"])
        self._n_rows = int(meta["n_rows"])
        self._exchange_bytes = int(meta["exchange_bytes"])
        self._staged = []
        levels = int(meta["levels"])
        if not levels:
            self._odag, self._csr = None, []
            return
        domains = [
            np.asarray(sd["arrays"][f"domain{i}"], dtype=np.int32)
            for i in range(levels)
        ]
        conn = [
            np.unpackbits(
                np.asarray(sd["arrays"][f"conn{i}"], dtype=np.uint8), axis=1
            )[:, : int(meta["conn_widths"][i])].astype(bool)
            for i in range(levels - 1)
        ]
        self._odag = odag_lib.ODAG(k=levels, domains=domains, conn=conn)
        self._csr = odag_lib.conn_csr(self._odag)
