"""Frontier-store interface + the dense-array store (DESIGN.md §7), port
of ``repro.core.store.base``.

A :class:`FrontierStore` owns how the embeddings of one BSP superstep live
*between* supersteps:

  * ``append`` child blocks while expanding (write side, staging area),
  * ``seal`` at the superstep boundary (the store may compress here — the
    paper's §5.2 storage step),
  * iterate ``chunks`` of re-materialised rows at the next superstep
    (bounded waves when a device budget is set), and
  * read byte stats (``raw_bytes`` vs ``stored_bytes``) that feed the
    Fig. 9/10 compression accounting of
    :class:`repro_torch.core.stats.StepStats`.

Concrete stores: :class:`RawStore` (this module) keeps the rows verbatim;
:class:`repro_torch.core.store.odag_store.ODAGStore` keeps them as per-size
ODAGs; :class:`repro_torch.core.store.spill.SpillStore` wraps either to
bound the rows materialised per wave. The dense ODAG exchange of the
distributed backend (``dense_exchange``) is not ported (ROADMAP.md).
"""
from __future__ import annotations

import abc
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core import obs


def resolve_rows(rows, count=None) -> np.ndarray:
    """Resolve one staged block to host int32 rows at the superstep seal.

    ``rows`` may be a host array or a tensor, on the device possibly still
    padded to its chunk program's capacity; ``count`` slices the valid
    prefix — on the device first, so only the valid rows cross to the host,
    never the padding."""
    if isinstance(rows, torch.Tensor):
        if count is not None:
            rows = rows[: int(count)]
        return rows.cpu().numpy().astype(np.int32, copy=False)
    arr = np.asarray(rows, dtype=np.int32)
    if count is not None:
        arr = arr[: int(count)]
    return arr


class FrontierStore(abc.ABC):
    """Owns one frontier (all embeddings of the current size) between steps."""

    #: "raw" or "odag" — engines use this for the Fig. 9 byte accounting.
    kind: str = "raw"

    # -- write side (during a superstep's expansion) ----------------------
    @abc.abstractmethod
    def append(self, rows, worker: int = 0, count=None) -> None:
        """Stage a block of same-size child embeddings (int32 (B, k)): host
        rows, or a capacity-padded tensor with ``count`` valid leading
        rows. Staging is lazy; blocks resolve at ``seal``
        (:func:`resolve_rows`). ``worker`` tags the producing worker
        (single-worker stores ignore it)."""

    @abc.abstractmethod
    def seal(self, size: int) -> None:
        """Superstep boundary: promote the staged blocks of ``size``-column
        rows to the current frontier, dropping the previous one."""

    # -- read side (the next superstep) -----------------------------------
    @property
    @abc.abstractmethod
    def n_rows(self) -> int:
        """Rows appended into the sealed frontier (the Fig. 9 baseline)."""

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Embedding size (columns) of the sealed frontier."""

    @property
    def raw_bytes(self) -> int:
        """What shipping the frontier as a dense embedding list costs."""
        return self.n_rows * self.size * 4

    @property
    @abc.abstractmethod
    def stored_bytes(self) -> int:
        """What the store actually holds between supersteps."""

    @property
    def exchange_bytes(self) -> int:
        """Bytes a worker ships per frontier exchange of the sealed
        frontier: the dense row block here; the ODAG for the ODAG store."""
        return self.raw_bytes

    @abc.abstractmethod
    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        """Yield the frontier re-materialised as int32 (b, size) waves of at
        most ``max_rows`` rows each (one wave when unbounded)."""

    def materialize(self) -> np.ndarray:
        """The whole frontier as one host array (convenience over chunks)."""
        waves = list(self.chunks())
        if not waves:
            return np.zeros((0, max(self.size, 1)), np.int32)
        return waves[0] if len(waves) == 1 else np.concatenate(waves, axis=0)

    def worker_parts(self, n_workers: int) -> List[np.ndarray]:
        """Re-materialise the frontier as one slice per worker (paper §5.3):
        an even block split here; the ODAG store balances by cost."""
        rows = self.materialize()
        b = len(rows)
        per = -(-b // n_workers) if b else 0
        return [rows[w * per: (w + 1) * per] for w in range(n_workers)]

    # -- the sealed frontier as a payload (DESIGN.md §9) -------------------
    @abc.abstractmethod
    def state_dict(self) -> dict:
        """The sealed frontier as ``{"kind": str, "meta": {json-able
        scalars}, "arrays": {name: ndarray}}``, the JAX package's format."""

    @abc.abstractmethod
    def from_state_dict(self, sd: dict) -> None:
        """Restore a sealed frontier from :meth:`state_dict` output onto a
        freshly constructed store. Raises ``ValueError`` on a payload of a
        different store kind."""

    def _check_kind(self, sd: dict) -> None:
        if sd.get("kind") != self.kind:
            raise ValueError(
                f"store payload is {sd.get('kind')!r}, this run is "
                f"configured for a {self.kind!r} store"
            )


class RawStore(FrontierStore):
    """Dense embedding-list store: the rows verbatim, ``stored_bytes ==
    raw_bytes``, ``chunks`` yields zero-copy views. The Fig. 9/10 baseline
    the ODAG store is measured against."""

    kind = "raw"

    def __init__(self) -> None:
        self._staged: List[tuple] = []        # (rows, count) — lazy blocks
        self._frontier = np.zeros((0, 1), np.int32)

    def append(self, rows, worker: int = 0, count=None) -> None:
        if len(rows) and (count is None or count):
            self._staged.append((rows, count))

    def seal(self, size: int) -> None:
        with obs.span("store.seal", kind="raw", size=size,
                      blocks=len(self._staged)):
            blocks = [resolve_rows(r, c) for r, c in self._staged]
            blocks = [b for b in blocks if len(b)]
            self._frontier = (
                np.concatenate(blocks, axis=0)
                if blocks
                else np.zeros((0, size), np.int32)
            )
            self._staged = []

    @property
    def n_rows(self) -> int:
        return len(self._frontier)

    @property
    def size(self) -> int:
        return self._frontier.shape[1]

    @property
    def stored_bytes(self) -> int:
        return self.raw_bytes

    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        if not len(self._frontier):
            return
        step = max_rows or len(self._frontier)
        for lo in range(0, len(self._frontier), step):
            yield self._frontier[lo: lo + step]

    def materialize(self) -> np.ndarray:
        return self._frontier

    def state_dict(self) -> dict:
        return {
            "kind": "raw",
            "meta": {"size": int(self.size)},
            "arrays": {"frontier": self._frontier},
        }

    def from_state_dict(self, sd: dict) -> None:
        self._check_kind(sd)
        rows = np.asarray(sd["arrays"]["frontier"], dtype=np.int32)
        self._frontier = rows.reshape(len(rows), int(sd["meta"]["size"]))
        self._staged = []


def make_store(
    kind: str,
    g=None,
    *,
    mode: str = "vertex",
    app_filter=None,
    use_pallas: bool = False,
    dense_exchange: bool = False,
    device_budget_bytes: Optional[int] = None,
) -> FrontierStore:
    """Build the store a run config asks for: ``kind`` "raw" or "odag" (the
    ODAG store needs the device graph ``g``). A ``device_budget_bytes``
    wraps the store in a :class:`SpillStore`, so re-materialisation happens
    in device-budget sized waves."""
    from repro_torch.core.store.odag_store import ODAGStore
    from repro_torch.core.store.spill import SpillStore

    if dense_exchange:
        raise NotImplementedError(
            "dense_exchange needs the distributed backend, not ported yet; "
            "see ROADMAP.md"
        )
    if kind == "raw":
        store: FrontierStore = RawStore()
    elif kind == "odag":
        if g is None:
            raise ValueError("store='odag' needs the device graph")
        store = ODAGStore(g, mode=mode, app_filter=app_filter,
                          use_pallas=use_pallas)
    else:
        raise ValueError(f"unknown frontier store kind: {kind!r}")
    if device_budget_bytes is not None:
        store = SpillStore(store, device_budget_bytes)
    return store


def store_from_numpy(state: dict) -> RawStore:
    """A sealed :class:`RawStore` restored from a ``state_dict`` payload of
    numpy arrays — the JAX package's ``RawStore.state_dict()`` is one — so
    both packages can start from one frontier."""
    store = RawStore()
    store.from_state_dict(state)
    return store
