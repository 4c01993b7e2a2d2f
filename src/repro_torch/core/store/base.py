"""Frontier-store interface + the dense-array store (DESIGN.md §7), port
of ``repro.core.store.base``.

A :class:`FrontierStore` owns how the embeddings of one BSP superstep live
*between* supersteps: ``append`` child blocks while expanding, ``seal`` at
the superstep boundary, iterate ``chunks`` of re-materialised rows at the
next superstep, and read byte stats for the Fig. 9/10 accounting. Only
:class:`RawStore` is ported; the ODAG and spill stores wait (ROADMAP.md).
"""
from __future__ import annotations

import abc
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core import obs


class FrontierStore(abc.ABC):
    """Owns one frontier (all embeddings of the current size) between steps."""

    #: "raw" or "odag" — engines use this for the Fig. 9 byte accounting.
    kind: str = "raw"

    @abc.abstractmethod
    def append(self, rows: np.ndarray) -> None:
        """Stage a block of same-size child embeddings (host int32 (B, k))."""

    @abc.abstractmethod
    def seal(self, size: int) -> None:
        """Superstep boundary: promote the staged blocks of ``size``-column
        rows to the current frontier, dropping the previous one."""

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

    @abc.abstractmethod
    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        """Yield the frontier re-materialised as int32 (b, size) waves of at
        most ``max_rows`` rows each (one wave when unbounded)."""

    @abc.abstractmethod
    def materialize(self) -> np.ndarray:
        """The whole frontier as one host array."""

    @abc.abstractmethod
    def from_state_dict(self, sd: dict) -> None:
        """Restore a sealed frontier from a ``state_dict`` payload
        ``{"kind", "meta", "arrays"}`` (the JAX package's format). Raises
        ``ValueError`` on a payload of a different store kind."""


class RawStore(FrontierStore):
    """Dense embedding-list store: the rows verbatim, ``chunks`` yields
    zero-copy views."""

    kind = "raw"

    def __init__(self) -> None:
        self._staged: List[np.ndarray] = []
        self._frontier = np.zeros((0, 1), np.int32)

    def append(self, rows: np.ndarray) -> None:
        if len(rows):
            self._staged.append(np.asarray(rows, dtype=np.int32))

    def seal(self, size: int) -> None:
        with obs.span("store.seal", kind="raw", size=size,
                      blocks=len(self._staged)):
            self._frontier = (
                np.concatenate(self._staged, axis=0)
                if self._staged
                else np.zeros((0, size), np.int32)
            )
            self._staged = []

    @property
    def n_rows(self) -> int:
        return len(self._frontier)

    @property
    def size(self) -> int:
        return self._frontier.shape[1]

    def chunks(self, max_rows: Optional[int] = None) -> Iterator[np.ndarray]:
        if not len(self._frontier):
            return
        step = max_rows or len(self._frontier)
        for lo in range(0, len(self._frontier), step):
            yield self._frontier[lo: lo + step]

    def materialize(self) -> np.ndarray:
        return self._frontier

    def from_state_dict(self, sd: dict) -> None:
        if sd.get("kind") != self.kind:
            raise ValueError(
                f"store payload is {sd.get('kind')!r}, expected {self.kind!r}"
            )
        rows = np.asarray(sd["arrays"]["frontier"], dtype=np.int32)
        self._frontier = rows.reshape(len(rows), int(sd["meta"]["size"]))
        self._staged = []


def make_store(kind: str, *,
               device_budget_bytes: Optional[int] = None) -> FrontierStore:
    """Build the store a run config asks for. Only ``"raw"`` without a
    device budget is ported; the rest raises (ROADMAP.md)."""
    if device_budget_bytes is not None:
        raise NotImplementedError(
            "device_budget_bytes needs the spill store; see ROADMAP.md"
        )
    if kind == "raw":
        return RawStore()
    if kind == "odag":
        raise NotImplementedError("the ODAG store is not ported yet; see "
                                  "ROADMAP.md")
    raise ValueError(f"unknown frontier store kind: {kind!r}")


def store_from_numpy(state: dict) -> RawStore:
    """A sealed :class:`RawStore` restored from a ``state_dict`` payload of
    numpy arrays — the JAX package's ``RawStore.state_dict()`` is one — so
    both packages can start from one frontier."""
    store = RawStore()
    store.from_state_dict(state)
    return store
