"""Pluggable frontier stores: how embeddings live between BSP supersteps
(DESIGN.md §7), port of ``repro.core.store``.

``RawStore`` keeps the dense embedding list (baseline), ``ODAGStore`` keeps
per-size ODAGs with cost-balanced extraction (§5.2/§5.3), ``SpillStore``
bounds per-wave materialisation to a device byte budget.
"""
from repro_torch.core.store.base import (
    FrontierStore,
    RawStore,
    make_store,
    resolve_rows,
    store_from_numpy,
)
from repro_torch.core.store.odag_store import ODAGStore
from repro_torch.core.store.spill import SpillStore

__all__ = [
    "FrontierStore",
    "RawStore",
    "ODAGStore",
    "SpillStore",
    "make_store",
    "resolve_rows",
    "store_from_numpy",
]
