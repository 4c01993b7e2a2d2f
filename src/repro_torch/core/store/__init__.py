"""Pluggable frontier stores: how embeddings live between BSP supersteps
(DESIGN.md §7). Only the dense ``RawStore`` is ported so far."""
from repro_torch.core.store.base import (
    FrontierStore,
    RawStore,
    make_store,
    store_from_numpy,
)

__all__ = ["FrontierStore", "RawStore", "make_store", "store_from_numpy"]
