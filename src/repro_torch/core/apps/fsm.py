"""Frequent subgraph mining (paper Fig. 4a), port of
``repro.core.apps.fsm``: edge-induced exploration with min-image support
[Bringmann & Nijssen] computed via domain aggregation.

phi: size bound (anti-monotonic). map/reduce: domains merged per pattern —
in this engine the (Pc, 8, N) domain bitmap scatter. alpha: prune
embeddings whose pattern's support < theta. beta: output the frequent
patterns with their supports.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import MiningApp
from repro_torch.core.graph import DeviceGraph


@dataclasses.dataclass
class FSMApp(MiningApp):
    mode: str = "edge"
    support: int = 2                 # theta
    max_size: int = 4                # max edges (None = unbounded, paper default)
    wants_patterns: bool = True
    wants_domains: bool = True
    max_vertices: int | None = None  # optional numVertices(e) <= MAX filter

    def filter(self, g: DeviceGraph, members, n_valid, rows, cand):
        if self.max_vertices is None:
            return torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
        # numVertices(e + cand) <= max_vertices, by the cheap anti-monotonic
        # bound: a new edge adds at most one vertex to a connected subgraph,
        # so #vertices <= #edges + 1
        n_edges = n_valid[rows] + 1
        return n_edges + 1 <= self.max_vertices + 1

    def pattern_filter(self, agg) -> np.ndarray:
        """alpha at pattern granularity: a pattern survives iff its
        min-image support reaches theta (the per-row mask is derived by the
        engine, on the device under ``device_aggregate``)."""
        return np.asarray(agg.supports) >= self.support
