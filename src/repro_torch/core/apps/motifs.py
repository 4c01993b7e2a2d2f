"""Counting motifs (paper Fig. 4b), port of ``repro.core.apps.motifs``:
exhaustive vertex-induced exploration up to ``max_size``, counting
embeddings per pattern. ``filter`` is the default accept-all (the size
bound is the termination filter); ``process`` is the engine's pattern
aggregation with counts.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.api import MiningApp


@dataclasses.dataclass
class MotifsApp(MiningApp):
    mode: str = "vertex"
    max_size: int = 3
    wants_patterns: bool = True
    wants_domains: bool = False
