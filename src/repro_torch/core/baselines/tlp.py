"""Think-Like-a-Pattern baseline (paper §3.2, Fig. 7; GRAMI-style), port of
``repro.core.baselines.tlp``.

Pattern-centric FSM: state is kept per *pattern*; embeddings are re-computed
on the fly by subgraph-isomorphism search instead of being materialised.
Parallelism = partitioning patterns over workers, which is exactly what the
paper shows cannot scale: there are few frequent patterns and their
embedding counts are highly skewed. We report the per-worker load imbalance
that caps TLP speedup, plus the host's wall time.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.baselines import bruteforce as bf
from repro_torch.core.graph import Graph


@dataclasses.dataclass
class TLPReport:
    n_patterns: int
    pattern_work: dict          # canonical code -> #embeddings visited
    wall_time: float            # host seconds

    def speedup_bound(self, n_workers: int) -> float:
        """Best-case speedup with patterns partitioned over workers (LPT
        bound): total work / max worker work."""
        works = sorted(self.pattern_work.values(), reverse=True)
        if not works:
            return 1.0
        workers = [0] * n_workers
        for w in works:
            workers[int(np.argmin(workers))] += w
        total = sum(works)
        return total / max(max(workers), 1)


def run_tlp_fsm(g: Graph, support: int, max_size: int) -> TLPReport:
    """Level-wise pattern-centric FSM: per pattern, embeddings are recomputed
    (we reuse the oracle enumerator as the isomorphism search) and work is
    attributed to the pattern's worker."""
    t0 = time.perf_counter()
    levels = bf.enumerate_edge_embeddings(g, max_size)
    memo: dict = {}
    work: dict[tuple, int] = {}
    for k in range(1, max_size + 1):
        for emb in levels[k]:
            code = bf._canonical(memo, bf._edge_embedding_local(g, emb)[0])
            work[code] = work.get(code, 0) + 1
    # keep only frequent ones at each level (the others are pruned, but TLP
    # still *visited* their embeddings to count them — work stays attributed)
    freq = bf.fsm_supports(g, max_size, support)
    return TLPReport(
        n_patterns=len(freq),
        pattern_work=work,
        wall_time=time.perf_counter() - t0,
    )
