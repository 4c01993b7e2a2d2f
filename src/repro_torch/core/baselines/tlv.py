"""Think-Like-a-Vertex baseline (paper §3.2, Fig. 7), port of
``repro.core.baselines.tlv``.

Faithful cost model of TLV embedding exploration on a Pregel-style system:
each vertex holds local embeddings; to expand, an embedding is *sent* to
every border vertex (a message per border vertex), which extends it with its
own neighbours. We reuse the same canonicality pruning as Arabesque (the
paper's TLV implementation did too), so the comparison isolates the
paradigm's communication/imbalance cost, not algorithmic differences.

This is a host simulation that reports the metrics Fig. 7 is about:
messages exchanged, per-vertex load imbalance, and the host's wall time.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class TLVReport:
    n_messages: int
    n_embeddings: int
    max_vertex_load: int
    mean_vertex_load: float
    wall_time: float        # host seconds of the simulation


def _canonical_extend_ok(adj, emb, v):
    """Alg. 2 on host (same pruning as the engine)."""
    if v in emb:
        return False
    if emb[0] > v:
        return False
    found = False
    for u in emb:
        if not found and v in adj[u]:
            found = True
        elif found and u > v:
            return False
    return found


def run_tlv(g: Graph, max_size: int) -> TLVReport:
    t0 = time.perf_counter()
    adj = [set() for _ in range(g.n)]
    for u, v in g.edges:
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))

    n_messages = 0
    n_embeddings = g.n
    load = np.zeros(g.n, dtype=np.int64)

    # inbox[v] = embeddings v must try to expand with its own neighbours
    inbox = defaultdict(list)
    for v in range(g.n):
        inbox[v].append((v,))
        load[v] += 1

    for _size in range(1, max_size):
        outbox = defaultdict(list)
        level = set()
        for v, embs in inbox.items():
            for emb in embs:
                # v extends emb with each of its neighbours
                for w in adj[v]:
                    if _canonical_extend_ok(adj, emb, w):
                        child = emb + (w,)
                        level.add(child)
                        # child must be sent to all its border vertices
                        for b in child:
                            outbox[b].append(child)
                            n_messages += 1
                            load[b] += 1
        n_embeddings += len(level)
        # dedup per vertex: the same child reaches a border vertex once per
        # producer; a real TLV system pays the messages, then dedups.
        inbox = {
            v: list({e: None for e in embs}.keys()) for v, embs in outbox.items()
        }

    return TLVReport(
        n_messages=n_messages,
        n_embeddings=n_embeddings,
        max_vertex_load=int(load.max()),
        mean_vertex_load=float(load.mean()),
        wall_time=time.perf_counter() - t0,
    )
