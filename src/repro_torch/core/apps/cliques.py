"""Finding cliques (paper Fig. 4c), port of ``repro.core.apps.cliques``:
vertex-induced exploration where the filter keeps a candidate only if it is
connected to *all* current members — anti-monotonic local pruning.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import MiningApp
from repro_torch.core.bitset import popcount_u32
from repro_torch.core.graph import DeviceGraph


@dataclasses.dataclass
class CliquesApp(MiningApp):
    mode: str = "vertex"
    max_size: int = 4
    wants_patterns: bool = False     # paper §6.3: Cliques skips pattern agg
    collect_embeddings: bool = True

    def filter(self, g: DeviceGraph, members, n_valid, rows, cand):
        """isClique: the new vertex must neighbour every existing member."""
        k = members.shape[1]
        pos = torch.arange(k, device=members.device)[None, :]
        m = members[rows]                       # (Ncand, k)
        valid = pos < n_valid[rows][:, None]
        adj = g.is_edge(m, cand[:, None])       # (Ncand, k)
        return (adj | ~valid).all(dim=1)


def maximal_cliques(result, g: DeviceGraph):
    """Post-process a CliquesApp result into MAXIMAL cliques (the paper's
    §2 generalisation): a size-k clique is maximal iff no vertex is adjacent
    to all its members."""
    out = {}
    adj = g.adj_bits
    for size, emb in sorted(result.embeddings.items()):
        m = torch.as_tensor(np.asarray(emb), device=adj.device).long()
        # AND of the members' adjacency bitmaps = common-neighbour set
        rows = adj[m]                           # (B, size, W)
        common = rows[:, 0]
        for i in range(1, size):
            common = common & rows[:, i]
        n_common = popcount_u32(common).sum(dim=1)
        maximal = (n_common == 0).cpu().numpy()
        out[size] = np.asarray(emb)[maximal]
    return out
