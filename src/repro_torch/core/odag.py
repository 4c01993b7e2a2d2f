"""ODAG — Overapproximating Directed Acyclic Graph (paper §5.2), port of
``repro.core.odag``.

An ODAG stores a set of same-size canonical embeddings as k per-position
domains plus connectivity bitmaps between consecutive positions: a prefix
tree with all equal-id nodes of a level collapsed. It encodes a *superset*
of the stored embeddings; extraction re-applies the same filters as
Algorithm 1 (validity + canonicality + app filter), which by completeness
removes exactly the spurious paths.

The ragged :class:`ODAG` stays numpy on the host, as in the reference: it is
the frontier store's between-step representation, so its byte accounting
(Fig. 9), its checkpoint payload and the §5.3 cost masks are the
reference's. :func:`extract` walks it on the graph's device. It enumerates
only the set bits of each level's connectivity (a CSR form, :func:`conn_csr`)
rather than the dense paths x domain block, in chunks of candidate pairs,
and keeps rows in the reference's order: paths in order, each path's
candidates in ascending domain order.

The fixed-shape dense form of the distributed exchange (``DenseODAG``,
``build_dense``, ``dense_to_ragged``) is not ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import canonical
from repro_torch.kernels.canonical_check import ops as cc_ops
from repro_torch.kernels.compact import stream_compact_cuda

#: candidate pairs (path, connected next-level element) filtered per chunk
#: of :func:`extract`; each chunk costs one host sync.
EXTRACT_PAIRS = 1 << 22

#: one level's connectivity as CSR: (indptr (D_i + 1,) int64, indices
#: (nnz,) int64 column ids into the next level's domain, ascending a row).
CSR = Tuple[np.ndarray, np.ndarray]


@dataclasses.dataclass
class ODAG:
    """Exact ragged ODAG for one pattern's embeddings of size k."""

    k: int
    domains: List[np.ndarray]        # level i: (Di,) int32 sorted unique ids
    conn: List[np.ndarray]           # level i: (Di, D_{i+1}) bool

    @property
    def n_bytes(self) -> int:
        b = sum(d.size * 4 for d in self.domains)
        b += sum((c.size + 7) // 8 for c in self.conn)
        return b

    def counts(self) -> List[int]:
        return [len(d) for d in self.domains]

    def path_upper_bound(self) -> int:
        """#paths encoded (incl. spurious): the §5.3 cost estimate."""
        if not self.domains:
            return 0
        return int(_path_costs(self).sum())


def _path_costs(odag: ODAG) -> np.ndarray:
    """Paths (spurious included) below each first-level element."""
    cost = np.ones(len(odag.domains[-1]), dtype=np.int64)
    for c in reversed(odag.conn):
        cost = c @ cost
    return cost


def build(members: np.ndarray, k: Optional[int] = None) -> ODAG:
    """Build the ODAG of a set of size-k embeddings (ids in visit order)."""
    members = np.asarray(members)
    k = k or members.shape[1]
    members = members[:, :k]
    domains = [np.unique(members[:, i]).astype(np.int32) for i in range(k)]
    conn = []
    for i in range(k - 1):
        c = np.zeros((len(domains[i]), len(domains[i + 1])), dtype=bool)
        a = np.searchsorted(domains[i], members[:, i])
        b = np.searchsorted(domains[i + 1], members[:, i + 1])
        c[a, b] = True
        conn.append(c)
    return ODAG(k=k, domains=domains, conn=conn)


def partition_by_cost(odag: ODAG, n_workers: int) -> List[np.ndarray]:
    """Paper §5.3: cost-annotated load balancing.

    Each first-level element is annotated with the number of (possibly
    spurious) paths below it; workers take contiguous runs of first-level
    elements with approximately equal total cost. Returns per-worker boolean
    masks over the first-level domain. An element whose cost exceeds the
    target goes to one worker and the remainder is rebalanced (bounded
    imbalance, no recursion), as in the reference."""
    if not odag.domains:
        return [np.zeros(0, dtype=bool) for _ in range(n_workers)]
    cost = _path_costs(odag)
    total = int(cost.sum())
    target = max(total / max(n_workers, 1), 1.0)
    masks = [np.zeros(len(cost), dtype=bool) for _ in range(n_workers)]
    w, acc = 0, 0.0
    for i, ci in enumerate(np.asarray(cost)):
        if acc >= target and w < n_workers - 1:
            w += 1
            acc = 0.0
        masks[w][i] = True
        acc += float(ci)
    return masks


def conn_csr(odag: ODAG) -> List[CSR]:
    """Each level's connectivity bitmap as CSR, in row-major order (the
    order of ``np.nonzero`` over the bitmap)."""
    out = []
    for c in odag.conn:
        rows, cols = np.nonzero(c)
        indptr = np.zeros(c.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=c.shape[0]), out=indptr[1:])
        out.append((indptr, cols.astype(np.int64)))
    return out


def csr_rows(csr: CSR, rows: np.ndarray) -> CSR:
    """The CSR of the selected ``rows`` (ascending), in their order."""
    indptr, indices = csr
    lens = indptr[rows + 1] - indptr[rows]
    sub = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=sub[1:])
    start = np.repeat(indptr[rows] - sub[:-1], lens)
    return sub, indices[start + np.arange(int(sub[-1]), dtype=np.int64)]


def extract_partition(g, odag: ODAG, mask: np.ndarray, *,
                      csr: Optional[List[CSR]] = None, **kw) -> np.ndarray:
    """Extract only the paths rooted at the masked first-level elements.
    ``csr`` is :func:`conn_csr` of ``odag`` where the caller holds it."""
    sub = ODAG(
        k=odag.k,
        domains=[odag.domains[0][mask]] + odag.domains[1:],
        conn=([odag.conn[0][mask]] + odag.conn[1:]) if odag.conn else [],
    )
    if csr is not None and csr:
        csr = [csr_rows(csr[0], np.flatnonzero(mask))] + csr[1:]
    return extract(g, sub, csr=csr, **kw)


def merge(odags: List[ODAG]) -> ODAG:
    """Merge worker-local ODAGs of the same pattern (the paper's map-reduce
    edge merging, done as set union + bitmap OR)."""
    k = odags[0].k
    domains = [
        np.unique(np.concatenate([o.domains[i] for o in odags])).astype(np.int32)
        for i in range(k)
    ]
    conn = []
    for i in range(k - 1):
        c = np.zeros((len(domains[i]), len(domains[i + 1])), dtype=bool)
        for o in odags:
            a = np.searchsorted(domains[i], o.domains[i])
            b = np.searchsorted(domains[i + 1], o.domains[i + 1])
            rows, cols = np.nonzero(o.conn[i])
            c[a[rows], b[cols]] = True
        conn.append(c)
    return ODAG(k=k, domains=domains, conn=conn)


def _keep(g, mem, cnd, nv, mode: str, use_pallas: bool,
          app_filter: Optional[Callable]):
    """The Algorithm-1 filters of one candidate-pair chunk: distinctness,
    attachment, the Algorithm-2 check and the app's filter."""
    distinct = ~(mem == cnd[:, None]).any(dim=1)
    if mode == "vertex":
        attach = g.is_edge(mem, cnd[:, None]).any(dim=1)
        if use_pallas:
            canon = cc_ops.canonical_check(g, mem, nv, cnd, mode="vertex")
        else:
            canon = canonical.vertex_check(g, mem, nv, cnd)
    else:
        mu = g.edge_uv[mem.clamp(min=0)]                    # (B, k, 2)
        cu = g.edge_uv[cnd.clamp(min=0)]                    # (B, 2)
        attach = (
            (mu[..., 0] == cu[:, None, 0])
            | (mu[..., 0] == cu[:, None, 1])
            | (mu[..., 1] == cu[:, None, 0])
            | (mu[..., 1] == cu[:, None, 1])
        ).any(dim=1)
        if use_pallas:
            canon = cc_ops.canonical_check(g, mem, nv, cnd, mode="edge")
        else:
            canon = canonical.edge_check(g, mem, nv, cnd)
    keep = attach & distinct & canon
    if app_filter is not None:
        keep = keep & app_filter(mem, nv, cnd)
    return keep


def extract(
    g,
    odag: ODAG,
    app_filter: Optional[Callable] = None,
    chunk: int = EXTRACT_PAIRS,
    mode: str = "vertex",
    use_pallas: bool = False,
    csr: Optional[List[CSR]] = None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Enumerate the stored embeddings: follow connectivity edges, dropping
    spurious paths with exactly the Algorithm-1 filters (validity +
    incremental canonicality + app filter).

    Returns (B, k) int32 host rows, in the reference's order. The paths
    live on ``g``'s device. Each level enumerates the (path, connected
    element) pairs of its CSR (``csr``, :func:`conn_csr` of ``odag`` where
    the caller holds it), ``chunk`` pairs at a time, filters them there and
    compacts the kept ones with the ``stream_compact`` wrapper. A chunk
    costs one host sync, which reads its kept count and the next level's
    pairs below the kept rows. ``use_pallas`` routes the vertex-mode
    Algorithm-2 check through the ``canonical_check`` kernel.

    ``stats``, where given, accumulates ``levels``, ``chunks``, ``pairs``
    (candidate pairs filtered), ``kept`` and ``host_syncs`` (the chunks'
    syncs plus the final copy to the host)."""
    k = odag.k
    dev = g.device
    if csr is None:
        csr = conn_csr(odag)
    acc = {"levels": 0, "chunks": 0, "pairs": 0, "kept": 0, "host_syncs": 0}
    paths = torch.from_numpy(
        np.ascontiguousarray(odag.domains[0], dtype=np.int32)
    ).to(dev)[:, None]                                          # (P, 1)
    # each path's row in its last level's domain
    row = torch.arange(paths.shape[0], dtype=torch.int64, device=dev)
    total = int(csr[0][0][-1]) if k > 1 else 0
    for lvl in range(k - 1):
        acc["levels"] += 1
        indptr = torch.from_numpy(csr[lvl][0]).to(dev)
        indices = torch.from_numpy(csr[lvl][1]).to(dev)
        nxt_dom = torch.from_numpy(
            np.ascontiguousarray(odag.domains[lvl + 1], dtype=np.int32)
        ).to(dev)
        nxt_len = (
            torch.from_numpy(np.diff(csr[lvl + 1][0])).to(dev)
            if lvl + 2 < k else None
        )
        lens = indptr[row + 1] - indptr[row]                    # (P,)
        ends = torch.cumsum(lens, 0)
        starts = indptr[row] - (ends - lens)
        out_paths, out_rows, nxt_total = [], [], 0
        for lo in range(0, total, chunk):
            n = min(chunk, total - lo)
            pid = torch.arange(lo, lo + n, dtype=torch.int64, device=dev)
            path = torch.searchsorted(ends, pid, right=True)
            col = indices[starts[path] + pid]
            mem = paths[path]                                   # (n, lvl+1)
            cnd = nxt_dom[col]                                  # (n,)
            nv = torch.full((n,), lvl + 1, dtype=torch.int32, device=dev)
            keep = _keep(g, mem, cnd, nv, mode, use_pallas, app_filter)
            idx, count = stream_compact_cuda(keep, n)
            meta = [count.to(torch.int64)]
            if nxt_len is not None:
                meta.append((nxt_len[col] * keep).sum())
            meta = torch.stack(meta).cpu().tolist()             # the sync
            acc["chunks"] += 1
            acc["host_syncs"] += 1
            acc["pairs"] += n
            c = int(meta[0])
            acc["kept"] += c
            if nxt_len is not None:
                nxt_total += int(meta[1])
            if c:
                sel = idx[:c].to(torch.int64)
                out_paths.append(torch.cat([mem[sel], cnd[sel, None]], 1))
                out_rows.append(col[sel])
        if out_paths:
            paths = out_paths[0] if len(out_paths) == 1 else torch.cat(out_paths)
            row = out_rows[0] if len(out_rows) == 1 else torch.cat(out_rows)
        else:
            paths = torch.zeros((0, lvl + 2), dtype=torch.int32, device=dev)
            row = torch.zeros((0,), dtype=torch.int64, device=dev)
        total = nxt_total
    out = paths.cpu().numpy().astype(np.int32, copy=False)
    acc["host_syncs"] += 1
    if stats is not None:
        for key, v in acc.items():
            stats[key] = stats.get(key, 0) + v
    return out
