"""Labeled immutable input graphs for mining (port of ``repro.core.graph``).

Two views:
  * :class:`Graph` — host-side (numpy) construction / generators, the same
    code as the JAX package's, so one seed gives one graph in both.
  * :class:`DeviceGraph` — the tensors the exploration kernels read:
    padded neighbour table, packed adjacency bitset (int32 words with the
    uint32 bits of the host table), edge endpoint table, per-vertex
    incident-edge table. :func:`to_device` puts them on the card unless the
    caller asks for the CPU.
  * :class:`PartitionedGraph` — the partitioned layout (DESIGN.md §11):
    contiguous vertex ranges, one CSR shard and packed adjacency tile per
    part, stacked on a leading shard axis (:func:`to_partitioned`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected labeled graph (host side).

    Attributes:
      n: number of vertices (ids ``0..n-1``).
      labels: ``(n,)`` int32 vertex labels (``0`` allowed; arbitrary ints).
      edges: ``(m, 2)`` int32, each row ``(u, v)`` with ``u < v``, unique,
        no self loops. Edge ids are row indices.
      edge_labels: optional ``(m,)`` int32.
    """

    n: int
    labels: np.ndarray
    edges: np.ndarray
    edge_labels: Optional[np.ndarray] = None

    def __post_init__(self):
        edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)
        edges = np.sort(edges, axis=1)
        if len(edges):
            if (edges[:, 0] == edges[:, 1]).any():
                raise ValueError("self loops are not supported")
            edges = np.unique(edges, axis=0)
        object.__setattr__(self, "edges", edges)
        object.__setattr__(
            self, "labels", np.asarray(self.labels, dtype=np.int32).reshape(self.n)
        )
        if self.edge_labels is not None:
            object.__setattr__(
                self,
                "edge_labels",
                np.asarray(self.edge_labels, dtype=np.int32).reshape(len(edges)),
            )

    # -- derived host-side structures ------------------------------------
    @property
    def m(self) -> int:
        return len(self.edges)

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n, dtype=np.int32)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def csr(self):
        """Sorted CSR adjacency: (indptr (n+1,), indices (2m,), eids (2m,))."""
        u = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
        v = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
        e = np.concatenate([np.arange(self.m), np.arange(self.m)]).astype(np.int32)
        order = np.lexsort((v, u))
        u, v, e = u[order], v[order], e[order]
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(indptr, u + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, v.astype(np.int32), e

    def neighbor_table(self):
        """Padded (n, D) neighbour table + matching edge-id table, pad = -1.

        Vectorised scatter: CSR entry j of vertex v lands at column
        ``j - indptr[v]`` — no per-vertex Python loop, which dominated
        device-graph build time at mico/patents scales."""
        indptr, indices, eids = self.csr()
        deg = (indptr[1:] - indptr[:-1]).astype(np.int32)
        d = max(1, int(deg.max()) if self.n else 1)
        nbr = np.full((self.n, d), -1, dtype=np.int32)
        ned = np.full((self.n, d), -1, dtype=np.int32)
        if len(indices):
            rows = np.repeat(np.arange(self.n), deg)
            cols = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
            nbr[rows, cols] = indices
            ned[rows, cols] = eids
        return nbr, ned, deg

    def adjacency_tile(self, lo: int, hi: int) -> np.ndarray:
        """Packed adjacency rows for the vertex range ``[lo, hi)``:
        ``(hi - lo, ceil(n/32))`` uint32, built by an O(m) bit scatter —
        never the dense ``(n, n)`` bool intermediate. This is the unit the
        partitioned layout (:func:`to_partitioned`) stacks per shard."""
        lo, hi = int(lo), int(hi)
        w = bitset.n_words(self.n)
        words = np.zeros((max(hi - lo, 0), w), dtype=np.uint32)
        if self.m and hi > lo:
            u = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
            v = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
            sel = (u >= lo) & (u < hi)
            u, v = u[sel] - lo, v[sel]
            np.bitwise_or.at(
                words,
                (u, v // bitset.WORD_BITS),
                np.uint32(1) << (v % bitset.WORD_BITS).astype(np.uint32),
            )
        return words

    def adjacency_bits(self) -> np.ndarray:
        """Whole packed adjacency bitmap — one full-range tile. O(m) bit
        scatter (the old implementation materialised a dense O(n^2) bool
        matrix eagerly, capping host-side setup long before device memory
        did)."""
        return self.adjacency_tile(0, self.n)


class DeviceGraph(NamedTuple):
    """Device-side graph used by the exploration kernels."""

    labels: torch.Tensor       # (n,) int32
    nbr: torch.Tensor          # (n, D) int32 neighbour ids, pad -1
    nbr_eid: torch.Tensor      # (n, D) int32 incident edge ids, pad -1
    deg: torch.Tensor          # (n,) int32
    adj_bits: torch.Tensor     # (n, W) int32 packed adjacency (uint32 bits)
    edge_uv: torch.Tensor      # (m, 2) int32 endpoints, u < v
    edge_labels: torch.Tensor  # (m,) int32 (zeros when unlabeled)

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    @property
    def m(self) -> int:
        return self.edge_uv.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def is_edge(self, u, v):
        """Vectorised O(1) edge query; False for negative ids."""
        return bitset.test_bit(self.adj_bits, u, v)


#: the fields of a DeviceGraph, in order (also the JAX package's order).
FIELDS = DeviceGraph._fields


def device_graph_from_numpy(arrays, device=None) -> DeviceGraph:
    """Build a :class:`DeviceGraph` from numpy arrays of its fields — a
    mapping, or any object with an ``_asdict`` (the JAX package's
    ``DeviceGraph`` after ``np.asarray`` of each field). ``adj_bits`` may
    arrive as uint32; it is stored as int32 with the same bits."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    device = resolve_device(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return DeviceGraph(**out)


def to_device(g: Graph, device=None) -> DeviceGraph:
    """Upload ``g``'s tables; ``device=None`` means the current CUDA device
    (raising when there is none), ``device="cpu"`` the CPU."""
    nbr, ned, deg = g.neighbor_table()
    edge_labels = (
        g.edge_labels
        if g.edge_labels is not None
        else np.zeros(g.m, dtype=np.int32)
    )
    return device_graph_from_numpy(
        {
            "labels": g.labels,
            "nbr": nbr,
            "nbr_eid": ned,
            "deg": deg,
            "adj_bits": g.adjacency_bits(),
            "edge_uv": g.edges.astype(np.int32),
            "edge_labels": edge_labels,
        },
        device,
    )


# ---------------------------------------------------------------------------
# Partitioned layout: per-shard CSR tables + packed adjacency tiles
# ---------------------------------------------------------------------------

def partition_bounds(g: Graph, n_parts: int, balance: str = "degree") -> np.ndarray:
    """Contiguous vertex-range partition boundaries: ``(n_parts + 1,)`` int32
    offsets with ``offsets[0] == 0`` and ``offsets[-1] == n``.

    ``balance="vertex"`` splits the id space evenly; ``balance="degree"``
    places the boundaries so each shard owns ~1/W of the total adjacency
    *payload* (degree + 1 per vertex, the +1 keeping empty-degree runs from
    collapsing a shard to zero rows on skewed graphs)."""
    n_parts = int(n_parts)
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    if balance == "vertex":
        bounds = np.linspace(0, g.n, n_parts + 1)
    elif balance == "degree":
        load = np.cumsum(g.degrees().astype(np.int64) + 1)
        total = load[-1] if g.n else 0
        targets = total * np.arange(1, n_parts) / n_parts
        inner = np.searchsorted(load, targets, side="left") + 1
        bounds = np.concatenate([[0], inner, [g.n]])
    else:
        raise ValueError(f"unknown partition balance {balance!r}")
    bounds = np.rint(bounds).astype(np.int64)
    # monotone repair: a degenerate split (tiny n) may duplicate boundaries
    bounds = np.maximum.accumulate(np.clip(bounds, 0, g.n))
    return bounds.astype(np.int32)


class PartitionedGraph(NamedTuple):
    """The partitioned layout (DESIGN.md §11): contiguous vertex ranges, one
    CSR shard + packed-bitmap adjacency tile per part, padded to a common
    row count so the shards stack into single tensors whose leading axis is
    the shard axis; ``labels`` / ``edge_uv`` / ``edge_labels`` stay whole.

    On one process the stacked tables double as a *total* graph view:
    :meth:`is_edge` translates global vertex ids through ``part_offsets``,
    so every layer that only asks id/adjacency questions (quick patterns,
    app filters) runs unchanged on either layout. The exploration hot path
    reaches the tables through gathered halo tiles
    (``explore.build_tile_view`` / ``kernels/gather.py``)."""

    part_offsets: torch.Tensor  # (W + 1,) int32 vertex-range boundaries
    labels: torch.Tensor        # (n,) int32
    edge_uv: torch.Tensor       # (m, 2) int32
    edge_labels: torch.Tensor   # (m,) int32
    nbr_sh: torch.Tensor        # (W, P, D) int32 neighbour shards, pad -1
    nbr_eid_sh: torch.Tensor    # (W, P, D) int32 incident-edge shards, pad -1
    deg_sh: torch.Tensor        # (W, P) int32 degrees, pad 0
    adj_sh: torch.Tensor        # (W, P, Wd) int32 packed adjacency (uint32 bits)

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    @property
    def m(self) -> int:
        return self.edge_uv.shape[0]

    @property
    def n_parts(self) -> int:
        return self.nbr_sh.shape[0]

    @property
    def tile_rows(self) -> int:
        """Padded rows per shard (P): the common slot count of the stacks."""
        return self.nbr_sh.shape[1]

    @property
    def max_degree(self) -> int:
        return self.nbr_sh.shape[2]

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def owner(self, v):
        """Shard owning each (clipped-safe) global vertex id."""
        safe = v.clamp(0, self.n - 1).to(self.part_offsets.dtype)
        own = torch.searchsorted(self.part_offsets, safe, right=True) - 1
        return own.clamp(0, self.n_parts - 1).to(torch.int32)

    def flat_index(self, v):
        """(flat row into the shard-stacked tables, in-range mask) for
        global vertex ids ``v`` — rows of pad slots are never produced."""
        own = self.owner(v)
        loc = v.clamp(0, self.n - 1) - self.part_offsets[own]
        ok = (v >= 0) & (v < self.n)
        return (own * self.tile_rows + loc).to(torch.int32), ok

    def nbr_rows(self, v):
        """Gathered neighbour rows ``(..., D)`` for global ids (pad -1)."""
        fi, ok = self.flat_index(v)
        rows = self.nbr_sh.reshape(-1, self.max_degree)[fi]
        return rows.masked_fill(~ok[..., None], -1)

    def is_edge(self, u, v):
        """Total O(1) edge query across the shard stack (False for
        out-of-range ids) — the contract of ``DeviceGraph.is_edge``."""
        fi, ok = self.flat_index(u)
        adj_flat = self.adj_sh.reshape(-1, self.adj_sh.shape[2])
        return bitset.test_bit(adj_flat, torch.where(ok, fi, -1), v)

    @property
    def per_device_adjacency_bytes(self) -> int:
        """Adjacency payload ONE device holds: its CSR shard (neighbour +
        incident-edge + degree rows) plus its packed adjacency tile."""
        w = self.n_parts
        return (
            self.nbr_sh.numel() + self.nbr_eid_sh.numel()
            + self.deg_sh.numel()
        ) * 4 // w + self.adj_sh.numel() * 4 // w

    @property
    def replicated_bytes(self) -> int:
        """Payload every device still replicates (labels + edge table)."""
        return (self.labels.numel() + self.edge_uv.numel()
                + self.edge_labels.numel()) * 4


def replicated_adjacency_bytes(g: DeviceGraph) -> int:
    """Adjacency payload of the replicated layout (every device holds all
    of it)."""
    return (g.nbr.numel() + g.nbr_eid.numel() + g.deg.numel()
            + g.adj_bits.numel()) * 4


#: the fields of a PartitionedGraph, in order (the JAX package's order).
PARTITIONED_FIELDS = PartitionedGraph._fields


def partitioned_graph_from_numpy(arrays, device=None) -> PartitionedGraph:
    """Build a :class:`PartitionedGraph` from numpy arrays of its fields — a
    mapping, or any object with an ``_asdict`` (the JAX package's
    ``PartitionedGraph`` after ``np.asarray`` of each field). ``adj_sh``
    may arrive as uint32; it is stored as int32 with the same bits."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    device = resolve_device(device)
    out = {}
    for name in PARTITIONED_FIELDS:
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        # a read-only array (a JAX array's view) is copied once
        out[name] = torch.from_numpy(
            np.require(a, np.int32, ["C", "W"])
        ).to(device)
    return PartitionedGraph(**out)


def to_partitioned(g, n_parts: int, balance: str = "degree",
                   device=None) -> PartitionedGraph:
    """Build the partitioned layout from a host graph: vertex-range CSR
    shards (optionally degree-balanced boundaries) + per-range packed
    adjacency tiles, padded to a common row count and stacked on a leading
    shard axis. Adjacency tiles are built range-wise (O(m) per shard).

    A ``DeviceGraph`` is accepted too: its content round-trips through the
    host ``Graph`` unchanged, and the tables land where its tensors are
    unless ``device`` says otherwise. For a host ``Graph``, ``device=None``
    means the current CUDA device (raising when there is none)."""
    if isinstance(g, DeviceGraph):
        if device is None:
            device = g.device
        g = Graph(
            n=g.n,
            labels=g.labels.cpu().numpy(),
            edges=g.edge_uv.cpu().numpy(),
            edge_labels=g.edge_labels.cpu().numpy(),
        )
    bounds = partition_bounds(g, n_parts, balance)
    nbr, ned, deg = g.neighbor_table()
    d = nbr.shape[1]
    w = bitset.n_words(g.n)
    rows = max(int((bounds[1:] - bounds[:-1]).max()), 1)
    nbr_sh = np.full((n_parts, rows, d), -1, dtype=np.int32)
    ned_sh = np.full((n_parts, rows, d), -1, dtype=np.int32)
    deg_sh = np.zeros((n_parts, rows), dtype=np.int32)
    adj_sh = np.zeros((n_parts, rows, w), dtype=np.uint32)
    for s in range(n_parts):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        nbr_sh[s, : hi - lo] = nbr[lo:hi]
        ned_sh[s, : hi - lo] = ned[lo:hi]
        deg_sh[s, : hi - lo] = deg[lo:hi]
        adj_sh[s, : hi - lo] = g.adjacency_tile(lo, hi)
    edge_labels = (
        g.edge_labels
        if g.edge_labels is not None
        else np.zeros(g.m, dtype=np.int32)
    )
    return partitioned_graph_from_numpy(
        {
            "part_offsets": bounds,
            "labels": g.labels,
            "edge_uv": g.edges.astype(np.int32),
            "edge_labels": edge_labels,
            "nbr_sh": nbr_sh,
            "nbr_eid_sh": ned_sh,
            "deg_sh": deg_sh,
            "adj_sh": adj_sh,
        },
        device,
    )


# ---------------------------------------------------------------------------
# Generators (synthetic stand-ins for the paper's datasets)
# ---------------------------------------------------------------------------

def random_labeled(
    n: int,
    m: int,
    n_labels: int,
    seed: int = 0,
    power_law: bool = True,
) -> Graph:
    """Random labeled graph with roughly scale-free degrees (paper's graphs
    are scale-free social/citation networks)."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / np.arange(1, n + 1) ** 0.75
        w /= w.sum()
    else:
        w = np.full(n, 1.0 / n)
    us = rng.choice(n, size=int(m * 1.6), p=w)
    vs = rng.choice(n, size=int(m * 1.6), p=w)
    keep = us != vs
    e = np.stack([us[keep], vs[keep]], axis=1)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    if len(e) > m:
        idx = rng.choice(len(e), size=m, replace=False)
        e = e[np.sort(idx)]
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    return Graph(n=n, labels=labels, edges=e.astype(np.int32))


def citeseer_like(scale: float = 1.0, seed: int = 7) -> Graph:
    """CiteSeer-shaped: 3,312 vertices / 4,732 edges / 6 labels (Table 1)."""
    n = max(8, int(3312 * scale))
    m = max(8, int(4732 * scale))
    return random_labeled(n, m, n_labels=6, seed=seed)


def mico_like(scale: float = 0.02, seed: int = 11) -> Graph:
    """MiCo-shaped: 100k vertices / 1.08M edges / 29 labels (Table 1),
    scaled down by default for the container."""
    n = max(16, int(100_000 * scale))
    m = max(16, int(1_080_298 * scale))
    return random_labeled(n, m, n_labels=29, seed=seed)


def patents_like(scale: float = 0.001, seed: int = 13) -> Graph:
    """Patents-shaped: 2.74M vertices / 13.97M edges / 37 labels (Table 1)."""
    n = max(16, int(2_745_761 * scale))
    m = max(16, int(13_965_409 * scale))
    return random_labeled(n, m, n_labels=37, seed=seed)


def unlabeled_sn_like(scale: float = 0.0005, seed: int = 17) -> Graph:
    """SN-shaped: dense unlabeled social graph (avg degree 79, Table 1)."""
    n = max(16, int(5_022_893 * scale))
    m = max(32, int(n * 39.5))
    g = random_labeled(n, m, n_labels=1, seed=seed, power_law=True)
    return Graph(n=g.n, labels=np.zeros(g.n, dtype=np.int32), edges=g.edges)


# -- tiny deterministic graphs used throughout the tests --------------------

def paper_figure2() -> Graph:
    """The 4-vertex graph of Figure 2: labels blue/yellow alternating on a
    path 1-2-3-4 (we use ids 0..3; blue=0, yellow=1)."""
    return Graph(
        n=4,
        labels=np.array([0, 1, 0, 1], dtype=np.int32),
        edges=np.array([[0, 1], [1, 2], [2, 3]], dtype=np.int32),
    )


def triangle_plus_tail() -> Graph:
    """Triangle 0-1-2 plus tail 2-3 (Figure 5's example shape)."""
    return Graph(
        n=5,
        labels=np.zeros(5, dtype=np.int32),
        edges=np.array([[0, 1], [0, 2], [1, 2], [2, 3], [3, 4]], dtype=np.int32),
    )


def complete(k: int, n_labels: int = 1, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    e = np.array([(i, j) for i in range(k) for j in range(i + 1, k)], np.int32)
    return Graph(
        n=k,
        labels=rng.integers(0, n_labels, size=k).astype(np.int32),
        edges=e,
    )
