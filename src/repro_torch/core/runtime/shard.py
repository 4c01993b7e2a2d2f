"""Shard-map execution backend: the mesh superstep (paper §5.1–§5.3), port
of ``repro.core.runtime.shard``.

The reference runs one jitted ``shard_map`` program per exploration step on
a ``jax.sharding.Mesh`` from one controller. Here the mesh is a
:class:`DeviceMesh` of W workers' ``torch.device``\\ s, also driven from one
process: the worker bodies run in a Python loop, each worker's tensors live
on its own device, and the reference's collectives are explicit functions
over the list of per-worker tensors (:func:`psum`, :func:`pmax`,
:func:`all_gather`, :func:`all_to_all`). Each moves a worker's tensor to
the receiving worker's device, a no-op when the workers share a device
(W virtual workers on one card).

  * expansion + canonicality is *coordination-free* (§5.1): each worker
    expands its frontier slice with no communication, through the same
    fused chunk program the serial backend runs
    (``explore.fused_chunk_step``); children land in the store as
    capacity-padded device tensors, and the host takes ONE control sync a
    superstep on the W workers' exact (unclamped) child counts, stacked
    into one copy;
  * pattern aggregation is ONE collective (§5.3, two-level aggregation):
    per-pattern counts are psum'd and FSM domain bitmaps OR'd, so the bytes
    scale with the patterns, never the embeddings (Table 4 as
    ``StepStats.collective_bytes``);
  * on the partitioned layout every worker holds one CSR shard and fetches
    its halo rows from their owners before expanding (DESIGN.md §11): a
    request/response all-to-all, or the all-gather of the shard tables;
  * the frontier between supersteps is the store's: ``store="raw"``
    splits the rows evenly (broadcast-then-partition, §5.3), and
    ``store="odag"`` OR-merges each worker's children as a fixed-shape
    :class:`~repro_torch.core.odag.DenseODAG` (§5.2, host numpy) and
    re-materialises cost-balanced slices. Exchange bytes ride
    ``collective_bytes``.

The byte counters (``collective_bytes``, ``bytes_to_host``) are the
reference's host-side formulas, so both packages count the same bytes.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, canon_math, explore, obs
from repro_torch.core import pattern as pattern_lib
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.runtime import faults as faults_lib
from repro_torch.core.runtime import programs
from repro_torch.core.runtime.backend import ExecutionBackend
from repro_torch.core.runtime.config import next_pow2
from repro_torch.core.store import FrontierStore, make_store
from repro_torch.kernels import aggregate as agg_kernel_lib
from repro_torch.kernels import canonical_refine
from repro_torch.kernels import gather as gather_kernel_lib
from repro_torch.kernels.dispatch import device_scope, resolve_device

#: candidate slots (rows x member slots x max degree) a worker body expands
#: in one piece; a slice is expanded in row pieces of at most this many
#: slots, appended on the device in order, so its children, counts and
#: syncs are one program's (each piece's temporaries are dropped before the
#: next runs).
BODY_SLOTS = 1 << 26


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class DeviceMesh:
    """W workers' devices on named axes: the counterpart of a
    ``jax.sharding.Mesh`` for one controlling process. ``devices`` is an
    object array of ``torch.device`` shaped like the mesh; several workers
    may share one device."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def worker_devices(self, axes) -> List[torch.device]:
        """The devices of the workers that shard over ``axes``, in
        :func:`_linear_rank` order. Mesh axes outside ``axes`` replicate the
        computation in the reference; one replica (index 0) runs here."""
        out: List[Optional[torch.device]] = [None] * mesh_axis_size(self, axes)
        for idx in itertools.product(*(range(n) for n in self.devices.shape)):
            coord = dict(zip(self.axis_names, idx))
            if any(coord[a] for a in self.axis_names if a not in axes):
                continue
            out[_linear_rank(self, axes, coord)] = self.devices[idx]
        return out


def make_mesh(shape, axis_names, device=None) -> DeviceMesh:
    """A mesh shaped like ``jax.make_mesh(shape, axis_names)``. ``device``
    is one device for every worker (``None`` -> the current CUDA device,
    raising when there is none; ``"cpu"`` for the CPU) or a sequence of
    ``prod(shape)`` devices, laid out row-major."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"{len(device)} devices for a mesh of {n}")
        devs = [_indexed(d) for d in device]
    else:
        devs = [_indexed(resolve_device(device))] * n
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), axis_names)


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` names the current CUDA
    device, which is what a tensor made there reports (workers' devices
    key the per-device tables)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_axis_size(mesh: DeviceMesh, axes) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _linear_rank(mesh: DeviceMesh, axes, coord: Dict[str, int]) -> int:
    """Worker rank linearised over the mesh axes (row-major in axis order,
    matching :func:`all_gather`'s order)."""
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + int(coord[a])
    return r


# ---------------------------------------------------------------------------
# the collectives: per-worker tensor lists in, per-worker lists out
# ---------------------------------------------------------------------------

def psum(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Exact sum over the workers, replicated to every worker (counts are
    int64, so nothing rounds)."""
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(d) for d in devices]


def pmax(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Elementwise max over the workers, replicated: the OR of boolean
    bitmaps (the reference's pmax of 0/1) or the max of counts. It
    accumulates in place into the first part's buffer on the first device,
    so only one extra bitmap is ever resident."""
    acc = parts[0].to(devices[0])
    for p in parts[1:]:
        if acc.dtype == torch.bool:
            acc |= p.to(acc.device)
        else:
            torch.maximum(acc, p.to(acc.device), out=acc)
    return [acc.to(d) for d in devices]


def all_gather(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Every worker's part stacked in rank order on every worker:
    (W, ...) each. Workers that share a device share one stack."""
    stacks: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in stacks:
            stacks[d] = torch.stack([p.to(d) for p in parts])
        out.append(stacks[d])
    return out


def all_to_all(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """``parts[s]`` is worker s's (W, ...) block, row r bound for worker
    r; worker r receives ``stack_s(parts[s][r])`` — the (W, W, ...)
    transpose."""
    return [torch.stack([p[r].to(d) for p in parts])
            for r, d in enumerate(devices)]


# ---------------------------------------------------------------------------
# frontier slices
# ---------------------------------------------------------------------------

def pad_parts(parts, k: int):
    """Pad variable-length per-worker row blocks to one dense ``(W, per, k)``
    int32 array (pad -1) + per-worker counts: the shard-padding convention
    of the even split below and of the store's cost-balanced parts."""
    n = len(parts)
    per = max(max((len(p) for p in parts), default=0), 1)
    padded = np.full((n, per, k), -1, dtype=np.int32)
    counts = np.zeros(n, dtype=np.int32)
    for s, p in enumerate(parts):
        padded[s, : len(p)] = p
        counts[s] = len(p)
    return padded, counts


def partition_frontier(frontier: np.ndarray, n_shards: int):
    """Broadcast-then-partition (§5.3): even block split, padded."""
    b, k = frontier.shape
    per = -(-b // n_shards) if b else 1
    return pad_parts(
        [frontier[s * per: (s + 1) * per] for s in range(n_shards)], k
    )


def _upload_parts(padded: np.ndarray, counts: np.ndarray, size: int,
                  devices):
    """Worker s's padded slice and its n_valid column on its device."""
    per = padded.shape[1]
    n_valid = ((np.arange(per)[None, :] < counts[:, None]) * size).astype(
        np.int32)
    return ([programs.upload(padded[s], d) for s, d in enumerate(devices)],
            [programs.upload(n_valid[s], d) for s, d in enumerate(devices)])


def replicate_graph(g, device):
    """``g`` (a DeviceGraph or PartitionedGraph) on ``device``: itself when
    it is there already."""
    if g.device == torch.device(device):
        return g
    return type(g)(*(t.to(device) for t in g))


def local_shard(pg: PartitionedGraph, s: int, device) -> PartitionedGraph:
    """Worker ``s``'s part of a partitioned graph on its device: its CSR
    shard and adjacency tile (a leading axis of 1), the vertex content
    replicated."""
    def rep(t):
        return t.to(device)

    def own(t):
        return t[s: s + 1].to(device)

    return PartitionedGraph(
        part_offsets=rep(pg.part_offsets), labels=rep(pg.labels),
        edge_uv=rep(pg.edge_uv), edge_labels=rep(pg.edge_labels),
        nbr_sh=own(pg.nbr_sh), nbr_eid_sh=own(pg.nbr_eid_sh),
        deg_sh=own(pg.deg_sh), adj_sh=own(pg.adj_sh),
    )


# ---------------------------------------------------------------------------
# the worker body
# ---------------------------------------------------------------------------

def worker_body(g, members, n_valid, out_cap: int, *, mode: str, app,
                with_patterns: bool, with_local_verts: bool,
                use_pallas: bool, fused: bool, compact_kernel: bool):
    """One worker's expansion of its whole slice: the output contract of
    ``explore.fused_chunk_step`` — ``(children (out_cap, k+1), count,
    codes, local_verts, n_generated, n_canonical)`` with ``count``
    unclamped — and no host sync. The slice runs in row pieces of at most
    :data:`BODY_SLOTS` candidate slots (one piece for a small slice) whose
    children are appended on the device at a device-side offset (rows past
    ``out_cap`` go to a dump row); compaction keeps candidate order, so
    the result is the one fused program's over the whole slice."""
    kw = dict(mode=mode, app=app, with_local_verts=with_local_verts,
              use_pallas=use_pallas, fused=fused,
              compact_kernel=compact_kernel)
    c, k = members.shape
    width = k * (2 if mode == "edge" else 1) * max(g.max_degree, 1)
    piece = max(1, BODY_SLOTS // width)
    dev = members.device
    children = torch.full((out_cap + 1, k + 1), -1, dtype=torch.int32,
                          device=dev)
    slots = torch.arange(out_cap, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    ngen = torch.zeros((), dtype=torch.int64, device=dev)
    ncanon = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, c, piece):
        ch, cnt, _, _, gen, can = explore.fused_chunk_step(
            g, members[lo: lo + piece], n_valid[lo: lo + piece], out_cap,
            with_patterns=False, **kw)
        pos = count + slots
        dest = torch.where((slots < cnt) & (pos < out_cap), pos, out_cap)
        children.index_copy_(0, dest, ch)
        count = count + cnt
        ngen = ngen + gen
        ncanon = ncanon + can
        del ch, pos, dest
    children = children[:out_cap]
    if with_patterns:
        child_nv = torch.where(slots < count, k + 1, 0).to(torch.int32)
        qp = programs.quick_patterns(g, mode, children, child_nv)
        codes = qp.codes
        lv = (qp.local_verts if with_local_verts
              else torch.zeros((0, pattern_lib.MAX_PATTERN_VERTICES),
                               dtype=torch.int32, device=dev))
    else:
        codes = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        lv = torch.zeros((0, pattern_lib.MAX_PATTERN_VERTICES),
                         dtype=torch.int32, device=dev)
    return children, count, codes, lv, ngen, ncanon


def _by_output(outs: List[tuple]) -> tuple:
    """Per-worker output tuples -> one list of per-worker tensors an
    output."""
    return tuple(list(col) for col in zip(*outs))


def make_sharded_expand(app: MiningApp, mesh: DeviceMesh, axes=("data",),
                        use_pallas: bool = False, fused: bool = False,
                        compact_kernel: bool = False,
                        with_patterns: bool = False,
                        with_local_verts: bool = True):
    """One BSP superstep: coordination-free expansion over the mesh.

    ``step(graphs, members, n_valid, out_cap)`` takes per-worker lists (the
    graph replicated on each worker's device, the padded slice, its
    n_valid) and returns per-worker lists ``(children, count, n_generated,
    n_canonical)`` (+ ``(codes, local_verts)`` with ``with_patterns``),
    each worker's on its device. The worker body honours ``fused``
    (``expand_canonical``); the reference's shard body ignores the knob,
    and both routes give the same integers."""
    mode = app.mode

    def step(graphs, members, n_valid, out_cap: int):
        outs = []
        for g, m, nv in zip(graphs, members, n_valid):
            with device_scope("fused_chunk"):
                children, count, codes, lv, ngen, ncanon = worker_body(
                    g, m, nv, out_cap, mode=mode, app=app,
                    with_patterns=with_patterns,
                    with_local_verts=with_local_verts,
                    use_pallas=use_pallas, fused=fused,
                    compact_kernel=compact_kernel,
                )
            o = (children, count, ngen, ncanon)
            outs.append(o + (codes, lv) if with_patterns else o)
        return _by_output(outs)

    return step


def halo_fetch_tile(locals_: List[PartitionedGraph], members, n_valid, *,
                    mode: str, halo: str, devices, w: int, rows: int, n: int,
                    use_pallas: bool = False, compact_kernel: bool = False
                    ) -> List[explore.TileView]:
    """The halo exchange of the partitioned superstep (DESIGN.md §11),
    shared by the mining step and the ``trace_sync`` probe
    (``StepStats.t_exchange``): each worker derives its halo — the unique
    vertices its slice touches (``halo_unique``, through
    ``stream_compact``) — and fetches their rows from the owning shards,
    returning the :class:`explore.TileView` its worker body consumes.

      * ``halo="alltoall"``: a position-aligned request matrix (W, H) of
        vertex ids goes through ONE :func:`all_to_all`; each owner fetches
        the requested rows from its own shard table only (``gather_rows``)
        and a second all-to-all returns them. Bytes scale with the halo.
      * ``halo="gather"``: :func:`all_gather` the shard tables and index
        the full stack (bytes scale with the graph).

    ``w``/``rows``/``n`` are the whole graph's shard count, padded tile rows
    and vertex count; ``locals_[s]`` holds only worker s's shard. The halo
    capacity is a static function of the slice shape
    (``explore.halo_cap``), so nothing overflows and no host sync is
    needed."""
    cap = explore.halo_cap(members[0].shape, mode, n)
    uniq, ok, own = [], [], []
    for pg_l, m, nv in zip(locals_, members, n_valid):
        verts = explore.halo_vertices(pg_l, m, nv, mode)
        u, _ = gather_kernel_lib.halo_unique(verts, n, cap,
                                             use_kernel=compact_kernel)
        uniq.append(u)
        ok.append(u < n)
        safe = u.clamp(0, n - 1)
        o = torch.searchsorted(pg_l.part_offsets, safe.to(
            pg_l.part_offsets.dtype), right=True) - 1
        own.append(o.clamp(0, w - 1).to(torch.int32))

    if halo == "gather":
        # the all-gather fallback: the full shard tables on the wire
        fi = []
        for pg_l, u, o, k_ in zip(locals_, uniq, own, ok):
            safe = u.clamp(0, n - 1)
            flat = (o * rows + (safe - pg_l.part_offsets[o.long()])).clamp(
                0, w * rows - 1)
            fi.append(torch.where(k_, flat, -1).to(torch.int32))

        def fetch(tables, fill):
            full = all_gather(tables, devices)          # (W, rows, ·) each
            return [gather_kernel_lib.gather_rows(
                f.reshape(w * rows, f.shape[-1]), i, fill,
                use_kernel=use_pallas) for f, i in zip(full, fi)]
    else:
        # request all-to-all: req_s[r, i] = uniq_s[i] iff worker r owns it
        req = []
        for s, (u, o, k_) in enumerate(zip(uniq, own, ok)):
            ranks = torch.arange(w, dtype=torch.int32, device=u.device)
            mine = (o[None, :] == ranks[:, None]) & k_[None, :]
            req.append(torch.where(mine, u[None, :], -1).to(torch.int32))
        got = all_to_all(req, devices)                  # (W, cap) each
        del req
        local_rows = []
        for r, (pg_l, g_r) in enumerate(zip(locals_, got)):
            loc = g_r - pg_l.part_offsets[r]
            inr = (g_r >= 0) & (loc >= 0) & (loc < rows)
            local_rows.append(torch.where(inr, loc, -1).to(torch.int32)
                              .reshape(-1))
        del got

        def fetch(tables, fill):
            # each owner reads its own shard table only
            resp = [gather_kernel_lib.gather_rows(
                t, lr, fill, use_kernel=use_pallas).reshape(w, cap, -1)
                for t, lr in zip(tables, local_rows)]
            back = all_to_all(resp, devices)            # (W, cap, ·) each
            del resp
            out = []
            for b, o, k_ in zip(back, own, ok):
                t = b[o.long(), torch.arange(cap, device=b.device)]
                out.append(t.masked_fill(~k_[:, None], fill))
            return out

    nbr_t = fetch([pg.nbr_sh[0] for pg in locals_], -1)
    if mode == "edge":
        ned_t = fetch([pg.nbr_eid_sh[0] for pg in locals_], -1)
        adj_t = [torch.zeros((cap, 1), dtype=torch.int32, device=d)
                 for d in devices]
    else:
        adj_t = fetch([pg.adj_sh[0] for pg in locals_], 0)
        ned_t = [torch.zeros((cap, 0), dtype=torch.int32, device=d)
                 for d in devices]
    return [
        explore.TileView(uniq=u, labels=pg.labels, edge_uv=pg.edge_uv,
                         edge_labels=pg.edge_labels, nbr_t=a, nbr_eid_t=e,
                         adj_t=j)
        for u, pg, a, e, j in zip(uniq, locals_, nbr_t, ned_t, adj_t)
    ]


def make_sharded_expand_partitioned(app: MiningApp, mesh: DeviceMesh,
                                    axes=("data",), halo: str = "alltoall",
                                    use_pallas: bool = False,
                                    compact_kernel: bool = False,
                                    with_patterns: bool = False,
                                    with_local_verts: bool = True):
    """The partitioned superstep (DESIGN.md §11): halo exchange + worker
    bodies. ``step(locals_, members, n_valid, out_cap, w=, rows=, n=)``
    takes each worker's :func:`local_shard`; the exchange
    (:func:`halo_fetch_tile`) runs for all workers, then each worker runs
    the same body on its tile view (the fused kernel does not apply to a
    tile view, as in the reference). Both collectives sit inside the step,
    so the superstep keeps its one count sync."""
    mode = app.mode
    devices = mesh.worker_devices(axes)

    def step(locals_, members, n_valid, out_cap: int, *, w: int, rows: int,
             n: int):
        with device_scope("halo_exchange"):
            views = halo_fetch_tile(
                locals_, members, n_valid, mode=mode, halo=halo,
                devices=devices, w=w, rows=rows, n=n,
                use_pallas=use_pallas, compact_kernel=compact_kernel,
            )
        outs = []
        for s, (m, nv) in enumerate(zip(members, n_valid)):
            with device_scope("fused_chunk"):
                children, count, codes, lv, ngen, ncanon = worker_body(
                    views[s], m, nv, out_cap, mode=mode, app=app,
                    with_patterns=with_patterns,
                    with_local_verts=with_local_verts,
                    use_pallas=use_pallas, fused=False,
                    compact_kernel=compact_kernel,
                )
            views[s] = None
            o = (children, count, ngen, ncanon)
            outs.append(o + (codes, lv) if with_patterns else o)
        return _by_output(outs)

    return step


def halo_bytes(pg: PartitionedGraph, mode: str, halo: str, per: int,
               size: int) -> int:
    """Halo-exchange bytes of one dispatch over ``pg.n_parts`` workers'
    (per, size) slices, computed on the host: the halo capacity is a
    static function of the slice shape (``explore.halo_cap``) and the row
    widths come from the shard tables, so the count needs no device
    output or sync."""
    w = pg.n_parts
    cap = explore.halo_cap((per, size), mode, pg.n)
    if mode == "edge":
        row = 2 * pg.max_degree * 4          # nbr + edge-id rows, int32
    else:
        row = (pg.max_degree + pg.adj_sh.shape[2]) * 4
    if halo == "gather":
        # every worker all-gathers the full shard tables
        return w * w * pg.tile_rows * row
    # request all-to-all (vertex ids) + response all-to-all (rows)
    return w * w * cap * (4 + row)


def make_sharded_halo_probe(mode: str, mesh: DeviceMesh, axes=("data",),
                            halo: str = "alltoall", use_pallas: bool = False,
                            compact_kernel: bool = False):
    """The halo exchange alone, for the ``trace_sync`` probe
    (``StepStats.t_exchange``, DESIGN.md §12): the mining step runs it
    inside the superstep, so its share of ``t_expand`` is separable only
    by running the stage on its own, which only the diagnostic sync mode
    pays."""
    devices = mesh.worker_devices(axes)

    def probe(locals_, members, n_valid, w: int, rows: int, n: int):
        views = halo_fetch_tile(
            locals_, members, n_valid, mode=mode, halo=halo, devices=devices,
            w=w, rows=rows, n=n, use_pallas=use_pallas,
            compact_kernel=compact_kernel,
        )
        return [v.nbr_t for v in views]

    return probe


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

class ShardCarried(NamedTuple):
    """Child pattern state the shard-map backend carries between supersteps
    under ``device_aggregate`` (DESIGN.md §10): each worker's quick codes
    and local-vertex rows stay on its device at the step's padded capacity,
    with the host-known valid counts."""

    codes: List[torch.Tensor]     # W x (cap, 3) int64
    lv: List[torch.Tensor]        # W x (cap, 8) int32 ((0, 8) if unread)
    counts: np.ndarray            # (W,) valid rows per worker


def make_sharded_quick_bin(mesh: DeviceMesh, axes=("data",),
                           use_kernel: bool = False,
                           bin_method: str = "sort"):
    """Device-resident level-1 aggregation over the mesh (DESIGN.md §10).

    Each worker bins its quick codes locally (``kernels/aggregate.bin_rows``)
    at ``local_cap``, a *pattern*-sized capacity; the O(Q) distinct tables
    are all-gathered and every worker re-bins the union into one global
    table (identical on every worker: the input is the gathered tables);
    then the per-slot counts are psum'd — Table 4's promise as a collective
    whose bytes scale with the patterns. The workers' unclamped local
    distinct counts are pmax'd: their max past ``local_cap`` is the
    reference's ``corrupt`` flag, and it rides the distinct total's read
    (no extra sync). It also sizes the one re-bin that recovers: every
    worker fits a ``local_cap`` of at least that max.

    ``agg(codes, valid, local_cap, global_cap)`` returns
    ``(global uniq, global counts, global n, max local n, row slots)``:
    the first four replicated (worker 0's), the row slots a per-worker
    list."""
    devices = mesh.worker_devices(axes)

    def agg(codes_sh, valid_sh, local_cap: int, global_cap: int):
        w = len(devices)
        with device_scope("aggregate_bin"):
            local = [agg_kernel_lib.bin_rows(c, v, local_cap,
                                             use_kernel=use_kernel,
                                             method=bin_method)
                     for c, v in zip(codes_sh, valid_sh)]
            # the gathered tables; the reference also gathers the local
            # counts, which its re-bin discards (collective_bytes counts
            # them as it does)
            gath_u = all_gather([o[0] for o in local], devices)
            gath_v = all_gather([o[4] for o in local], devices)
            glob: Dict[torch.device, tuple] = {}
            local_counts, row_slot = [], []
            for s, d in enumerate(devices):
                # every worker re-bins the same gathered union: workers
                # sharing a device share the result
                if d not in glob:
                    glob[d] = agg_kernel_lib.bin_rows(
                        gath_u[s].reshape(w * local_cap, 3),
                        gath_v[s].reshape(w * local_cap), global_cap,
                        use_kernel=use_kernel, method=bin_method)
                gu, _, ginv, gn, _ = glob[d]
                _, c, inv, n, uv = local[s]
                my_map = ginv[s * local_cap: (s + 1) * local_cap]
                seg = torch.where(uv & (my_map >= 0), my_map, global_cap)
                cnt = torch.zeros((global_cap + 1,), dtype=torch.int64,
                                  device=d)
                cnt.index_add_(0, seg.long(), c)
                local_counts.append(cnt[:global_cap])
                # an overflowing worker's slots (inv >= local_cap) are
                # clamped, as the reference's gather clamps: the caller
                # discards a step whose max local n passed local_cap
                row_slot.append(torch.where(
                    inv >= 0, my_map[inv.clamp(0, local_cap - 1).long()], -1
                ).to(torch.int32))
            # THE collective: per-slot counts psum'd over the mesh
            counts = psum(local_counts, devices)
            nmax = pmax([o[3].to(torch.int64).reshape(1) for o in local],
                        devices)
            gu, _, _, gn, _ = glob[devices[0]]
        return gu, counts[0], gn, nmax[0][0], row_slot

    return agg


def make_sharded_domain_scatter(mesh: DeviceMesh, axes=("data",)):
    """FSM phase 2 under ``device_aggregate``: every worker scatters its
    rows' vertices into the canonical domain bitmap at its global slots,
    then ONE OR (:func:`pmax`) merges the (pc_cap, 8, N) bitmaps — the
    paper's domain merge as a collective. A worker on the accumulator's
    device scatters straight into it (setting bits is the OR), so W
    workers on one card hold one bitmap, not W."""
    devices = mesh.worker_devices(axes)
    kmax = pattern_lib.MAX_PATTERN_VERTICES

    def scat(row_slot, lv, tables, pc_cap: int, n_vertices: int):
        size = pc_cap * kmax * n_vertices + 1
        acc = torch.zeros((size,), dtype=torch.bool, device=devices[0])
        for s, d in enumerate(devices):
            q2c, si = tables[d]
            flat = (acc if d == acc.device
                    else torch.zeros((size,), dtype=torch.bool, device=d))
            flat = aggregation.scatter_canon_bitmaps(
                flat, row_slot[s], lv[s], q2c, si, pc_cap, n_vertices)
            if flat is not acc:
                acc = pmax([acc, flat], [acc.device, acc.device])[0]
        return acc[:-1].reshape(pc_cap, kmax, n_vertices)

    return scat


def make_sharded_aggregate(mesh: DeviceMesh, axes=("data",)):
    """The host aggregation path's global reduce as ONE collective: per-
    worker segment counts psum'd, and with domains the per-worker domain
    bitmaps OR'd."""
    devices = mesh.worker_devices(axes)

    def agg(canon_slot, verts_canon, valid, n_canon: int, n_vertices: int,
            with_domains: bool):
        counts, bitmaps = [], []
        for slot, vc, ok in zip(canon_slot, verts_canon, valid):
            seg = torch.where(ok, slot, n_canon).long()
            c = torch.zeros((n_canon + 1,), dtype=torch.int64,
                            device=slot.device)
            c.index_add_(0, seg, ok.to(torch.int64))
            counts.append(c[:n_canon])
            if with_domains:
                bitmaps.append(aggregation.domain_bitmaps(
                    slot, vc, ok, n_canon, n_vertices))
        # THE collective: bytes ∝ #patterns, not #embeddings (Table 4)
        total = psum(counts, devices)[0]
        bm = pmax(bitmaps, devices)[0] if with_domains else None
        return total, bm

    return agg


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

class ShardMapBackend(ExecutionBackend):
    """The superstep on a :class:`DeviceMesh` of W workers. Each worker
    mines its whole slice a superstep, so ``device_budget_bytes`` does not
    apply here, as in the reference's backend."""

    name = "shard_map"
    #: how a step whose per-worker distinct table overflowed recovers:
    #: ``True`` re-bins once on the workers' devices at the grown capacity,
    #: ``False`` takes the reference's host path (every embedding's codes
    #: to the host); ``None`` picks the re-bin when the workers' devices
    #: are CUDA devices and the host path otherwise
    refold_on_device: Optional[bool] = None

    def __init__(self, mesh: DeviceMesh, axes=None) -> None:
        self.mesh = mesh
        self._axes_override = axes

    def home_device(self) -> torch.device:
        """Where a host graph is uploaded: worker 0's device."""
        return self.mesh.worker_devices(
            self._axes_override or self.mesh.axis_names)[0]

    def _make_store(self) -> FrontierStore:
        config, app, g = self.config, self.app, self.g
        self.axes = (self._axes_override if self._axes_override is not None
                     else config.axes)
        self.n_shards = mesh_axis_size(self.mesh, self.axes)
        self._devices = self.mesh.worker_devices(self.axes)
        self._device = g.device
        self._use_pallas = bool(config.use_pallas)
        self._compact = bool(config.compact_kernel)
        self._agg_kernel = bool(config.aggregate_kernel)
        self._agg_bin = config.resolve_aggregate_bin()
        store = make_store(
            config.store, g,
            mode=app.mode,
            app_filter=programs.store_app_filter(app, g),
            use_pallas=self._use_pallas,
            dense_exchange=True,
        )
        # carried child codes need the next frontier to be exactly the
        # appended rows in order — raw store only (ODAG extraction
        # resurrects rows), and the naive-aggregation baseline deliberately
        # re-derives everything
        self.with_patterns = (
            config.async_chunks
            and app.wants_patterns
            and store.kind == "raw"
            and not config.naive_aggregation
        )
        # device-resident level 1 (DESIGN.md §10): local bin + gathered
        # global table + per-slot psum/pmax; alpha must be pattern-granular
        self._device_agg = (
            config.device_aggregate
            and app.wants_patterns
            and not config.naive_aggregation
            and type(app).aggregation_filter is MiningApp.aggregation_filter
        )
        # the local-vertex rows are read by the FSM domain scatter and, on
        # the host path, counted in the bytes that cross
        with_lv = app.wants_domains or not self._device_agg
        # level-2 placement (DESIGN.md §15): host_async needs the
        # deferrable device-aggregation path, as in the serial backend
        self._canon_placement = config.resolve_canonical_placement()
        if self._canon_placement == "host_async" and not (
            self._device_agg and aggregation.async_level2_ok(app)
        ):
            self._canon_placement = "host"
        if config.canonical_memo_cap is not None:
            pattern_lib.set_memo_cap(config.canonical_memo_cap)
        #: per-worker distinct-table capacity (pattern-sized, so gathered
        #: bytes stay O(Q)); grows pow2 after a step that overflowed it
        self._shard_qcap = next_pow2(max(config.agg_qcap, 1))
        self._refold = (
            self.refold_on_device if self.refold_on_device is not None
            else all(d.type == "cuda" for d in self._devices)
        )
        self._partitioned = isinstance(g, PartitionedGraph)
        if self._partitioned:
            if g.n_parts != self.n_shards:
                raise ValueError(
                    f"graph_partition={g.n_parts} must equal the shard-map "
                    f"worker count ({self.n_shards}): the halo exchange maps "
                    "one CSR shard per worker"
                )
            self._halo = config.resolve_halo()
            self._graphs = [local_shard(g, s, d)
                            for s, d in enumerate(self._devices)]
            self._expand = make_sharded_expand_partitioned(
                app, self.mesh, self.axes, halo=self._halo,
                use_pallas=self._use_pallas, compact_kernel=self._compact,
                with_patterns=self.with_patterns, with_local_verts=with_lv,
            )
            self._halo_probe = make_sharded_halo_probe(
                app.mode, self.mesh, self.axes, halo=self._halo,
                use_pallas=self._use_pallas, compact_kernel=self._compact,
            )
        else:
            self._graphs = [replicate_graph(g, d) for d in self._devices]
            self._expand = make_sharded_expand(
                app, self.mesh, self.axes, use_pallas=self._use_pallas,
                fused=config.fused_expand, compact_kernel=self._compact,
                with_patterns=self.with_patterns, with_local_verts=with_lv,
            )
        self._aggregate = make_sharded_aggregate(self.mesh, self.axes)
        self._quick_bin = make_sharded_quick_bin(
            self.mesh, self.axes, use_kernel=self._agg_kernel,
            bin_method=self._agg_bin,
        )
        self._domain_scatter = make_sharded_domain_scatter(self.mesh,
                                                           self.axes)
        self._row_slot = None
        return store

    # -- superstep hooks ----------------------------------------------------
    def begin_step(self, store, st) -> List[np.ndarray]:
        self._row_slot = None
        # raw: deterministic block split (broadcast-then-partition); odag:
        # §5.3 cost-annotated partitions, one extraction per worker
        return store.worker_parts(self.n_shards)

    def quick_codes(self, blocks, size):
        frontier = (
            np.concatenate(blocks, axis=0)
            if any(len(p) for p in blocks)
            else np.zeros((0, size), np.int32)
        )
        b = len(frontier)
        qp = programs.quick_patterns(
            self.g, self.app.mode, programs.upload(frontier, self._device),
            torch.full((b,), size, dtype=torch.int32, device=self._device),
        )
        return qp.codes.cpu().numpy(), qp.local_verts.cpu().numpy()

    def aggregate(self, codes, lv, st):
        g, app, config = self.g, self.app, self.config
        n_shards = self.n_shards
        b = len(codes)
        if config.naive_aggregation:
            # the naive scheme: exchange per-EMBEDDING codes (an all-gather
            # of B x 24 bytes x workers) and canonicalise once per
            # embedding instead of once per quick pattern
            obs.count(st, "collective_bytes", int(codes.size * 8) * n_shards)
            for row in codes:
                canon_math.canonicalize_one(row)            # B iso checks
        uniq, inv = aggregation.quick_slot_ids(codes, np.ones(b, bool))
        # placement "device" routes the miss batch through the refine
        # kernel even on this host path (bit-identical); "host_async" has
        # no deferrable table here and runs synchronously
        canon_fn = (
            canonical_refine.make_canon_fn(use_kernel=self._agg_kernel,
                                           device=self._device)
            if self._canon_placement == "device"
            else None
        )
        table = pattern_lib.build_pattern_table(
            uniq, with_orbits=app.wants_domains, canon_fn=canon_fn
        )
        pc = len(table.canon_codes)
        canon_slot, verts_canon = aggregation.map_to_canonical_positions(
            table, inv, lv
        )
        # shard the level-1 inputs, reduce with the collective
        slot_sh, slot_counts = partition_frontier(canon_slot[:, None],
                                                  n_shards)
        vc_sh, _ = partition_frontier(verts_canon.cpu().numpy(), n_shards)
        per = slot_sh.shape[1]
        valid_sh = np.arange(per)[None, :] < slot_counts[:, None]
        devs = self._devices
        counts, bitmaps = self._aggregate(
            [programs.upload(slot_sh[s, :, 0], d) for s, d in enumerate(devs)],
            [programs.upload(vc_sh[s], d) for s, d in enumerate(devs)],
            [torch.from_numpy(valid_sh[s]).to(d) for s, d in enumerate(devs)],
            n_canon=max(pc, 1), n_vertices=g.n,
            with_domains=app.wants_domains,
        )
        counts = counts[:pc].cpu().numpy()
        if app.wants_domains:
            bm = bitmaps[:pc].cpu().numpy()
            supports = aggregation.min_image_support(
                bm, table.canon_n_verts, table.canon_orbits
            )
        else:
            supports = counts.copy()
        agg_out = aggregation.StepAggregates(
            canon_codes=table.canon_codes,
            counts=counts.astype(np.int64),
            supports=np.asarray(supports).astype(np.int64),
            n_quick=len(uniq),
            n_canonical=pc,
            n_iso_checks=table.n_iso_checks,
        )
        obs.set_stat(st, "n_quick_patterns", agg_out.n_quick)
        obs.set_stat(st, "n_canonical_patterns", agg_out.n_canonical)
        obs.set_stat(
            st, "n_iso_checks",
            b if config.naive_aggregation else agg_out.n_iso_checks,
        )
        obs.count(
            st, "collective_bytes",
            counts.nbytes + (pc * pattern_lib.MAX_PATTERN_VERTICES * g.n // 8
                             if app.wants_domains else 0),
        )
        return agg_out, canon_slot

    # -- device-resident aggregation (DESIGN.md §10) ------------------------
    def aggregate_step(self, blocks, size, carried, st):
        if not self._device_agg:
            return super().aggregate_step(blocks, size, carried, st)
        app, devs = self.app, self._devices
        n_shards = self.n_shards
        n_frontier = sum(len(blk) for blk in blocks)
        if (
            isinstance(carried, ShardCarried)
            and int(carried.counts.sum()) == n_frontier
        ):
            # the children's codes never left the workers' devices (nor
            # their padded layout): aggregation uploads nothing
            codes_sh, lv_sh, cnts = carried
            per = int(codes_sh[0].shape[0])
        else:
            padded, cnts = pad_parts(blocks, size)
            per = next_pow2(max(padded.shape[1], 1))
            if per > padded.shape[1]:
                padded = np.concatenate(
                    [padded,
                     np.full((n_shards, per - padded.shape[1], size), -1,
                             np.int32)],
                    axis=1,
                )
            members, n_valid = _upload_parts(padded, cnts, size, devs)
            codes_sh, lv_sh = [], []
            for s, d in enumerate(devs):
                qp = programs.quick_patterns(replicate_graph(self.g, d),
                                             app.mode, members[s], n_valid[s])
                codes_sh.append(qp.codes)
                lv_sh.append(qp.local_verts)
            del members, n_valid
        valid_sh = [torch.arange(per, device=d) < int(cnts[s])
                    for s, d in enumerate(devs)]
        local_cap = min(next_pow2(max(per, 1)), self._shard_qcap)
        global_cap = next_pow2(max(n_shards * local_cap, 1))
        gu, gcounts, gn, nmax, row_slot = self._quick_bin(
            codes_sh, valid_sh, local_cap=local_cap, global_cap=global_cap
        )
        # the distinct total and the largest local distinct count in one
        # read (the reference reads its overflow flag in their place)
        flags = torch.stack([gn.to(torch.int32),
                             nmax.to(torch.int32)]).cpu().numpy()
        obs.count(st, "bytes_to_host", flags.nbytes)
        overflow = int(flags[1]) > local_cap
        if faults_lib.take(
            self.config.faults, "aggregate", st.step, "saturate"
        ):
            # injected saturation: recovered exactly as a real overflow
            # (DESIGN.md §13)
            overflow = True
        if overflow and not self._refold:
            # a worker's distinct table overflowed the pattern-sized cap:
            # the reference's host path for this step, a bigger cap for
            # the next
            codes, lv = self.quick_codes(blocks, size)
            obs.count(st, "bytes_to_host", codes.nbytes + lv.nbytes)
            agg_out, canon_slot = self.aggregate(codes, lv, st)
            self._shard_qcap = max(
                self._shard_qcap, next_pow2(max(agg_out.n_quick, 1))
            )
            return agg_out, canon_slot
        # the collective itself: gathered O(Q) tables + per-slot psum
        obs.count(
            st, "collective_bytes",
            n_shards * local_cap * (24 + 8 + 1) + global_cap * 8,
        )
        if overflow:
            # the same recovery on the workers' devices, as the serial
            # backend re-folds: grow the cap pow2 to the largest unclamped
            # local count and re-bin once. It fits: every worker's table
            # holds at most that many codes, and the union at most W times
            # as many
            self._shard_qcap = max(self._shard_qcap,
                                   next_pow2(max(int(flags[1]), 1)))
            local_cap = min(next_pow2(max(per, 1)), self._shard_qcap)
            global_cap = next_pow2(max(n_shards * local_cap, 1))
            del gu, gcounts, row_slot
            gu, gcounts, gn, _, row_slot = self._quick_bin(
                codes_sh, valid_sh, local_cap=local_cap,
                global_cap=global_cap
            )
            flags = gn.to(torch.int32).reshape(1).cpu().numpy()
            obs.count(st, "bytes_to_host", flags.nbytes)
            obs.count(
                st, "collective_bytes",
                n_shards * local_cap * (24 + 8 + 1) + global_cap * 8,
            )
        n = int(flags[0])
        # a second small read sizes the packed transfer (the serial
        # backend's packed O(Q) drain)
        pflags = torch.stack([
            (gu[:n, 1] != 0).any(),
            (gu[:n, 2] != 0).any(),
            (gcounts[:n].max() if n else torch.zeros(
                (), dtype=torch.int64, device=gu.device)) < 2**31,
        ]).cpu().numpy()
        uniq, counts_q, tbytes = aggregation.drain_distinct(
            gu, gcounts, n,
            w1_used=bool(pflags[0]), w2_used=bool(pflags[1]),
            fit32=bool(pflags[2]),
        )
        obs.count(st, "bytes_to_host", pflags.nbytes + tbytes)
        placement = self._canon_placement
        if placement == "host_async":
            # overlap: joined by the loop at the seal boundary; eligibility
            # guarantees neither alpha_rows nor the domain scatter fires
            with obs.annotate("canonicalize_submit"):
                pending = aggregation.submit_level2(uniq, counts_q)
            self._row_slot, self._row_cnts = row_slot, cnts
            self._agg_table, self._agg_global_cap = None, global_cap
            return pending, None
        t0 = time.perf_counter()
        with obs.span("canonicalize", placement=placement, n_quick=n):
            if placement == "device" and n:
                # the canonical re-bin runs on the replicated global table
                # (identical on every worker after the gather): no new
                # control read appears
                uv_dev = torch.arange(global_cap, device=gu.device) < n
                table, counts, nbytes2 = aggregation.device_level2(
                    gu, gcounts, uv_dev, global_cap, n, uniq, counts_q,
                    nvs=aggregation.level2_nvs(app, size),
                    with_domains=app.wants_domains,
                    use_kernel=self._agg_kernel, method=self._agg_bin,
                )
                obs.count(st, "bytes_to_host", nbytes2)
            else:
                table, counts = aggregation.finish_quick_level2(
                    uniq, counts_q, app.wants_domains
                )
        obs.count(st, "t_canon", time.perf_counter() - t0)
        pc = len(table.canon_codes)
        if app.wants_domains and pc:
            pc_cap = next_pow2(pc)
            tables = {d: aggregation.level2_device_tables(table, global_cap,
                                                          d)
                      for d in set(devs)}
            bm_all = self._domain_scatter(row_slot, lv_sh, tables,
                                          pc_cap=pc_cap, n_vertices=self.g.n)
            obs.count(st, "collective_bytes",
                      (pc_cap * pattern_lib.MAX_PATTERN_VERTICES
                       * self.g.n) // 8)
            bm = bm_all[:pc].cpu().numpy()
            del bm_all
            obs.count(st, "bytes_to_host", bm.nbytes)
            supports = aggregation.min_image_support(
                bm, table.canon_n_verts, table.canon_orbits
            )
        else:
            supports = counts.copy()
        agg_out = aggregation.build_step_aggregates(
            table, counts, supports, n, st
        )
        self._row_slot, self._row_cnts = row_slot, cnts
        self._agg_table, self._agg_global_cap = table, global_cap
        return agg_out, None

    def alpha_rows(self, pk, st):
        """Per-row alpha from the per-pattern verdict: each worker gathers
        the keep table through its own row slots on its device; the W masks
        cross in one copy and are re-assembled in sealed-frontier order
        through the per-worker valid counts."""
        table = self._agg_table
        q = len(table.quick_codes)
        pk_q = np.zeros(self._agg_global_cap, dtype=bool)
        pk_q[:q] = np.asarray(pk, dtype=bool)[table.quick_to_canon]
        keep = {d: torch.from_numpy(pk_q).to(d) for d in set(self._devices)}
        masks = [keep[slot.device][slot.clamp(min=0).long()] & (slot >= 0)
                 for slot in self._row_slot]
        dev0 = self._devices[0]
        mask_sh = torch.stack([m.to(dev0) for m in masks]).cpu().numpy()
        obs.count(st, "bytes_to_host", mask_sh.nbytes)
        return np.concatenate(
            [mask_sh[s, : self._row_cnts[s]] for s in range(self.n_shards)]
        )

    def expand(self, store, blocks, size, st):
        # coordination-free expansion over the (§5.3 cost-balanced)
        # per-worker slices
        g, devs = self.g, self._devices
        shards, counts_sh = pad_parts(blocks, size)
        per = shards.shape[1]
        members, n_valid = _upload_parts(shards, counts_sh, size, devs)
        kw = ({"w": g.n_parts, "rows": g.tile_rows, "n": g.n}
              if self._partitioned else {})
        halo_bytes = self._halo_bytes(per, size) if self._partitioned else 0
        if self._partitioned:
            # the halo-exchange injection site (DESIGN.md §13): a planned
            # "halo" fault aborts here, where a lost worker would surface;
            # the supervisor's ladder answers with halo="gather"
            faults_lib.trip(self.config.faults, "halo", st.step)
        if self._partitioned and obs.sync_active():
            obs.count(
                st, "t_exchange",
                obs.probe_time(
                    lambda: self._halo_probe(self._graphs, members, n_valid,
                                             **kw)),
            )
        while True:
            outs = self._expand(self._graphs, members, n_valid,
                                self.capacity, **kw)
            # THE per-step control sync: the W workers' counts, generated
            # and canonical totals stacked and copied once
            dev0 = devs[0]
            meta = torch.stack([
                torch.stack([c.to(dev0, torch.int64) for c in outs[i]])
                for i in (1, 2, 3)
            ]).cpu().numpy()
            obs.count(st, "n_host_syncs", 1)
            obs.count(st, "n_chunks", 1)
            obs.count(st, "collective_bytes", halo_bytes)
            ccount = meta[0]
            if int(ccount.max()) <= self.capacity:
                break
            # counts are exact (unclamped compaction), so exactly one
            # re-dispatch at the next pow2 bucket suffices
            del outs
            self.capacity = next_pow2(int(ccount.max()))
        obs.set_stat(st, "n_generated", int(meta[1].sum()))
        obs.set_stat(st, "n_canonical", int(meta[2].sum()))

        # frontier exchange: worker-local children into the store as device
        # tensors (resolved at seal; odag: the DenseODAG merge, §5.2); with
        # the fused pipeline the children's pattern codes are carried to
        # the next superstep's aggregation
        for s in range(self.n_shards):
            store.append(outs[0][s], worker=s, count=int(ccount[s]))
        if not self.with_patterns:
            return None
        if self._device_agg:
            # DESIGN.md §10: the child pattern state stays on the workers'
            # devices — no host concatenation, no host bytes
            return ShardCarried(codes=outs[4], lv=outs[5],
                                counts=ccount.astype(np.int32))
        return (
            np.concatenate([outs[4][s][: ccount[s]].cpu().numpy()
                            for s in range(self.n_shards)]),
            np.concatenate([outs[5][s][: ccount[s]].cpu().numpy()
                            for s in range(self.n_shards)]),
        )

    def _halo_bytes(self, per: int, size: int) -> int:
        return halo_bytes(self.g, self.app.mode, self._halo, per, size)

    def end_step(self, store, st) -> None:
        # frontier exchange: what a worker ships (raw rows, or the merged
        # ODAG with store="odag") rides the collective accounting
        obs.count(st, "collective_bytes", store.exchange_bytes)
        self._row_slot = None
