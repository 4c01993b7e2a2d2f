"""Pilot-calibrated cost-model dispatch (DESIGN.md §14), port of
``repro.core.runtime.costmodel``.

Every unset knob of :class:`RunConfig` is filled from a
:class:`DecisionTable`:

``static_table``
    The pre-calibration defaults: fused pipeline, device aggregation, the
    sort bin, host level 2, and the kernel knobs on where the hand-written
    kernels run (``device.type == "cuda"``, in place of the reference's
    ``platform == "tpu"``). Graphs below ``cost_model_min_edges`` resolve
    here; so does ``cost_model="off"``.

``calibrate``
    The probe set, run before the first superstep on a pilot-sized slice
    of the real workload: (1) the expand ladder, (2) the bin ladder, (3)
    level-1 placement (device fold+merge against the host drain, per row),
    (4) the pipeline shape (the chunk loop's per-chunk tax against the
    fused pipeline's), (5) level-2 placement (the device refine against
    the host batch). On CPU tensors the kernel knobs select the plain
    versions, so the expand and bin ladders run as the reference's do. On
    the card a plain version repeats a kernel's arithmetic step by step
    and is never the main path's: ``use_pallas``, ``compact_kernel`` and
    ``aggregate_kernel`` keep the static table's True, probe 1 is skipped
    (it would decide nothing) and probe 2 chooses between the sort and the
    radix bin, both on their kernels. Probes 3–5 decide as the reference's
    do.

caching
    Calibration runs once per (backend, device type, app fingerprint,
    graph fingerprint, config signature) — process-wide in
    ``_PROCESS_CACHE`` and, with ``cost_model_dir``, as JSON on disk, so a
    fresh process skips the pilot. The fingerprints are the checkpoint's.

forcing
    ``"force_device"`` / ``"force_host"`` pin the placement knobs to the
    two extremes. Explicitly set config knobs always win over the table.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.runtime import faults

#: table schema version — bump to invalidate every persisted table.
#: v2: + canonical_placement (level-2 placement, DESIGN.md §15).
SCHEMA_VERSION = 2

#: the config knobs a table decides, in resolution order.
DECIDED_KNOBS = (
    "async_chunks",
    "device_aggregate",
    "use_pallas",
    "compact_kernel",
    "aggregate_kernel",
    "aggregate_bin",
    "canonical_placement",
)

COST_MODEL_MODES = ("auto", "off", "force_device", "force_host")

#: pilot rows the expand ladder times (a real size-1 chunk slice).
PROBE_CHUNK_ROWS = 256
#: rows the bin ladder times (pilot children tiled up — large enough that
#: the sort-vs-radix ordering matches full-superstep batches).
PROBE_BIN_ROWS = 65536
#: expand-probe output capacity cap.
PROBE_OUT_CAP = 1 << 15
#: a kernel combo of the CPU expand ladder must be >=10% faster than the
#: plain routes at probe time to be chosen — near-ties are noise.
EXPAND_HYSTERESIS = 0.9

_PROCESS_CACHE: Dict[tuple, "DecisionTable"] = {}


@dataclasses.dataclass
class DecisionTable:
    """Concrete value of every decided knob + the timings that chose it."""

    backend: str                     # execution backend ("serial")
    platform: str                    # device type at decision time
    source: str                      # static | calibrated | cached | forced:<m>
    async_chunks: bool = True
    device_aggregate: bool = True
    use_pallas: bool = False
    compact_kernel: bool = False
    aggregate_kernel: bool = False
    aggregate_bin: str = "sort"      # "sort" | "radix"
    canonical_placement: str = "host"  # "device" | "host" | "host_async"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["schema"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "DecisionTable":
        if d.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"decision-table schema {d.get('schema')!r} != {SCHEMA_VERSION}"
            )
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d}
        return cls(**kw)

    def copy(self) -> "DecisionTable":
        return dataclasses.replace(self, timings=dict(self.timings))

    def decisions(self) -> Dict:
        """The knob -> choice mapping alone."""
        return {k: getattr(self, k) for k in DECIDED_KNOBS}


# ---------------------------------------------------------------------------
# static + forced tables
# ---------------------------------------------------------------------------

def static_table(backend_name: str, device: torch.device,
                 source: str = "static") -> DecisionTable:
    """The pre-calibration defaults: fused pipeline + device aggregation
    everywhere, the hand-written kernels where they run (CUDA), sort bin."""
    native = device.type == "cuda"
    return DecisionTable(
        backend=backend_name, platform=device.type, source=source,
        async_chunks=True, device_aggregate=True,
        use_pallas=native, compact_kernel=native, aggregate_kernel=native,
        aggregate_bin="sort",
    )


def forced_table(mode: str, backend_name: str,
                 device: torch.device) -> DecisionTable:
    """The ``force_device``/``force_host`` placement extremes (kernel knobs
    stay at their static defaults)."""
    t = static_table(backend_name, device, source=f"forced:{mode}")
    if mode == "force_device":
        t.async_chunks = True
        t.device_aggregate = True
        t.aggregate_bin = "radix"
        t.canonical_placement = "device"
    elif mode == "force_host":
        t.async_chunks = False
        t.device_aggregate = False
        t.aggregate_bin = "sort"
        t.canonical_placement = "host"
    else:
        raise ValueError(f"unknown forced cost_model mode {mode!r}")
    return t


# ---------------------------------------------------------------------------
# cache keys: the checkpoint fingerprints + a config signature
# ---------------------------------------------------------------------------

def config_signature(config) -> str:
    """Hash of the config fields that change what calibration would
    measure (batch geometry + store discipline), NOT of the knobs the
    table decides — a user flipping ``aggregate_kernel`` must not fork the
    cache, it just overrides the table. The reference's fields less
    ``pallas_interpret``, which the port has not."""
    payload = repr((
        config.chunk_size, config.initial_capacity, config.agg_qcap,
        config.store, config.device_budget_bytes, config.graph_partition,
        config.fused_expand,
    ))
    return hashlib.sha1(payload.encode()).hexdigest()


def cache_key(backend_name: str, platform: str, app_fp: str, graph_fp: str,
              cfg_sig: str) -> tuple:
    return (SCHEMA_VERSION, backend_name, platform, app_fp, graph_fp, cfg_sig)


def _cache_path(cost_model_dir: str, key: tuple) -> str:
    _, backend, platform, app_fp, graph_fp, cfg_sig = key
    name = (
        f"costmodel-v{SCHEMA_VERSION}-{platform}-{backend}"
        f"-{app_fp[:10]}-{graph_fp[:10]}-{cfg_sig[:10]}.json"
    )
    return os.path.join(cost_model_dir, name)


def _load_cached(cost_model_dir: str, key: tuple) -> Optional[DecisionTable]:
    path = _cache_path(cost_model_dir, key)
    try:
        with open(path, "r", encoding="utf-8") as f:
            t = DecisionTable.from_dict(json.load(f))
    except (OSError, ValueError, KeyError, TypeError):
        return None
    t.source = "cached"
    return t


def _save_cached(cost_model_dir: str, key: tuple, table: DecisionTable) -> None:
    path = _cache_path(cost_model_dir, key)
    os.makedirs(cost_model_dir, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table.as_dict(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear_cache() -> None:
    """Drop the process-wide table cache (tests)."""
    _PROCESS_CACHE.clear()


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn, device: torch.device, repeat: int = 3) -> float:
    """Best-of-``repeat`` wall microseconds of ``fn()`` after one warm-up
    call, with the device synchronized after the warm-up and after every
    timed call (else a CUDA call times its enqueue). The warm-up may be
    the process's first use of a kernel, and then it builds the kernels
    (``kernels.build.last_build_seconds``)."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def calibrate(g, app, config, backend_name: str) -> DecisionTable:
    """Run the probe set on a pilot-sized slice of the real workload and
    return the measured-fastest table. An ordinary probe failure falls back
    to the static table — the cost model re-places a run, it must not break
    it. A kernel build error and a CUDA runtime error re-raise
    (``faults.is_fatal``): a fallback would hide the card or a kernel."""
    try:
        return _calibrate(g, app, config, backend_name)
    except Exception as exc:
        if faults.is_fatal(exc):
            raise
        return static_table(backend_name, g.device,
                            source="static:probe-error")


def _calibrate(g, app, config, backend_name: str) -> DecisionTable:
    from repro_torch.core import aggregation, canon_math, explore
    from repro_torch.core.runtime import programs
    from repro_torch.kernels import canonical_refine
    from repro_torch.kernels.aggregate import bin_rows

    dev = g.device
    on_card = dev.type == "cuda"
    table = static_table(backend_name, dev, source="calibrated")
    timings = table.timings
    mode = app.mode

    def time_us(fn):
        return _time_us(fn, dev)

    n0 = int(g.n if mode == "vertex" else g.m)
    if n0 <= 0:
        table.source = "static:empty-graph"
        return table

    # ---- pilot: one expand of a size-1 seed chunk ------------------------
    # Its children give every later probe a realistic frontier. On the
    # card it takes the kernel route (the only one the main path runs).
    rows = min(PROBE_CHUNK_ROWS, n0, max(int(config.chunk_size), 1))
    members = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    n_valid = torch.ones((rows,), dtype=torch.int32, device=dev)
    out_cap = min(
        PROBE_OUT_CAP,
        1 << max(0, (rows * max(int(g.max_degree), 1) - 1).bit_length()),
    )

    def expand_probe(up, ck, m=members, nv=n_valid, cap=out_cap):
        return explore.expand_and_compact(
            g, m, nv, mode, cap,
            use_pallas=up, fused=False, compact_kernel=ck,
        )

    children, count = expand_probe(on_card, on_card)[:2]
    childk = children.shape[1]
    n_children = int(count)

    # ---- probe 1: expand ladder -> use_pallas, compact_kernel ------------
    # On the card the kernel knobs stay on (the plain routes are the
    # tests' oracles, never the main path's): nothing to decide there.
    if not on_card:
        if n_children >= 8:
            lrows = min(n_children, out_cap, PROBE_CHUNK_ROWS)
            lm = children[:lrows]
            lnv = torch.full((lrows,), childk, dtype=torch.int32, device=dev)
            lcap = min(
                PROBE_OUT_CAP,
                1 << max(0, (lrows * max(int(g.max_degree), 1) - 1)
                         .bit_length()),
            )
        else:                   # degenerate graph: fall back to the seed
            lm, lnv, lcap = members, n_valid, out_cap
        ladder = [("jnp", False, False), ("pallas", True, False),
                  ("pallas+compact", True, True), ("jnp+compact", False, True)]
        best_name, best_us = None, float("inf")
        for name, up, ck in ladder:
            us = time_us(
                lambda up=up, ck=ck: expand_probe(up, ck, lm, lnv, lcap)
            )
            timings[f"expand.{name}"] = round(us, 1)
            if us < best_us:
                best_name, best_us = (up, ck), us
        # hysteresis: a kernel combo must beat the plain routes by a clear
        # margin to displace them
        if best_us >= EXPAND_HYSTERESIS * timings["expand.jnp"]:
            best_name = (False, False)
        table.use_pallas, table.compact_kernel = best_name

    if not app.wants_patterns:
        # nothing to aggregate: placement knobs are moot, and the fused
        # pipeline's only per-chunk cost is the device-resident count
        table.async_chunks = True
        return table

    # ---- pilot children -> real quick codes for the bin probes -----------
    nv_children = torch.where(
        torch.arange(out_cap, device=dev) < torch.clamp(count, max=out_cap),
        childk, 0,
    ).to(torch.int32)
    qp = programs.quick_patterns(g, mode, children, nv_children)
    codes, valid = qp.codes, nv_children > 0
    reps = -(-PROBE_BIN_ROWS // out_cap)
    codes_big = codes.repeat(reps, 1)[:PROBE_BIN_ROWS]
    valid_big = valid.repeat(reps)[:PROBE_BIN_ROWS]
    _sync(dev)
    cap = min(max(int(config.agg_qcap), 1), 4096)

    # ---- probe 2: bin ladder -> aggregate_bin, aggregate_kernel ----------
    cands = (
        [("sort", True), ("radix", True)] if on_card
        else [("sort", False), ("radix", False)]
    )
    best_bin, best_bin_us = None, float("inf")
    for method, uk in cands:
        us = time_us(lambda m=method, uk=uk: bin_rows(
            codes_big, valid_big, cap, use_kernel=uk, method=m,
        ))
        timings[f"bin.{method}{'.kernel' if uk else ''}"] = round(us, 1)
        if us < best_bin_us:
            best_bin, best_bin_us = (method, uk), us
    table.aggregate_bin, table.aggregate_kernel = best_bin

    # ---- probe 3: placement -> device_aggregate --------------------------
    # Device level 1 pays a per-chunk fold plus a weighted re-merge of the
    # carried table; the host path pays one per-superstep drain (transfer
    # + numpy unique over all rows). Compared per ROW.
    method, uk = best_bin
    fold_us = time_us(lambda: bin_rows(
        codes_big[:out_cap], valid_big[:out_cap], cap,
        use_kernel=uk, method=method,
    ))
    n_merge = min(2 * cap, codes_big.shape[0])
    w = torch.ones((n_merge,), dtype=torch.int64, device=dev)
    merge_us = time_us(lambda: bin_rows(
        codes_big[:n_merge], valid_big[:n_merge], cap, w,
        use_kernel=uk, method=method,
    ))

    def host_probe():
        c = codes_big.cpu().numpy()
        v = valid_big.cpu().numpy()
        cc = c[v]
        if cc.size:
            np.unique(cc, axis=0)

    host_us = time_us(host_probe)
    device_per_row = (fold_us + merge_us) / max(out_cap, 1)
    host_per_row = host_us / max(PROBE_BIN_ROWS, 1)
    timings["place.device_fold"] = round(fold_us, 1)
    timings["place.device_merge"] = round(merge_us, 1)
    timings["place.host_drain"] = round(host_us, 1)
    timings["place.device_per_row"] = round(device_per_row, 4)
    timings["place.host_per_row"] = round(host_per_row, 4)
    table.device_aggregate = device_per_row < host_per_row

    # ---- probe 4: pipeline shape -> async_chunks -------------------------
    # The chunk loop pays a host sync, a chunk upload and a separate
    # quick-pattern pass per chunk; the fused pipeline pays the carried-
    # partial fold when aggregating on the device, ~nothing otherwise.
    sync_us = time_us(lambda: count.item())
    host_members = members.cpu().numpy()
    upload_us = time_us(lambda: torch.as_tensor(host_members, device=dev))
    qp_us = time_us(lambda: programs.quick_patterns(
        g, mode, children, nv_children
    ))
    legacy_tax = sync_us + upload_us + qp_us
    fused_tax = (fold_us + merge_us) if table.device_aggregate else 0.0
    timings["async.sync"] = round(sync_us, 1)
    timings["async.upload"] = round(upload_us, 1)
    timings["async.quick_patterns"] = round(qp_us, 1)
    timings["async.legacy_chunk_tax"] = round(legacy_tax, 1)
    timings["async.fused_chunk_tax"] = round(fused_tax, 1)
    table.async_chunks = fused_tax <= legacy_tax

    # ---- probe 5: level-2 placement -> canonical_placement ---------------
    # The device refine of the distinct codes (upload + refine + drain)
    # against the memo-cold host batch; the device wins on raw speed, else
    # the host batch overlaps the next superstep (host_async) where the
    # app allows a deferred table, else stays synchronous.
    c_np = codes.cpu().numpy()[valid.cpu().numpy()]
    u = np.unique(c_np, axis=0) if len(c_np) else c_np.reshape(0, 3)
    if len(u):
        device_us = time_us(lambda: canonical_refine.canonicalize_on_device(
            u, use_kernel=table.aggregate_kernel, device=dev,
        ))

        def host_canon():
            by_nv: Dict[int, list] = {}
            for i in range(len(u)):
                by_nv.setdefault(int(u[i, 0]) & 0xF, []).append(i)
            for js in by_nv.values():
                canon_math._canonicalize_batch(u[js])

        host_us = time_us(host_canon)
        timings["canon.device"] = round(device_us, 1)
        timings["canon.host"] = round(host_us, 1)
        if device_us < host_us:
            table.canonical_placement = "device"
        elif table.device_aggregate and aggregation.async_level2_ok(app):
            # host_async only exists on the device-aggregation path
            table.canonical_placement = "host_async"
        else:
            table.canonical_placement = "host"
    return table


# ---------------------------------------------------------------------------
# resolution: the one entry point (ExecutionBackend.bind)
# ---------------------------------------------------------------------------

def resolve(config, g, app, backend_name: str):
    """Resolve every unset knob of ``config`` to a concrete choice for the
    device ``g`` lives on.

    Returns ``(concrete_config, table)``: a config copy whose
    ``DECIDED_KNOBS`` are all concrete, and the effective decision table
    (user overrides folded in) for ``RunStats``/trace recording."""
    mode = getattr(config, "cost_model", "auto")
    if mode not in COST_MODEL_MODES:
        raise ValueError(
            f"unknown cost_model {mode!r} (expected one of {COST_MODEL_MODES})"
        )
    if mode == "off":
        table = static_table(backend_name, g.device, source="forced:off")
    elif mode != "auto":
        table = forced_table(mode, backend_name, g.device)
    elif int(g.m) < int(config.cost_model_min_edges):
        table = static_table(backend_name, g.device)
    else:
        from repro_torch.core.runtime import checkpoint

        key = cache_key(
            backend_name, g.device.type,
            checkpoint.app_fingerprint(app), checkpoint.graph_fingerprint(g),
            config_signature(config),
        )
        table = _PROCESS_CACHE.get(key)
        if table is None and config.cost_model_dir:
            table = _load_cached(config.cost_model_dir, key)
        if table is None:
            table = calibrate(g, app, config, backend_name)
            if config.cost_model_dir and table.source == "calibrated":
                _save_cached(config.cost_model_dir, key, table)
        _PROCESS_CACHE[key] = table

    # explicit config knobs always win; the returned table reflects the
    # EFFECTIVE choices (overrides folded in) without poisoning the cache
    table = table.copy()
    concrete = {}
    for knob in DECIDED_KNOBS:
        user = getattr(config, knob)
        if user is None:
            concrete[knob] = getattr(table, knob)
        else:
            concrete[knob] = user
            setattr(table, knob, user)
            table.timings[f"override.{knob}"] = 1
    return dataclasses.replace(config, **concrete), table
