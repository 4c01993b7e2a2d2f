"""Superstep-granular checkpoint/resume for the mining runtime (DESIGN.md
§9), port of ``repro.core.runtime.checkpoint``.

Because sealed frontier stores are the *only* inter-superstep state
(DESIGN.md §7), a mining checkpoint is tiny and exact: {sealed store
payload (raw rows, or the ODAG's per-level domains + connectivity
bitmaps), the patterns/aggregates/stats accumulated so far, the superstep
cursor (next step, embedding size, capacity bucket), and app + graph
fingerprints}. It is written atomically at the seal boundary, so a resumed
run replays nothing and recomputes only the carried level-1 state
(identical by construction).

The file format is the reference's: one ``.npz`` with the same array
keys, a JSON meta string and a SHA-256 of the payload inside the same
atomic file. Everything in it is host numpy: the store's ``state_dict``
copies the sealed rows off the device at the seal, and the graph's
fingerprint copies its content arrays to the host once, when a
:class:`Checkpointer` binds.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import obs
from repro_torch.core.aggregation import StepAggregates
from repro_torch.core.graph import DeviceGraph
from repro_torch.core.stats import StepStats

#: v2 embeds a SHA-256 payload checksum (DESIGN.md §13) — v1 checkpoints
#: (no integrity record) are rejected as corrupt rather than trusted.
CHECKPOINT_VERSION = 2
_FILE_RE = re.compile(r"^ckpt-step(\d+)\.npz$")
#: the staging-file shape ``save`` writes before ``os.replace`` — a crash
#: mid-``np.savez`` leaves exactly one of these behind (swept on resume and
#: Checkpointer init, never loadable as a checkpoint)
_TMP_RE = re.compile(r"^ckpt-step\d+\.npz\.tmp-.*\.npz$")


class CheckpointCorruptError(ValueError):
    """A checkpoint file exists but cannot be trusted: unreadable archive,
    missing integrity record, or SHA-256 payload mismatch. The supervisor
    (``run_supervised``) treats this as "roll back one cut", never as a
    fatal config error."""


# ---------------------------------------------------------------------------
# fingerprints: a checkpoint only resumes against the run that wrote it
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a contiguous host array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(t))


def graph_fingerprint(g) -> str:
    """Content hash of the mined graph (labels + edges + edge labels), the
    reference's hash of the same integers.

    Deliberately *layout-independent*: ``DeviceGraph`` and any
    ``PartitionedGraph`` of the same graph hash identically (the content
    arrays are the identity; shard tables are derived data). The layout
    that *wrote* a checkpoint is recorded separately (:func:`graph_layout`,
    in the meta). Copies the three arrays to the host."""
    h = hashlib.sha1()
    for arr in (g.labels, g.edge_uv, g.edge_labels):
        a = _host(arr)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def graph_layout(g) -> str:
    """The partition layout a run mines under, recorded in every
    checkpoint's fingerprint block: ``"replicated"`` for a ``DeviceGraph``,
    else ``partitioned:w=<parts>:rows=<padded rows>:off=<boundary hash>``.
    Informational for restore (the content fingerprint gates validity)."""
    off = getattr(g, "part_offsets", None)
    if off is None:
        return "replicated"
    off = _host(off)
    return (
        f"partitioned:w={len(off) - 1}:rows={int(g.tile_rows)}"
        f":off={hashlib.sha1(off.tobytes()).hexdigest()[:12]}"
    )


def app_fingerprint(app) -> str:
    """Identity of the app: class + dataclass fields. The class's module
    is part of it, so a port app never matches a JAX-package checkpoint."""
    if dataclasses.is_dataclass(app):
        fields = {
            f.name: repr(getattr(app, f.name))
            for f in dataclasses.fields(app)
        }
    else:  # non-dataclass apps: best effort over the instance dict
        fields = {k: repr(v) for k, v in sorted(vars(app).items())}
    payload = json.dumps(
        [type(app).__module__, type(app).__qualname__, fields], sort_keys=True
    )
    return hashlib.sha1(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# on-disk format: one .npz per checkpoint, meta as an embedded JSON string
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointState:
    """Everything a resumed run needs, already deserialised."""

    step: int                      # next superstep index to execute
    size: int                      # embedding size of the sealed frontier
    capacity: int                  # persistent output-capacity bucket
    wall_time: float               # wall clock accumulated before the cut
    patterns: Dict[tuple, int]
    embeddings: Dict[int, np.ndarray]
    aggregates: List[StepAggregates]
    stats_steps: List[StepStats]
    store_state: dict              # FrontierStore.state_dict() payload
    graph_fp: str
    app_fp: str
    #: partition layout of the writing run (informational; resume under a
    #: different layout re-partitions — content fp is what gates validity)
    graph_layout: str = "replicated"


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-step{step:04d}.npz")


def list_checkpoints(directory: str) -> List[str]:
    """All checkpoint files in ``directory``, newest (highest step) first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    found = []
    for name in names:
        m = _FILE_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return [p for _, p in sorted(found, reverse=True)]


def latest_checkpoint(directory: str) -> Optional[str]:
    """The highest-step checkpoint file in ``directory`` (None if empty)."""
    paths = list_checkpoints(directory)
    return paths[0] if paths else None


def sweep_stale_tmp(directory: str) -> List[str]:
    """Remove orphaned ``*.tmp-*.npz`` staging files a crash mid-save left
    behind (``os.replace`` never ran, so they are garbage by construction).
    Returns the removed paths. Called on Checkpointer init and on every
    directory resume."""
    removed: List[str] = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return removed
    for name in names:
        if _TMP_RE.match(name):
            path = os.path.join(directory, name)
            try:
                os.unlink(path)
            except OSError:  # pragma: no cover - raced by another sweeper
                continue
            removed.append(path)
    return removed


def _payload_checksum(arrays: Dict[str, np.ndarray]) -> str:
    """SHA-256 over every payload array (sorted by name; name + shape +
    dtype + raw bytes). The ``checksum`` entry itself is excluded — it IS
    the digest, stored inside the same atomic .npz."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == "checksum":
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save(path: str, state: CheckpointState) -> None:
    """Atomic single-file write: everything lands in one ``np.savez`` (no
    pickle — arrays plus one JSON meta string), staged next to the target
    and ``os.replace``d so a crash mid-write never leaves a torn
    checkpoint behind."""
    arrays: Dict[str, np.ndarray] = {}
    if state.patterns:
        arrays["pat_codes"] = np.asarray(
            [list(code) for code in state.patterns], dtype=np.int64
        )
        arrays["pat_values"] = np.asarray(
            list(state.patterns.values()), dtype=np.int64
        )
    for size, emb in state.embeddings.items():
        arrays[f"emb{int(size)}"] = np.asarray(emb, dtype=np.int32)
    agg_meta = []
    for i, agg in enumerate(state.aggregates):
        arrays[f"agg{i}_canon"] = np.asarray(agg.canon_codes, dtype=np.int64)
        arrays[f"agg{i}_counts"] = np.asarray(agg.counts, dtype=np.int64)
        arrays[f"agg{i}_supports"] = np.asarray(agg.supports, dtype=np.int64)
        agg_meta.append([agg.n_quick, agg.n_canonical, agg.n_iso_checks])
    for name, arr in state.store_state["arrays"].items():
        arrays[f"store_{name}"] = np.asarray(arr)
    meta = {
        "version": CHECKPOINT_VERSION,
        "step": int(state.step),
        "size": int(state.size),
        "capacity": int(state.capacity),
        "wall_time": float(state.wall_time),
        "graph_fp": state.graph_fp,
        "app_fp": state.app_fp,
        "graph_layout": state.graph_layout,
        "emb_sizes": sorted(int(s) for s in state.embeddings),
        "n_aggregates": len(state.aggregates),
        "agg_meta": agg_meta,
        "stats": [dataclasses.asdict(s) for s in state.stats_steps],
        "store": {
            "kind": state.store_state["kind"],
            "meta": state.store_state["meta"],
            "array_keys": sorted(state.store_state["arrays"]),
        },
    }
    arrays["meta"] = np.asarray(json.dumps(meta))
    # integrity record (DESIGN.md §13): rides inside the same atomic file,
    # so a torn/bit-flipped payload can never verify
    arrays["checksum"] = np.asarray(_payload_checksum(arrays))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - only on a failed write
            os.unlink(tmp)


def verify(path: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint's raw arrays and verify the embedded SHA-256.
    Raises :class:`CheckpointCorruptError` on an unreadable archive, a
    missing integrity record, or a digest mismatch."""
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {key: np.asarray(z[key]) for key in z.files}
    except FileNotFoundError:
        # a missing file is a caller error (bad path), not corruption —
        # rollback must never silently skip past a typo'd checkpoint
        raise
    except (zipfile.BadZipFile, OSError, EOFError, KeyError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint {path}: {e}"
        ) from e
    if "checksum" not in arrays:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no integrity record (pre-v2 or torn)"
        )
    want = str(arrays["checksum"][()])
    got = _payload_checksum(arrays)
    if want != got:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed checksum "
            f"(stored {want[:12]} != computed {got[:12]})"
        )
    return arrays


def load(path: str) -> CheckpointState:
    z = verify(path)
    try:
        meta = json.loads(str(z["meta"][()]))
    except (KeyError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"bad meta in {path}: {e}") from e
    if meta["version"] != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {meta['version']} != "
            f"{CHECKPOINT_VERSION} ({path})"
        )
    patterns: Dict[tuple, int] = {}
    if "pat_codes" in z:
        codes, values = z["pat_codes"], z["pat_values"]
        patterns = {
            tuple(int(x) for x in codes[i]): int(values[i])
            for i in range(len(codes))
        }
    embeddings = {
        int(s): np.asarray(z[f"emb{int(s)}"]) for s in meta["emb_sizes"]
    }
    aggregates = [
        StepAggregates(
            canon_codes=np.asarray(z[f"agg{i}_canon"]),
            counts=np.asarray(z[f"agg{i}_counts"]),
            supports=np.asarray(z[f"agg{i}_supports"]),
            n_quick=int(meta["agg_meta"][i][0]),
            n_canonical=int(meta["agg_meta"][i][1]),
            n_iso_checks=int(meta["agg_meta"][i][2]),
        )
        for i in range(meta["n_aggregates"])
    ]
    store_state = {
        "kind": meta["store"]["kind"],
        "meta": meta["store"]["meta"],
        "arrays": {
            key: np.asarray(z[f"store_{key}"])
            for key in meta["store"]["array_keys"]
        },
    }
    return CheckpointState(
        step=int(meta["step"]),
        size=int(meta["size"]),
        capacity=int(meta["capacity"]),
        wall_time=float(meta["wall_time"]),
        patterns=patterns,
        embeddings=embeddings,
        aggregates=aggregates,
        stats_steps=[StepStats(**d) for d in meta["stats"]],
        store_state=store_state,
        graph_fp=meta["graph_fp"],
        app_fp=meta["app_fp"],
        graph_layout=meta.get("graph_layout", "replicated"),
    )


def load_for(checkpoint: Optional[str], g: DeviceGraph, app) -> CheckpointState:
    """Resolve + load + fingerprint-verify a checkpoint for (graph, app).

    ``checkpoint`` may be a file, a directory (latest checkpoint in it
    wins), or None (error). Raises ``ValueError`` when the checkpoint was
    written against a different graph or app — resuming would silently mix
    two runs' patterns otherwise."""
    if checkpoint is None:
        raise ValueError("no checkpoint given (and no checkpoint_dir set)")
    path = checkpoint
    if os.path.isdir(path):
        sweep_stale_tmp(path)
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {checkpoint!r}")
    state = load(path)
    gfp = graph_fingerprint(g)
    if state.graph_fp != gfp:
        raise ValueError(
            f"checkpoint {path} was written for a different graph "
            f"({state.graph_fp[:12]} != {gfp[:12]})"
        )
    afp = app_fingerprint(app)
    if state.app_fp != afp:
        raise ValueError(
            f"checkpoint {path} was written for a different app config "
            f"({state.app_fp[:12]} != {afp[:12]})"
        )
    return state


def load_latest_valid(
    directory: str, g: DeviceGraph, app
) -> Tuple[Optional[CheckpointState], Optional[str], List[str]]:
    """Roll back past corrupt cuts (DESIGN.md §13): walk the directory's
    checkpoints newest-first, skip any that fail the SHA-256 verify, and
    return ``(state, path, skipped)`` for the newest *valid* one —
    ``(None, None, skipped)`` when no checkpoint survives. Fingerprint
    mismatches (wrong graph/app) still raise: that is a config error, not
    a fault to retry past. Stale tmp staging files are swept first."""
    sweep_stale_tmp(directory)
    skipped: List[str] = []
    for path in list_checkpoints(directory):
        try:
            state = load(path)
        except CheckpointCorruptError:
            skipped.append(path)
            continue
        gfp = graph_fingerprint(g)
        if state.graph_fp != gfp:
            raise ValueError(
                f"checkpoint {path} was written for a different graph "
                f"({state.graph_fp[:12]} != {gfp[:12]})"
            )
        afp = app_fingerprint(app)
        if state.app_fp != afp:
            raise ValueError(
                f"checkpoint {path} was written for a different app config "
                f"({state.app_fp[:12]} != {afp[:12]})"
            )
        return state, path, skipped
    return None, None, skipped


class Checkpointer:
    """Writes one checkpoint per seal boundary the cadence selects."""

    def __init__(self, config, g, app) -> None:
        self.directory = config.checkpoint_dir
        # the one host copy of the graph's content arrays of the run
        self.graph_fp = graph_fingerprint(g)
        self.graph_layout = graph_layout(g)
        self.app_fp = app_fingerprint(app)
        #: keep-last-K retention (0 = keep everything); K >= 2 leaves a
        #: rollback target when the newest cut fails its checksum
        self.keep = int(getattr(config, "keep_checkpoints", 0) or 0)
        os.makedirs(self.directory, exist_ok=True)
        sweep_stale_tmp(self.directory)

    def save(self, *, step: int, size: int, capacity: int, store, result,
             wall_time: float) -> float:
        """Persist the cut after a sealed superstep; returns seconds spent
        (charged to ``StepStats.t_checkpoint``)."""
        t0 = time.perf_counter()
        state = CheckpointState(
            step=step,
            size=size,
            capacity=capacity,
            wall_time=wall_time,
            patterns=result.patterns,
            embeddings=result.embeddings,
            aggregates=result.aggregates,
            stats_steps=result.stats.steps,
            store_state=store.state_dict(),
            graph_fp=self.graph_fp,
            app_fp=self.app_fp,
            graph_layout=self.graph_layout,
        )
        path = checkpoint_path(self.directory, step)
        save(path, state)
        if self.keep > 0:
            for old in list_checkpoints(self.directory)[self.keep:]:
                try:
                    os.unlink(old)
                except OSError:  # pragma: no cover - raced removal
                    pass
        # checkpoint size as a metrics gauge (DESIGN.md §12) — the traced
        # run's counter track shows the persisted cut growing per cadence
        obs.gauge("checkpoint_bytes", os.path.getsize(path), step=step)
        return time.perf_counter() - t0
