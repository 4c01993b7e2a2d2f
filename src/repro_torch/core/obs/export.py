"""Exporters of the observability layer: Chrome trace JSON, JSONL, step log
(port of ``repro.core.obs.export``).

Three renderings of one traced run (DESIGN.md §12):

  * :func:`write_chrome_trace` — the Chrome trace-event format
    (``{"traceEvents": [...]}``), loadable directly in Perfetto /
    ``chrome://tracing``: every closed span becomes a complete ("X")
    event, counters become "C" tracks, plus "M" metadata naming the
    process/threads.
  * a JSONL event stream (one JSON object per closed span / step record,
    flushed at superstep boundaries) for live ``tail -f`` while a run
    mines.
  * :func:`step_log_line` — the per-superstep one-line structured progress
    log (frontier size, chunks, syncs, compression, bytes-to-host, phase
    walls) behind ``RunConfig.log_every``.

:class:`RunObserver` is the loop-facing bundle: it owns the tracer +
registry for one run, installs them for the run's duration, and writes
the export files at the end.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from repro_torch.core.obs import metrics as metrics_lib
from repro_torch.core.obs import tracer as tracer_lib

#: the host phase-span taxonomy (children of "superstep"; DESIGN.md §12)
PHASES = (
    "materialize", "aggregate", "alpha", "expand", "seal", "checkpoint",
)

_PID = os.getpid()
_SEQ_LOCK = threading.Lock()
_SEQ = [0]


def _next_seq() -> int:
    with _SEQ_LOCK:
        _SEQ[0] += 1
        return _SEQ[0]


# -- Chrome trace-event rendering ---------------------------------------------

def chrome_trace_events(tracer: tracer_lib.Tracer) -> List[Dict]:
    """Render a tracer's spans + counters as Chrome trace events."""
    events: List[Dict] = [
        {
            "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
            "args": {"name": "repro-arabesque superstep runtime"},
        }
    ]
    for tid in sorted({sp.tid for sp in tracer.spans} | {0}):
        events.append({
            "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
            "args": {"name": "main" if tid == 0 else f"thread-{tid}"},
        })
    for sp in tracer.spans:
        args = {k: _jsonable(v) for k, v in sp.args.items()}
        args["depth"] = sp.depth
        if sp.parent is not None:
            args["parent"] = sp.parent
        events.append({
            "ph": "X", "name": sp.name,
            "ts": round(sp.ts, 3), "dur": round(sp.dur, 3),
            "pid": _PID, "tid": sp.tid, "cat": "host",
            "args": args,
        })
    for cs in tracer.counters:
        events.append({
            "ph": "C", "name": cs.name, "ts": round(cs.ts, 3),
            "pid": _PID, "tid": 0, "args": dict(cs.values),
        })
    return events


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def write_chrome_trace(path: str, tracer: tracer_lib.Tracer,
                       registry: Optional[metrics_lib.MetricsRegistry] = None,
                       meta: Optional[Dict] = None) -> str:
    doc = {
        "traceEvents": chrome_trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": dict(meta or {}),
    }
    if registry is not None:
        doc["otherData"]["metrics"] = registry.snapshot()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_chrome_trace(doc) -> List[str]:
    """Schema check of an exported trace: returns the list of problems
    (empty == valid). Enforced fields per event kind: "X" spans need
    ``name/ph/ts/dur/pid/tid``, "M"/"C" need ``name/ph/pid/tid`` (+ ts for
    counters) — the subset Perfetto's importer requires."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a Chrome trace: missing top-level 'traceEvents'"]
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["empty traceEvents"]
    if not any(e.get("ph") == "X" for e in events):
        problems.append("no complete ('X') span events")
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "M", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        need = ("name", "ph", "ts", "dur", "pid", "tid") if ph == "X" else (
            ("name", "ph", "ts", "pid", "tid") if ph == "C"
            else ("name", "ph", "pid", "tid")
        )
        for k in need:
            if k not in e:
                problems.append(f"event {i} ({ph}/{e.get('name')}): no {k!r}")
        if ph == "X" and "dur" in e and float(e["dur"]) < 0:
            problems.append(f"event {i} ({e.get('name')}): negative dur")
    return problems


def phase_coverage(doc) -> Dict[str, float]:
    """How much of the superstep wall the named phase spans account for:
    ``covered`` = Σ dur of PHASES spans whose parent is "superstep",
    ``total`` = Σ dur of "superstep" spans, ``coverage`` their ratio
    (1.0 when there are no supersteps — nothing to cover)."""
    total = covered = 0.0
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        if e["name"] == "superstep":
            total += float(e["dur"])
        elif (
            e["name"] in PHASES
            and e.get("args", {}).get("parent") == "superstep"
        ):
            covered += float(e["dur"])
    return {
        "total_us": total,
        "covered_us": covered,
        "coverage": (covered / total) if total > 0 else 1.0,
    }


# -- per-superstep progress log -----------------------------------------------

def step_log_line(st) -> str:
    """One structured line per superstep (``RunConfig.log_every``)."""
    return (
        f"step={st.step} size={st.size} frontier={st.n_frontier}"
        f" children={st.n_children} chunks={st.n_chunks}"
        f" syncs={st.n_host_syncs} compression={st.compression:.1f}"
        f" bytes_to_host={st.bytes_to_host}"
        f" collective_bytes={st.collective_bytes}"
        f" t_storage={st.t_storage:.4f} t_aggregate={st.t_aggregate:.4f}"
        f" t_expand={st.t_expand:.4f} t_gather={st.t_gather:.4f}"
        f" t_exchange={st.t_exchange:.4f} t_checkpoint={st.t_checkpoint:.4f}"
    )


def _step_record(st) -> Dict:
    return {
        "event": "superstep",
        "step": st.step, "size": st.size,
        "n_frontier": st.n_frontier, "n_children": st.n_children,
        "n_chunks": st.n_chunks, "n_host_syncs": st.n_host_syncs,
        "compression": round(st.compression, 3),
        "bytes_to_host": st.bytes_to_host,
        "collective_bytes": st.collective_bytes,
        "t_storage": st.t_storage, "t_aggregate": st.t_aggregate,
        "t_expand": st.t_expand, "t_gather": st.t_gather,
        "t_exchange": st.t_exchange, "t_checkpoint": st.t_checkpoint,
        "n_retries": st.n_retries, "t_recovery": st.t_recovery,
    }


def _span_record(sp: tracer_lib.Span) -> Dict:
    return {
        "event": "span", "name": sp.name, "ts_us": round(sp.ts, 3),
        "dur_us": round(sp.dur, 3), "tid": sp.tid, "depth": sp.depth,
        "parent": sp.parent,
        "args": {k: _jsonable(v) for k, v in sp.args.items()},
    }


class _JsonlWriter:
    """Append-only JSONL sink, opened lazily.

    Span records are buffered raw (no serialisation on the write path);
    superstep records serialise + flush everything accumulated so far —
    so ``tail -f`` sees whole supersteps as they complete, while closing
    a span inside the loop costs a list append, not ``json.dumps`` or
    file I/O (both showed up as >5% of sub-millisecond supersteps' wall,
    failing the coverage gate on warm tiny runs)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = None
        self._buf: List[Dict] = []
        self._lock = threading.Lock()

    def write(self, obj: Dict, flush: bool = False) -> None:
        with self._lock:
            self._buf.append(obj)
            if flush:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "w")
        for obj in self._buf:
            if isinstance(obj, tracer_lib.Span):
                obj = _span_record(obj)
            self._f.write(json.dumps(obj) + "\n")
        self._buf.clear()
        self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._buf:
                self._flush_locked()
            if self._f is not None:
                self._f.close()
                self._f = None


# -- the loop-facing bundle ---------------------------------------------------

class RunObserver:
    """Owns the tracer/registry/exporters for ONE mining run.

    Built unconditionally by the runtime loop; every method is a cheap
    no-op when neither ``trace`` nor ``log_every`` asked for anything —
    the observability layer's disabled cost is this object's allocation
    per run. ``device`` is the run's device: its allocator's bytes in use
    are sampled once a step while tracing (CUDA only)."""

    def __init__(self, config, backend_name: str = "", device=None) -> None:
        self.config = config
        self.backend_name = backend_name
        self.device = device
        self.enabled = bool(config.trace)
        self.log_every = int(config.log_every or 0)
        self.tracer: Optional[tracer_lib.Tracer] = None
        self.registry: Optional[metrics_lib.MetricsRegistry] = None
        self.trace_path: Optional[str] = None
        self._jsonl: Optional[_JsonlWriter] = None
        self._finished = False
        if self.enabled:
            self.registry = metrics_lib.MetricsRegistry()
            on_close = None
            if config.trace_dir is not None:
                base = os.path.join(
                    config.trace_dir, f"run-{_PID}-{_next_seq():04d}"
                )
                self.trace_path = base + ".trace.json"
                self._jsonl = _JsonlWriter(base + ".events.jsonl")
                on_close = self._span_closed
            self.tracer = tracer_lib.Tracer(
                sync=bool(config.trace_sync), on_close=on_close
            )

    def _span_closed(self, sp: tracer_lib.Span) -> None:
        # hot path (fires inside the superstep span): a buffered append —
        # the JSON rendering is deferred to the next step-boundary flush
        self._jsonl.write(sp)

    # -- run lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self.enabled:
            tracer_lib.install(self.tracer)
            metrics_lib.install(self.registry)

    def step_done(self, st) -> None:
        """Called once per appended StepStats: counter tracks + progress log."""
        if self.tracer is not None:
            self.tracer.counter(
                "frontier", rows=st.n_frontier, children=st.n_children
            )
            self.tracer.counter(
                "bytes", to_host=st.bytes_to_host,
                collective=st.collective_bytes,
            )
            self.tracer.counter("host_syncs", syncs=st.n_host_syncs)
            mem = metrics_lib.sample_device_memory(self.device)
            if mem is not None:
                metrics_lib.gauge("device_bytes_in_use", mem, step=st.step)
                self.tracer.counter("device_memory", bytes_in_use=mem)
        if self._jsonl is not None:
            self._jsonl.write(_step_record(st), flush=True)
        if self.log_every and st.step % self.log_every == 0:
            print(f"[obs] {step_log_line(st)}", flush=True)

    def finish(
        self, wall_time: float = 0.0, aborted: bool = False
    ) -> Optional[str]:
        """Uninstall + export. Returns the written trace path (or None).
        Idempotent — the loop's finally block may call it after a normal
        finish (no-op) or on an exception (exports the partial trace).
        ``aborted=True`` marks the export as a partial trace of a run
        that died mid-superstep (``otherData["aborted"]``): the spans that
        closed by exception unwinding are all flushed, and a coverage gate
        (the reference's ``render_trace.py --check``) skips it: an aborted
        superstep legitimately has uncovered wall."""
        if not self.enabled or self._finished:
            return self.trace_path if self.enabled else None
        self._finished = True
        if tracer_lib.current() is self.tracer:
            tracer_lib.install(None)
        if metrics_lib.current() is self.registry:
            metrics_lib.install(None)
        if self._jsonl is not None:
            if aborted:
                self._jsonl.write({"event": "aborted"}, flush=True)
            self._jsonl.close()
        if self.trace_path is not None:
            meta = {
                "backend": self.backend_name,
                "wall_time_s": round(float(wall_time), 6),
                "trace_sync": bool(self.config.trace_sync),
            }
            if aborted:
                meta["aborted"] = True
            write_chrome_trace(
                self.trace_path, self.tracer, self.registry, meta=meta
            )
        return self.trace_path
