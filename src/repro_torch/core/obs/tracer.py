"""Low-overhead span tracer of the observability layer (DESIGN.md §12),
port of ``repro.core.obs.tracer``.

One :class:`Tracer` collects host-side *spans* — named, nested, attributed
wall-time intervals (``superstep`` > ``expand`` > ...) — from every layer
of the runtime through the module-level helpers in
``repro_torch.core.obs``. Design constraints, in order:

  * **no device sync when disabled** (the default): :func:`span` returns a
    shared ``nullcontext`` when no tracer is installed, and :func:`fence`
    is a no-op unless the installed tracer was built with ``sync=True``.
  * **honest phase boundaries are opt-in**: CUDA launches are
    asynchronous, so a host ``perf_counter`` lap at a phase boundary
    measures the enqueue, not device completion. ``Tracer(sync=True)``
    (``RunConfig.trace_sync``) makes ``fence(*trees)`` synchronize the
    CUDA devices of the passed tensors: blocking boundaries exist ONLY
    under ``trace_sync=True``.
  * **thread safety**: span stacks are thread-local (nesting is per
    thread, matching Chrome trace ``tid`` semantics) and the event list is
    lock-guarded, so the ``host_async`` level-2 thread can trace into the
    same run.

Timestamps are microseconds since the tracer's epoch (``perf_counter``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

import torch


@dataclasses.dataclass
class Span:
    """One closed span: a Chrome-trace complete ("X") event's worth."""

    name: str
    ts: float                 # µs since the tracer epoch
    dur: float                # µs
    tid: int                  # small per-tracer thread index
    depth: int                # nesting depth on its thread (0 = root)
    parent: Optional[str]     # enclosing span's name (None at depth 0)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CounterSample:
    """One point of a named counter track (Chrome "C" event)."""

    name: str
    ts: float                 # µs since the tracer epoch
    values: Dict[str, float]


def _cuda_devices(obj, found: Set[torch.device], depth: int = 0) -> bool:
    """Collect the CUDA devices of the tensors in ``obj`` (tensors, and
    tuples, lists, dicts and plain objects holding them, three levels
    deep); True when ``obj`` is not None."""
    if obj is None:
        return False
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            found.add(obj.device)
    elif depth < 3:
        if isinstance(obj, dict):
            items = obj.values()
        elif isinstance(obj, (tuple, list)):
            items = obj
        else:
            items = getattr(obj, "__dict__", {}).values()
        for item in items:
            _cuda_devices(item, found, depth + 1)
    return True


def _synchronize(*trees) -> bool:
    """Synchronize every CUDA device holding a tensor of ``trees``;
    True when any tree was not None (a CPU tensor is complete already)."""
    found: Set[torch.device] = set()
    given = False
    for tree in trees:
        given |= _cuda_devices(tree, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    return given


class Tracer:
    """Collects spans + counter samples for one (or more) mining runs."""

    def __init__(self, sync: bool = False,
                 on_close: Optional[Callable[[Span], None]] = None) -> None:
        self.sync = bool(sync)
        self.on_close = on_close
        self.epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        #: fences that actually blocked — the overhead-guard observable
        self.n_fences = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}

    # -- internals -----------------------------------------------------------
    def _now(self) -> float:
        return (time.perf_counter() - self.epoch) * 1e6

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    # -- recording -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = self._now()
        try:
            yield
        finally:
            t1 = self._now()
            stack.pop()
            sp = Span(
                name=name, ts=t0, dur=t1 - t0,
                tid=self._tid(), depth=len(stack), parent=parent,
                args=attrs,
            )
            with self._lock:
                self.spans.append(sp)
            if self.on_close is not None:
                self.on_close(sp)

    def counter(self, name: str, **values) -> None:
        sample = CounterSample(
            name=name, ts=self._now(),
            values={k: float(v) for k, v in values.items()},
        )
        with self._lock:
            self.counters.append(sample)

    def fence(self, *trees) -> None:
        """Synchronize the CUDA devices of the passed tensors — ONLY when
        this tracer was built with ``sync=True`` (``trace_sync``)."""
        if not self.sync:
            return
        if _synchronize(*trees):
            self.n_fences += 1


# -- the installed tracer (module-level, what the runtime layers talk to) ----

_TRACER: Optional[Tracer] = None
#: shared reusable no-op context — the whole disabled-path cost of span()
_NULL = contextlib.nullcontext()


def install(tracer: Optional[Tracer]) -> None:
    """Make ``tracer`` the process's current tracer (None uninstalls).
    Last-install-wins, as in the reference."""
    global _TRACER
    _TRACER = tracer


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **attrs):
    """A tracer span when tracing is on; a shared nullcontext otherwise."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.span(name, **attrs)


def fence(*trees) -> None:
    """Phase-boundary device fence: blocks only under an installed
    ``sync=True`` tracer (the ``trace_sync`` contract); no-op — and no
    device touch — in every other configuration."""
    t = _TRACER
    if t is not None and t.sync:
        t.fence(*trees)


def sync_active() -> bool:
    """True iff an installed tracer asked for blocking phase boundaries."""
    t = _TRACER
    return t is not None and t.sync


def probe_time(fn, *args) -> float:
    """Run a probe twice — once to warm up, once timed to completion — and
    return the timed seconds: ``fn(*args)``, synchronize, then the timed
    call and a synchronize of the devices of its arguments and result.
    The ``trace_sync`` gather probe (``StepStats.t_gather``) uses it: the
    tile gather runs inside the chunk program, so separating it costs a
    probe, which only the diagnostic sync mode pays."""
    _synchronize(fn(*args), args)
    t0 = time.perf_counter()
    _synchronize(fn(*args), args)
    return time.perf_counter() - t0


def annotate(name: str):
    """A ``torch.profiler.record_function`` range aligning the profiler's
    timeline with the host span taxonomy — created only while a tracer is
    installed (the disabled path never touches profiler machinery)."""
    if _TRACER is None:
        return _NULL
    return torch.profiler.record_function(name)
