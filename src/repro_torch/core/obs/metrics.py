"""Metrics registry + the single write path for StepStats counters, port of
``repro.core.obs.metrics``.

Every ``st.bytes_to_host += ...`` / ``st.n_host_syncs += 1`` site routes
through :func:`count` / :func:`set_stat`, which

  * perform **exactly** the arithmetic the inline mutation would
    (``setattr(st, name, getattr(st, name) + value)``), so every
    ``StepStats`` counter is bit-identical whether or not anything is
    observing, and
  * mirror the update into the installed :class:`MetricsRegistry` (when
    one is installed) as named counters/gauges.

The disabled path is one module-level read + the unchanged setattr.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch


class MetricsRegistry:
    """Named counters, gauges, and distributions for one traced run.

    ``counters``  accumulate (run totals per name);
    ``gauges``    keep the last value and the max watermark;
    ``dists``     keep (count, sum, min, max) summaries.
    Thread-safe — same contract as the tracer.
    """

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.gauge_max: Dict[str, float] = {}
        self.dists: Dict[str, Tuple[int, float, float, float]] = {}
        #: per-step counter history: name -> [(step, value), ...]
        self.by_step: Dict[str, List[Tuple[int, float]]] = {}
        self._lock = threading.Lock()

    def count(self, name: str, value, step: Optional[int] = None) -> None:
        v = float(value)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + v
            if step is not None:
                self.by_step.setdefault(name, []).append((int(step), v))

    def gauge(self, name: str, value, step: Optional[int] = None) -> None:
        v = float(value)
        with self._lock:
            self.gauges[name] = v
            if v > self.gauge_max.get(name, float("-inf")):
                self.gauge_max[name] = v
            if step is not None:
                self.by_step.setdefault(name, []).append((int(step), v))

    def observe(self, name: str, value) -> None:
        v = float(value)
        with self._lock:
            n, s, lo, hi = self.dists.get(name, (0, 0.0, v, v))
            self.dists[name] = (n + 1, s + v, min(lo, v), max(hi, v))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "gauge_max": dict(self.gauge_max),
                "dists": {
                    k: {"count": n, "sum": s, "min": lo, "max": hi}
                    for k, (n, s, lo, hi) in self.dists.items()
                },
            }


_REGISTRY: Optional[MetricsRegistry] = None


def install(registry: Optional[MetricsRegistry]) -> None:
    global _REGISTRY
    _REGISTRY = registry


def current() -> Optional[MetricsRegistry]:
    return _REGISTRY


def count(st, name: str, value) -> None:
    """THE counter write path: ``st.<name> += value``, mirrored into the
    registry when one is installed."""
    setattr(st, name, getattr(st, name) + value)
    reg = _REGISTRY
    if reg is not None:
        reg.count(name, value, step=getattr(st, "step", None))


def set_stat(st, name: str, value) -> None:
    """Assignment-style stats (``st.<name> = value``) through the same
    observation funnel."""
    setattr(st, name, value)
    reg = _REGISTRY
    if reg is not None:
        reg.gauge(name, value, step=getattr(st, "step", None))


def gauge(name: str, value, step: Optional[int] = None) -> None:
    """Registry-only gauge (no StepStats field) — e.g. device memory."""
    reg = _REGISTRY
    if reg is not None:
        reg.gauge(name, value, step=step)


def sample_device_memory(device=None) -> Optional[int]:
    """Bytes the caching allocator holds in tensors on CUDA ``device``
    (``torch.cuda.memory_allocated``: an allocator counter, read without
    a sync), or None for a CPU device or none given."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device))
