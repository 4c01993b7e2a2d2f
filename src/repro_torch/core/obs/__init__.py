"""Minimal observability for the port's superstep runtime.

``count`` / ``set_stat`` are the only write path of the ``StepStats``
counters, as in ``repro.core.obs``. Spans, device annotations and fences
are no-ops, and a run that asks for tracing raises: the tracer, the
metrics registry and the exporters are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import contextlib

#: shared reusable no-op context
_NULL = contextlib.nullcontext()


def count(st, name: str, value) -> None:
    """THE counter write path: ``st.<name> += value``."""
    setattr(st, name, getattr(st, name) + value)


def set_stat(st, name: str, value) -> None:
    """Assignment-style stats (``st.<name> = value``)."""
    setattr(st, name, value)


def span(name: str, **attrs):
    return _NULL


def annotate(name: str):
    return _NULL


def fence(*trees) -> None:
    return None


class RunObserver:
    """Per-run observability bundle; raises for what is not ported."""

    def __init__(self, config, backend_name: str = "") -> None:
        if config.trace or config.log_every:
            raise NotImplementedError(
                "trace/log_every: the port's tracer is not ported yet; see "
                "ROADMAP.md"
            )

    def start(self) -> None:
        pass

    def step_done(self, st) -> None:
        pass

    def finish(self, wall_time: float = 0.0, aborted: bool = False):
        return None
