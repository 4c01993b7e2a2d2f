"""Structured observability for the superstep runtime (DESIGN.md §12),
port of ``repro.core.obs``.

The façade every runtime layer imports as ``from repro_torch.core import
obs``:

  * ``obs.span("expand", step=k, ...)`` — nested host phase spans
    (a shared nullcontext when no tracer is installed: no allocation, no
    device sync on the disabled path);
  * ``obs.count(st, "bytes_to_host", n)`` / ``obs.set_stat(...)`` — THE
    write path for StepStats counters, mirrored into the metrics registry
    while observing;
  * ``obs.fence(*trees)`` — blocking phase boundaries
    (``torch.cuda.synchronize``), ONLY under ``trace_sync=True``;
  * ``obs.annotate("fused_chunk")`` — a ``torch.profiler.record_function``
    range while traced;
  * :class:`RunObserver` — the per-run bundle the loop drives (install,
    per-step counters + progress log, Chrome-trace/JSONL export).

Knobs: ``RunConfig.trace`` / ``trace_dir`` / ``trace_sync`` /
``log_every``.
"""
from repro_torch.core.obs.export import (        # noqa: F401
    PHASES,
    RunObserver,
    chrome_trace_events,
    phase_coverage,
    step_log_line,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.core.obs.metrics import (       # noqa: F401
    MetricsRegistry,
    count,
    gauge,
    sample_device_memory,
    set_stat,
)
from repro_torch.core.obs.metrics import (       # noqa: F401
    current as current_metrics,
)
from repro_torch.core.obs.metrics import (       # noqa: F401
    install as install_metrics,
)
from repro_torch.core.obs.tracer import (        # noqa: F401
    Span,
    Tracer,
    annotate,
    fence,
    probe_time,
    span,
    sync_active,
)
from repro_torch.core.obs.tracer import (        # noqa: F401
    current as current_tracer,
)
from repro_torch.core.obs.tracer import (        # noqa: F401
    install as install_tracer,
)
