"""Traced mining run: phase spans + Perfetto export (DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.examples.traced_run \
        [--trace-dir traces] [--device cpu]

Runs depth-3 motifs with ``RunConfig(trace=True, trace_dir=...)`` and
prints where the Chrome trace landed — open it at https://ui.perfetto.dev
(or ``chrome://tracing``) to see every superstep broken into
materialize / aggregate / alpha / expand / seal / checkpoint spans with
frontier sizes, bytes-to-host and host-sync counter tracks underneath.
``log_every=1`` also prints the one-line-per-superstep progress log. The
example checks its own trace: valid (``obs.validate_chrome_trace``) and
at least 95 % of every superstep's wall inside a named phase span
(``obs.phase_coverage``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import RunConfig, SuperstepRuntime, graph, obs
from repro_torch.core.apps import MotifsApp
from repro_torch.examples.quickstart import DEVICE_HELP

MIN_COVERAGE = 0.95


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--trace-dir", default="traces")
    ap.add_argument("--scale", type=float, default=0.002)
    args = ap.parse_args(argv)

    g = graph.mico_like(scale=args.scale)
    cfg = RunConfig(
        max_steps=3, trace=True, trace_dir=args.trace_dir, log_every=1
    )
    result = SuperstepRuntime(g, MotifsApp(max_size=3), cfg,
                              device=args.device).run()

    print(
        f"mined {result.stats.total_embeddings} embeddings "
        f"({len(result.patterns)} patterns) in "
        f"{result.stats.wall_time:.2f}s"
    )
    print(f"phase walls: {result.stats.phase_walls()}")
    print(f"trace: {result.trace_path}  (open in https://ui.perfetto.dev)")

    with open(result.trace_path) as f:
        doc = json.load(f)
    problems = obs.validate_chrome_trace(doc)
    if problems:
        raise SystemExit(f"invalid trace: {problems}")
    cov = obs.phase_coverage(doc)
    if cov["coverage"] < MIN_COVERAGE:
        raise SystemExit(f"phase coverage {cov['coverage']:.2%} is below "
                         f"{MIN_COVERAGE:.0%}")
    print(f"trace valid; phase coverage {cov['coverage']:.2%}")
    return result, cov


if __name__ == "__main__":
    main()
