"""Quickstart: mine motifs with the filter-process API in ~10 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``RunConfig`` knobs worth knowing: ``store="odag"`` keeps the frontier
ODAG-compressed between supersteps (paper §5.2), ``device_budget_bytes``
bounds the device-resident slice per wave (larger-than-memory mining) —
see DESIGN.md §7 and ``repro_torch.examples.motifs_odag_store``. The
superstep runs as the fused pipeline of DESIGN.md §8. ``cost_model="auto"``
(the default) resolves every unset knob to the pilot-measured fastest
choice for the card and the graph, recorded in ``result.stats.cost_model``
(DESIGN.md §14). ``checkpoint_dir=...`` persists every sealed superstep
(``repro_torch.examples.resume_after_crash``); ``trace=True`` exports a
Perfetto-loadable trace (``repro_torch.examples.traced_run``).
"""
from __future__ import annotations

import argparse

from repro_torch.core import RunConfig, graph, run
from repro_torch.core.apps import MotifsApp
from repro_torch.core.canon_math import decode

DEVICE_HELP = "torch device (default: the CUDA card; 'cpu' for the CPU)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--scale", type=float, default=0.05)
    args = ap.parse_args(argv)

    g = graph.citeseer_like(scale=args.scale)      # CiteSeer-shaped graph
    result = run(g, MotifsApp(max_size=3), RunConfig(), device=args.device)

    print(f"explored {result.stats.total_embeddings} embeddings "
          f"in {result.stats.wall_time:.2f}s over "
          f"{len(result.stats.steps)} steps")
    top = sorted(result.patterns.items(), key=lambda kv: -kv[1])[:5]
    for code, count in top:
        nv, adj, labels = decode(code)
        print(f"  pattern nodes={nv} edges={int(adj.sum()) // 2} "
              f"labels={labels.tolist()}: {count} embeddings")
    return result


if __name__ == "__main__":
    main()
