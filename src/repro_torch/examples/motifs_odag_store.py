"""Distributed motif counting with the ODAG frontier store (paper
§5.2/§5.3):

    PYTHONPATH=src python -m repro_torch.examples.motifs_odag_store \
        [--workers 4] [--device cpu]

The ``store="odag"`` variant of ``repro_torch.examples.motifs_distributed``:
between BSP supersteps the frontier lives as a per-size ODAG instead of a
dense embedding list. Each worker's children are folded into a fixed-shape
DenseODAG, the worker bitmaps are merged with a bitwise OR (the paper's
§5.2 OR-allreduce, on the host in this single-process runtime), and every
worker re-materialises an approximately equal-cost slice via §5.3
cost-annotated partitioning — so exchange bytes scale with the ODAG, never
the embedding count. The printed per-step compression ratio is Fig. 9 from
a live run (``StepStats.compression``).

The serial engine also accepts ``RunConfig(store="odag",
device_budget_bytes=...)`` to mine frontiers larger than device memory in
budget-sized waves (the spill store).
"""
from __future__ import annotations

import argparse

from repro_torch.core import RunConfig, graph, make_mesh
from repro_torch.core.apps import MotifsApp
from repro_torch.core.distributed import run_distributed
from repro_torch.examples.quickstart import DEVICE_HELP


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--scale", type=float, default=0.004)
    args = ap.parse_args(argv)

    mesh = make_mesh((args.workers,), ("data",), device=args.device)
    print(f"mesh: {args.workers} workers, frontier store: odag")

    g = graph.mico_like(scale=args.scale)
    res = run_distributed(g, MotifsApp(max_size=3), mesh,
                          RunConfig(store="odag"))

    print(f"motif counts over {res.stats.total_embeddings} embeddings:")
    for code, count in sorted(res.patterns.items(), key=lambda kv: -kv[1]):
        print(f"  {code}: {count}")

    print("\nfrontier exchange, raw embedding list vs ODAG (Fig. 9):")
    for s in res.stats.steps:
        if not s.odag_bytes:
            continue
        print(
            f"  size {s.size}: raw {s.frontier_bytes:>10,} B"
            f" -> odag {s.odag_bytes:>9,} B"
            f"  ({s.compression:.1f}x compression)"
        )
    print("summary:", res.stats.summary())
    return res


if __name__ == "__main__":
    main()
