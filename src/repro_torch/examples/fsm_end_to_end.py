"""End-to-end run: frequent subgraph mining on a CiteSeer-scale graph,
reporting the paper's headline metrics (frequent patterns + supports,
quick-pattern reduction, per-step stats).

    PYTHONPATH=src python -m repro_torch.examples.fsm_end_to_end \
        [--support 8] [--scale 0.3] [--device cpu]

Pass ``--store odag`` to keep each superstep's frontier ODAG-compressed
between steps (paper §5.2, DESIGN.md §7) and print the live per-step
compression; ``RunConfig(device_budget_bytes=...)`` additionally mines
frontiers larger than device memory in budget-sized waves.
"""
from __future__ import annotations

import argparse

from repro_torch.core import RunConfig, graph, run
from repro_torch.core.apps import FSMApp
from repro_torch.core.canon_math import decode
from repro_torch.examples.quickstart import DEVICE_HELP


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--support", type=int, default=8)
    ap.add_argument("--max-size", type=int, default=3)
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--store", choices=["raw", "odag"], default="raw")
    args = ap.parse_args(argv)

    g = graph.citeseer_like(scale=args.scale)
    print(f"graph: {g.n} vertices, {g.m} edges, {g.labels.max()+1} labels")
    res = run(
        g,
        FSMApp(support=args.support, max_size=args.max_size),
        RunConfig(chunk_size=8192, initial_capacity=1 << 15,
                  store=args.store),
        device=args.device,
    )
    if args.store == "odag":
        print("frontier compression (raw -> odag bytes, Fig. 9):",
              {k: round(v, 1) for k, v in
               res.stats.compression_by_size().items()})

    print(f"\n{len(res.patterns)} frequent patterns "
          f"(support >= {args.support}):")
    for code, sup in sorted(res.patterns.items(), key=lambda kv: -kv[1])[:10]:
        _, adj, labels = decode(code)
        print(f"  {int(adj.sum()) // 2} edges, labels={labels.tolist()}: "
              f"support={sup}")

    print("\nper-step stats (paper Table 4 shape):")
    print("step size frontier candidates canonical quick canon iso")
    for s in res.stats.steps:
        print(
            f"{s.step:4d} {s.size:4d} {s.n_frontier:9d} {s.n_generated:10d} "
            f"{s.n_canonical:9d} {s.n_quick_patterns:5d} "
            f"{s.n_canonical_patterns:5d} {s.n_iso_checks:4d}"
        )
    print(f"\nwall time: {res.stats.wall_time:.2f}s; "
          f"embeddings: {res.stats.total_embeddings}")
    return res


if __name__ == "__main__":
    main()
