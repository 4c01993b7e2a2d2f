"""Distributed motif counting over a mesh of workers (paper §5.1–§5.3):

    PYTHONPATH=src python -m repro_torch.examples.motifs_distributed \
        [--workers 4] [--device cpu]

``make_mesh((W,), ("data",))`` puts W virtual workers on the card (or on
the CPU with ``--device cpu``); ``run_distributed`` runs the shard-map
superstep over them and gives the serial run's results. Frontier-store
knobs (DESIGN.md §7): ``RunConfig(store="raw")`` (default) exchanges the
frontier as a dense embedding list with even block slicing;
``store="odag"`` merges worker-local DenseODAGs with one OR and
re-materialises cost-balanced per-worker slices (paper §5.2/§5.3) — see
``repro_torch.examples.motifs_odag_store``. ``RunConfig(checkpoint_dir=
...)`` checkpoints every sealed superstep; a checkpoint resumes on a mesh
of any other worker count (DESIGN.md §9).
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
    print(f"mesh: {args.workers} workers")

    g = graph.mico_like(scale=args.scale)
    res = run_distributed(g, MotifsApp(max_size=3), mesh, RunConfig())

    print(f"motif counts over {res.stats.total_embeddings} embeddings:")
    for code, count in sorted(res.patterns.items(), key=lambda kv: -kv[1]):
        print(f"  {code}: {count}")
    print("\nper-step collective bytes (two-level aggregation):",
          [s.collective_bytes for s in res.stats.steps])
    return res


if __name__ == "__main__":
    main()
