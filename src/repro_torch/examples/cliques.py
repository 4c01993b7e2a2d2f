"""Clique mining (paper Fig. 4c — the 19-line app), checked against a plain
enumeration of every clique.

    PYTHONPATH=src python -m repro_torch.examples.cliques [--device cpu]

Store knobs (DESIGN.md §7): ``RunConfig(store="odag")`` keeps the frontier
ODAG-compressed between supersteps and re-applies the isClique filter
during extraction; ``device_budget_bytes=...`` mines in waves.
"""
from __future__ import annotations

import argparse

from repro_torch.core import RunConfig, graph, run
from repro_torch.core.apps import CliquesApp
from repro_torch.examples.quickstart import DEVICE_HELP


def enumerate_clique_counts(g: graph.Graph, max_size: int) -> dict:
    """size -> #cliques of ``g`` up to ``max_size``: each clique once, as its
    ascending vertex sequence, by intersecting ordered neighbour sets."""
    higher = [set() for _ in range(g.n)]
    for u, v in g.edges.tolist():
        higher[min(u, v)].add(max(u, v))
    counts = dict.fromkeys(range(1, max_size + 1), 0)

    def grow(size, cand):
        # cand: the vertices that extend the current (size-1)-clique
        counts[size] += len(cand)
        if size < max_size:
            for v in cand:
                grow(size + 1, cand & higher[v])

    grow(1, set(range(g.n)))
    return {k: c for k, c in counts.items() if c}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--scale", type=float, default=0.0002)
    ap.add_argument("--max-size", type=int, default=4)
    args = ap.parse_args(argv)

    g = graph.unlabeled_sn_like(scale=args.scale)
    print(f"graph: {g.n} vertices, {g.m} edges")

    res = run(g, CliquesApp(max_size=args.max_size),
              RunConfig(chunk_size=8192, initial_capacity=1 << 15),
              device=args.device)
    mined = {size: emb.shape[0] for size, emb in sorted(res.embeddings.items())}
    for size, n in mined.items():
        print(f"  cliques of size {size}: {n}")

    counts = enumerate_clique_counts(g, args.max_size)
    print("plain enumeration:", counts)
    if mined != counts:
        raise SystemExit(f"MISMATCH: mined {mined}, enumerated {counts}")
    print("MATCH")
    return mined


if __name__ == "__main__":
    main()
