"""Exact brute-force oracles (host) for validating the engine, port of
``repro.core.baselines.bruteforce``.

These enumerate *all* connected vertex- or edge-induced embeddings by
recursive expansion with set-dedup (no canonicality tricks), then compute
pattern counts and min-image supports independently of every device code
path. Only usable on tiny graphs; that is their job.

Three changes from the reference leave every output as it is: each
vertex-induced embedding reads adjacency sets built once per call, where
the reference rebuilds the set of all edges for every embedding; each
call canonicalises a local code once, in a dict of its own, where the
reference does so for every embedding (the local code is the oracle's own
``canon_math.encode`` of the embedding's sorted vertices, nothing of the
engine's quick patterns); and FSM's isomorphisms of a local code are the
one ``canonicalize_one`` found composed with the canonical pattern's
automorphisms, where the reference scans every permutation again.
"""
from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np

from repro_torch.core import canon_math
from repro_torch.core.graph import Graph


def _adj_sets(g: Graph):
    adj = [set() for _ in range(g.n)]
    for u, v in g.edges:
        adj[int(u)].add(int(v))
        adj[int(v)].add(int(u))
    return adj


def _incident_sets(g: Graph):
    incident = [set() for _ in range(g.n)]
    for eid, (u, v) in enumerate(g.edges):
        incident[int(u)].add(eid)
        incident[int(v)].add(eid)
    return incident


def _edge_border(g: Graph, incident, emb: frozenset) -> set:
    verts = set()
    for e in emb:
        verts.update(int(x) for x in g.edges[e])
    return set().union(*(incident[v] for v in verts)) - set(emb)


def enumerate_vertex_embeddings(g: Graph, max_size: int) -> dict[int, set]:
    """All connected vertex sets of size 1..max_size, as frozensets."""
    adj = _adj_sets(g)
    levels: dict[int, set] = {1: {frozenset([v]) for v in range(g.n)}}
    for k in range(2, max_size + 1):
        nxt = set()
        for emb in levels[k - 1]:
            border = set().union(*(adj[v] for v in emb)) - set(emb)
            for v in border:
                nxt.add(emb | {v})
        levels[k] = nxt
    return levels


def enumerate_edge_embeddings(g: Graph, max_size: int) -> dict[int, set]:
    """All connected edge-id sets of size 1..max_size."""
    incident = _incident_sets(g)
    levels: dict[int, set] = {1: {frozenset([e]) for e in range(g.m)}}
    for k in range(2, max_size + 1):
        nxt = set()
        for emb in levels[k - 1]:
            for e in _edge_border(g, incident, emb):
                nxt.add(emb | {e})
        levels[k] = nxt
    return levels


def _canonical(memo: dict, quick) -> tuple:
    """``canon_math.canonicalize_one``'s code of ``quick``, computed once a
    call per distinct local code."""
    code = memo.get(quick)
    if code is None:
        code = memo[quick] = canon_math.canonicalize_one(quick)[0]
    return code


def _vertex_embedding_code(g: Graph, adj, emb: frozenset, memo: dict):
    """Canonical pattern code of a vertex-induced embedding (host path,
    independent of the device quick-pattern code)."""
    vs = sorted(emb)
    nv = len(vs)
    dense = np.zeros((nv, nv), dtype=bool)
    for i, j in itertools.combinations(range(nv), 2):
        if vs[j] in adj[vs[i]]:
            dense[i, j] = dense[j, i] = True
    return _canonical(memo, canon_math.encode(nv, dense, g.labels[vs]))


def _edge_embedding_local(g: Graph, emb):
    """The local code of an edge-induced embedding over its sorted
    vertices, and those vertices."""
    eids = sorted(emb)
    vs = sorted({int(x) for e in eids for x in g.edges[e]})
    nv = len(vs)
    idx = {v: i for i, v in enumerate(vs)}
    adj = np.zeros((nv, nv), dtype=bool)
    for e in eids:
        u, v = (int(x) for x in g.edges[e])
        adj[idx[u], idx[v]] = adj[idx[v], idx[u]] = True
    return canon_math.encode(nv, adj, g.labels[vs]), vs


def _automorphisms(code) -> list:
    """Every permutation of a canonical pattern's positions that maps it
    onto itself."""
    nv, adj, labels = canon_math.decode(code)
    out = []
    for perm in itertools.permutations(range(nv)):
        perm = np.array(perm)
        if canon_math.encode(nv, adj[perm][:, perm], labels[perm]) == code:
            out.append(perm)
    return out


def _isomorphisms(quick, autos: dict) -> tuple:
    """Canonical code of a local code and every permutation ``p`` (canonical
    position -> local position) that achieves it: the one
    ``canonicalize_one`` found, composed with each automorphism of the
    canonical pattern (``autos`` caches those per code)."""
    code, sigma = canon_math.canonicalize_one(quick)
    nv = quick[0] & 0xF
    first = np.argsort(sigma[:nv])          # canonical position -> local
    if code not in autos:
        autos[code] = _automorphisms(code)
    return code, [first[a] for a in autos[code]]


def _edge_embedding_code_and_vertmaps(g: Graph, emb: frozenset, memo: dict,
                                      autos: dict):
    """Canonical code + *all* {canonical position -> graph vertex} maps of an
    edge-induced embedding (one per isomorphism pattern->embedding; the
    paper's domain definition ranges over all of them)."""
    quick, vs = _edge_embedding_local(g, emb)
    if quick not in memo:
        memo[quick] = _isomorphisms(quick, autos)
    code, perms = memo[quick]
    # canonical position i corresponds to local vertex perm[i]
    return code, [{i: vs[perm[i]] for i in range(len(vs))} for perm in perms]


def motif_counts(g: Graph, max_size: int) -> dict[tuple, int]:
    """Pattern -> #vertex-induced embeddings, sizes 1..max_size."""
    adj = _adj_sets(g)
    memo: dict = {}
    counts: dict[tuple, int] = defaultdict(int)
    levels = enumerate_vertex_embeddings(g, max_size)
    for k in range(1, max_size + 1):
        for emb in levels[k]:
            counts[_vertex_embedding_code(g, adj, emb, memo)] += 1
    return dict(counts)


def clique_counts(g: Graph, max_size: int) -> dict[int, int]:
    """size -> #cliques (vertex-induced complete subgraphs)."""
    adj = _adj_sets(g)
    levels = enumerate_vertex_embeddings(g, max_size)
    out = {}
    for k in range(1, max_size + 1):
        cnt = 0
        for emb in levels[k]:
            if all(b in adj[a] for a, b in itertools.combinations(emb, 2)):
                cnt += 1
        out[k] = cnt
    return out


def fsm_supports(g: Graph, max_size: int, support: int) -> dict[tuple, int]:
    """Frequent edge-induced patterns with min-image supports, honouring
    anti-monotonic level-wise pruning exactly as the engine does (embeddings
    of infrequent patterns are not expanded)."""
    incident = _incident_sets(g)
    memo: dict = {}
    autos: dict = {}
    frequent: dict[tuple, int] = {}
    frontier = {frozenset([e]) for e in range(g.m)}
    for k in range(1, max_size + 1):
        if not frontier:
            break
        domains: dict[tuple, dict[int, set]] = defaultdict(lambda: defaultdict(set))
        by_pattern: dict[tuple, list] = defaultdict(list)
        for emb in frontier:
            code, vmaps = _edge_embedding_code_and_vertmaps(g, emb, memo,
                                                            autos)
            by_pattern[code].append(emb)
            for vmap in vmaps:
                for pos, vert in vmap.items():
                    domains[code][pos].add(vert)
        survivors = set()
        for code, embs in by_pattern.items():
            sup = min(len(s) for s in domains[code].values())
            if sup >= support:
                frequent[code] = sup
                survivors.update(embs)
        nxt = set()
        if k < max_size:
            for emb in survivors:
                for e in _edge_border(g, incident, emb):
                    nxt.add(emb | {e})
        frontier = nxt
    return frequent
