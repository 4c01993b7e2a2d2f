"""End-to-end correctness of the port: ``repro_torch.core.run`` on the CPU
equals the port's own brute-force oracles (paper's completeness guarantee,
Thm 4) for the three bundled applications. The port's counterpart of
``tests/test_apps_vs_oracle.py``; it imports nothing of JAX. The oracles
enumerate every connected embedding with set dedup and canonicalise each
one, sharing nothing with the expansion, the quick codes or the
aggregation."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import RunConfig, graph as G, run
from repro_torch.core.apps import CliquesApp, FSMApp, MotifsApp
from repro_torch.core.baselines import bruteforce as bf

torch.set_num_threads(1)

CFG = RunConfig(chunk_size=2048, initial_capacity=2048)


def _as_sets(res, k):
    emb = res.embeddings.get(k)
    return ({frozenset(int(x) for x in row) for row in np.asarray(emb)}
            if emb is not None else set())


@pytest.mark.parametrize("seed,n,m,labels",
                         [(3, 60, 150, 3), (5, 30, 60, 1), (11, 45, 100, 5)])
def test_motifs_match_oracle(seed, n, m, labels):
    g = G.random_labeled(n, m, n_labels=labels, seed=seed)
    res = run(g, MotifsApp(max_size=4), CFG, device="cpu")
    assert res.patterns == bf.motif_counts(g, 4)


@pytest.mark.parametrize("seed", [0, 7])
def test_cliques_match_oracle(seed):
    g = G.random_labeled(50, 180, n_labels=1, seed=seed)
    res = run(g, CliquesApp(max_size=4), CFG, device="cpu")
    oracle = bf.clique_counts(g, 4)
    eng = {s: arr.shape[0] for s, arr in res.embeddings.items()}
    assert eng == {k: v for k, v in oracle.items() if v > 0}
    # every collected embedding really is a clique
    adj = {tuple(sorted((int(u), int(v)))) for u, v in g.edges}
    for size, arr in res.embeddings.items():
        for row in np.asarray(arr):
            for a, b in itertools.combinations(sorted(int(x) for x in row), 2):
                assert (a, b) in adj


@pytest.mark.parametrize("seed,sup,ms", [(3, 3, 3), (5, 2, 4), (9, 5, 3)])
def test_fsm_match_oracle(seed, sup, ms):
    g = G.random_labeled(40, 90, n_labels=2, seed=seed)
    res = run(g, FSMApp(support=sup, max_size=ms), CFG, device="cpu")
    assert res.patterns == bf.fsm_supports(g, ms, sup)


def test_paper_figure2_single_edge_patterns():
    """Figure 2: the path's three edges share ONE canonical single-edge
    pattern whose min-image support is 2 and whose embedding count is 3."""
    g = G.paper_figure2()
    res = run(g, FSMApp(support=1, max_size=1), CFG, device="cpu")
    assert res.patterns == bf.fsm_supports(g, 1, 1)
    assert list(res.patterns.values()) == [2]
    res2 = run(g, FSMApp(support=1, max_size=1, wants_domains=False), CFG,
               device="cpu")
    assert list(res2.patterns.values()) == [3]


def test_edge_exploration_exact_sets():
    g = G.random_labeled(30, 60, n_labels=2, seed=5)
    res = run(g, FSMApp(support=1, max_size=4, collect_embeddings=True), CFG,
              device="cpu")
    oracle = bf.enumerate_edge_embeddings(g, 4)
    for k in range(1, 5):
        assert _as_sets(res, k) == oracle[k]
        assert len(res.embeddings.get(k, ())) == len(oracle[k])


def test_vertex_exploration_exact_sets():
    g = G.random_labeled(40, 100, n_labels=1, seed=2)
    res = run(g, MotifsApp(max_size=4, collect_embeddings=True), CFG,
              device="cpu")
    oracle = bf.enumerate_vertex_embeddings(g, 4)
    for k in range(1, 5):
        assert _as_sets(res, k) == oracle[k]
        assert len(res.embeddings.get(k, ())) == len(oracle[k])
