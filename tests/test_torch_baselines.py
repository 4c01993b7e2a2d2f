"""The port's exact oracles and paradigm baselines
(``repro_torch.core.baselines``) vs the JAX package's, on seeded tiny
graphs: every output equal (tolerance 0) except the host's ``wall_time``;
then the port-side counterparts of ``tests/test_baselines.py``, with the
port's own ``run`` on the CPU."""
import dataclasses

import pytest

from repro.core import graph as JG
from repro.core.baselines import bruteforce as jbf
from repro.core.baselines import tlp as jtlp
from repro.core.baselines import tlv as jtlv
from repro_torch.core import graph as G, run
from repro_torch.core.apps import MotifsApp
from repro_torch.core.baselines import bruteforce as tbf
from repro_torch.core.baselines import tlp as ttlp
from repro_torch.core.baselines import tlv as ttlv
from torch_parity import graph_pair

GRAPHS = [
    ("random_labeled", lambda G: G.random_labeled(10, 16, n_labels=2, seed=4),
     4),
    ("unlabeled", lambda G: G.random_labeled(20, 50, n_labels=1, seed=6), 3),
    ("paper_figure2", lambda G: G.paper_figure2(), 4),
    ("complete", lambda G: G.complete(5, n_labels=2, seed=1), 4),
]


def _no_wall(report) -> dict:
    return {k: v for k, v in dataclasses.asdict(report).items()
            if k != "wall_time"}


@pytest.mark.parametrize("name,make,size", GRAPHS,
                         ids=[g[0] for g in GRAPHS])
def test_baselines_match_reference(name, make, size):
    jg, tg = graph_pair(make)
    assert (tbf.enumerate_vertex_embeddings(tg, size)
            == jbf.enumerate_vertex_embeddings(jg, size))
    assert (tbf.enumerate_edge_embeddings(tg, size)
            == jbf.enumerate_edge_embeddings(jg, size))
    assert tbf.motif_counts(tg, size) == jbf.motif_counts(jg, size)
    assert tbf.clique_counts(tg, size) == jbf.clique_counts(jg, size)
    for support in (1, 3):
        assert (tbf.fsm_supports(tg, size, support)
                == jbf.fsm_supports(jg, size, support))
    assert _no_wall(ttlv.run_tlv(tg, size)) == _no_wall(jtlv.run_tlv(jg, size))
    tp, jp = ttlp.run_tlp_fsm(tg, 2, size), jtlp.run_tlp_fsm(jg, 2, size)
    assert tp.n_patterns == jp.n_patterns
    assert tp.pattern_work == jp.pattern_work
    for workers in (5, 20, 80):
        assert tp.speedup_bound(workers) == jp.speedup_bound(workers)


def test_tlv_explores_same_embeddings():
    g = G.random_labeled(40, 90, n_labels=2, seed=1)
    rep = ttlv.run_tlv(g, max_size=3)
    oracle = tbf.enumerate_vertex_embeddings(g, 3)
    assert rep.n_embeddings == sum(len(v) for v in oracle.values())


def test_tlv_message_blowup():
    """The paper's point: every embedding is replicated to each border
    vertex, so messages >> embeddings, with hot high-degree vertices."""
    rep = ttlv.run_tlv(G.citeseer_like(scale=0.05), max_size=3)
    assert rep.n_messages > rep.n_embeddings
    assert rep.max_vertex_load > 10 * rep.mean_vertex_load


def test_tlp_speedup_bound_saturates():
    """Few hot patterns cap TLP's parallel speedup well below #workers
    (unlabeled motifs at depth 3 have only 2 patterns; Fig. 7)."""
    g = G.random_labeled(120, 400, n_labels=1, seed=2)
    rep = ttlp.run_tlp_fsm(g, support=5, max_size=3)
    b5, b20, b80 = (rep.speedup_bound(w) for w in (5, 20, 80))
    assert b5 <= 5.0 + 1e-9 and b20 <= 20.0 + 1e-9
    total = sum(rep.pattern_work.values())
    n_heavy = sum(1 for w in rep.pattern_work.values() if w > 0.01 * total)
    assert b80 < max(n_heavy * 2, 8)
    assert b80 < 80 * 0.5


def test_tle_vs_tlv_work_ratio():
    """The port's TLE run explores TLV's embeddings with no messages; TLV
    pays one per border vertex."""
    g = G.random_labeled(60, 150, n_labels=2, seed=3)
    res = run(g, MotifsApp(max_size=3), device="cpu")
    tlv = ttlv.run_tlv(g, max_size=3)
    assert res.stats.total_embeddings == tlv.n_embeddings
    assert tlv.n_messages > 2 * tlv.n_embeddings
