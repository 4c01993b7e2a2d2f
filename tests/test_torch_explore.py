"""The port's expansion (``repro_torch.core.explore``) vs the JAX package's:
``expand_and_compact`` and ``fused_chunk_step`` with patterns and with
aggregates, unfused and fused, on real canonical frontiers made from one
seed. Outputs are integers and booleans: tolerance 0. The JAX side runs its
jnp routes; the port runs the kernel routes, whose plain versions take CPU
tensors, and its own plain routes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig, explore as jexplore, graph as JG
from repro.core import run as jrun
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro.core.runtime import programs as jprograms
from repro_torch.core import explore as texplore, graph as TG
from repro_torch.core.apps import CliquesApp, MotifsApp

KNOBS = [
    dict(use_pallas=False, fused=False, compact_kernel=False),
    dict(use_pallas=True, fused=False, compact_kernel=True),
    dict(use_pallas=True, fused=True, compact_kernel=True),
]
KNOB_IDS = ["plain", "kernels", "fused"]
APPS = {"motifs": (JMotifs(max_size=4), MotifsApp(max_size=4)),
        "cliques": (JCliques(max_size=4), CliquesApp(max_size=4))}


@pytest.fixture(scope="module")
def setting():
    """A labeled graph, both device views, and canonical frontiers of sizes
    1, 2 and 3 (collected from a reference run), padded like a chunk."""
    g = JG.random_labeled(45, 110, n_labels=3, seed=11)
    jdg = JG.to_device(g)
    tdg = TG.to_device(TG.Graph(n=g.n, labels=g.labels, edges=g.edges), "cpu")
    res = jrun(g, JMotifs(max_size=3, collect_embeddings=True),
               EngineConfig(cost_model="off"))
    frontiers = {}
    for size, emb in res.embeddings.items():
        rows = np.asarray(emb, np.int32)[:96]
        pad = 128 - len(rows)
        members = np.concatenate([rows, np.full((pad, size), -1, np.int32)])
        n_valid = np.r_[np.full(len(rows), size), np.zeros(pad)].astype(np.int32)
        frontiers[size] = (members, n_valid)
    cache = {}

    def jax_chunk(app_name, size, out_cap, **flags):
        """The JAX package's jitted chunk program on one frontier (cached:
        the reference does not depend on the port's knobs)."""
        key = (app_name, size, out_cap, tuple(sorted(flags.items())))
        if key not in cache:
            fn = jprograms.make_expand_fn(APPS[app_name][0], "vertex", **flags)
            jm, jn = (jnp.asarray(a) for a in frontiers[size])
            cache[key] = tuple(
                np.asarray(x) for x in fn(jdg, jm, jn, out_cap=out_cap)
            )
        return cache[key]

    return jdg, tdg, frontiers, jax_chunk


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _eq(got, want, names):
    for g_, w_, name in zip(got, want, names):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("out_cap", [16, 4096])
def test_expand_and_compact_matches_reference(setting, size, knobs, out_cap):
    jdg, tdg, frontiers, _ = setting
    (jm, tm), (jn, tn) = map(_pair, frontiers[size])
    want = jexplore.expand_and_compact(jdg, jm, jn, "vertex", out_cap)
    got = texplore.expand_and_compact(tdg, tm, tn, "vertex", out_cap, **knobs)
    _eq(got, want, ("children", "count", "n_generated", "n_canonical"))
    assert got[1].dtype == torch.int32 and got[1].shape == ()


@pytest.mark.parametrize("app_name", ["motifs", "cliques"])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
def test_fused_chunk_step_with_patterns(setting, app_name, knobs):
    _, tdg, frontiers, jax_chunk = setting
    for size in (2, 3):
        want = jax_chunk(app_name, size, 2048, with_patterns=True)
        tm, tn = (torch.from_numpy(np.array(a)) for a in frontiers[size])
        got = texplore.fused_chunk_step(
            tdg, tm, tn, 2048, mode="vertex", app=APPS[app_name][1],
            with_patterns=True, **knobs,
        )
        _eq(got, want, ("children", "count", "codes", "local_verts",
                        "n_generated", "n_canonical"))


@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
@pytest.mark.parametrize("agg_qcap", [4, 4096])
def test_fused_chunk_step_with_aggregates(setting, knobs, agg_qcap):
    """Per-chunk level-1 partials, including a partial whose distinct count
    overflows ``agg_qcap`` (unclamped ``n_uniq``)."""
    _, tdg, frontiers, jax_chunk = setting
    want = jax_chunk("motifs", 2, 1024, with_aggregates=True,
                     agg_qcap=agg_qcap)
    tm, tn = (torch.from_numpy(np.array(a)) for a in frontiers[2])
    got = texplore.fused_chunk_step(
        tdg, tm, tn, 1024, mode="vertex", app=APPS["motifs"][1],
        with_aggregates=True, agg_qcap=agg_qcap, aggregate_kernel=True,
        **knobs,
    )
    _eq(got, want, ("children", "count", "uniq", "ucounts", "n_uniq",
                    "n_generated", "n_canonical"))
    assert got[3].dtype == torch.int32
    if agg_qcap == 4:
        assert int(got[4]) > 4


def test_edge_mode_is_not_ported(setting):
    _, tdg, frontiers, _ = setting
    m, n = (torch.from_numpy(np.array(a)) for a in frontiers[1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        texplore.expand_and_compact(tdg, m, n, "edge", 64)
