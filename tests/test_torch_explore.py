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
from repro.core.apps import CliquesApp as JCliques, MotifsApp as JMotifs
from repro.core.runtime import programs as jprograms
from repro_torch.core import explore as texplore, graph as TG
from repro_torch.core.apps import CliquesApp, MotifsApp
from torch_parity import jax_run

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
    res = jax_run(g, JMotifs(max_size=3, collect_embeddings=True),
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
@pytest.mark.parametrize("out_cap", [16])
def test_expand_and_compact_matches_reference(setting, size, knobs, out_cap):
    jdg, tdg, frontiers, _ = setting
    (jm, tm), (jn, tn) = map(_pair, frontiers[size])
    want = jexplore.expand_and_compact(jdg, jm, jn, "vertex", out_cap)
    got = texplore.expand_and_compact(tdg, tm, tn, "vertex", out_cap, **knobs)
    _eq(got, want, ("children", "count", "n_generated", "n_canonical"))
    assert got[1].dtype == torch.int32 and got[1].shape == ()
