"""PyTorch port vs the JAX package: graph tables and bit math (the
canonical math is in ``test_torch_graph_canon.py``). Inputs come from one
seed; integer outputs must match exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import graph as JG
from repro_torch.core import bitset as tbitset
from repro_torch.core import graph as TG

GENERATORS = [
    ("random_labeled", lambda m: m.random_labeled(40, 90, n_labels=3, seed=2)),
    ("citeseer_like", lambda m: m.citeseer_like(scale=0.02)),
    ("mico_like", lambda m: m.mico_like(scale=0.002)),
    ("patents_like", lambda m: m.patents_like(scale=0.0005)),
    ("unlabeled_sn_like", lambda m: m.unlabeled_sn_like(scale=0.0001)),
    ("paper_figure2", lambda m: m.paper_figure2()),
    ("triangle_plus_tail", lambda m: m.triangle_plus_tail()),
    ("complete", lambda m: m.complete(6, n_labels=2, seed=1)),
]


def _jax_arrays(jdg):
    return {f: np.asarray(getattr(jdg, f)) for f in jdg._fields}


@pytest.mark.parametrize("name,make", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_to_device_tables_equal_reference(name, make):
    jg, tg = make(JG), make(TG)
    np.testing.assert_array_equal(jg.edges, tg.edges)
    np.testing.assert_array_equal(jg.labels, tg.labels)
    want = _jax_arrays(JG.to_device(jg))
    got = TG.to_device(tg, device="cpu")
    assert got._fields == tuple(want)
    for f, a in want.items():
        t = getattr(got, f)
        assert t.device.type == "cpu"
        b = t.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (got.n, got.m, got.max_degree) == (jg.n, jg.m, want["nbr"].shape[1])


def test_device_graph_from_numpy_round_trips_jax_tables():
    jdg = JG.to_device(JG.random_labeled(50, 120, n_labels=4, seed=9))
    arrays = _jax_arrays(jdg)
    assert arrays["adj_bits"].dtype == np.uint32
    for src in (arrays, jdg):       # a mapping, or the JAX NamedTuple
        dg = TG.device_graph_from_numpy(src, "cpu")
        assert dg.adj_bits.dtype == torch.int32
        np.testing.assert_array_equal(
            dg.adj_bits.numpy().view(np.uint32), arrays["adj_bits"]
        )
        np.testing.assert_array_equal(dg.nbr.numpy(), arrays["nbr"])


def test_is_edge_and_bit_math_match_reference():
    g = JG.random_labeled(70, 200, n_labels=2, seed=4)
    jdg = JG.to_device(g)
    tdg = TG.to_device(TG.Graph(n=g.n, labels=g.labels, edges=g.edges), "cpu")
    rng = np.random.default_rng(0)
    u = rng.integers(-2, g.n, 500).astype(np.int32)
    v = rng.integers(-2, g.n, 500).astype(np.int32)
    want = np.asarray(jdg.is_edge(jnp.asarray(u), jnp.asarray(v)))
    got = tdg.is_edge(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    words = rng.integers(0, 2**32, (64,), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jbitset.popcount_u32(jnp.asarray(words)))
    got = tbitset.popcount_u32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    dense = rng.random((5, 70)) < 0.3
    np.testing.assert_array_equal(
        tbitset.pack_bool_matrix(dense), jbitset.pack_bool_matrix(dense)
    )


def test_to_device_without_cuda_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.paper_figure2()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.to_device(g)
    assert TG.to_device(g, "cpu").device.type == "cpu"
