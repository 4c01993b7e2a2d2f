"""The port's kernel modules vs the JAX package's Pallas kernels.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors) is
held against the JAX Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, on the same numpy inputs. Outputs are
integers and booleans: tolerance 0. The CUDA kernels themselves run only on
the card: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.kernels import aggregate as jk_agg
from repro.kernels.canonical_check.canonical_check import (
    canonical_check_pallas,
    expand_canonical_pallas,
)
from repro_torch.core import graph as TG
from repro_torch.kernels import aggregate as tk_agg
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda,
    canonical_check_ref,
    expand_canonical_cuda,
)


def _graphs(seed=0, n=60, m=150):
    g = JG.random_labeled(n, m, n_labels=2, seed=seed)
    return JG.to_device(g), TG.to_device(
        TG.Graph(n=g.n, labels=g.labels, edges=g.edges), "cpu"
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _members(rng, b, k, n, allow_empty=True):
    """Rows of distinct vertices with n_valid in [0 or 1, k]; pad -1."""
    members = np.full((b, k), -1, np.int32)
    n_valid = rng.integers(0 if allow_empty else 1, k + 1, b).astype(np.int32)
    for i in range(b):
        members[i, : n_valid[i]] = rng.choice(n, size=n_valid[i], replace=False)
    return members, n_valid


def _fake_codes(rng, b, nv=3, n_labels=4, high_labels=False):
    """Synthetic quick codes honouring the encoding (words < 2^32);
    ``high_labels`` puts label bytes >= 128 in both label words."""
    bits = rng.integers(0, 1 << 3, b).astype(np.int64)
    w0 = nv | (bits << 4)
    lo = 128 if high_labels else 0
    w1 = np.zeros(b, np.int64)
    w2 = np.zeros(b, np.int64)
    for i in range(4):
        w1 |= rng.integers(lo, lo + n_labels, b).astype(np.int64) << (8 * i)
        if high_labels:
            w2 |= rng.integers(lo, lo + n_labels, b).astype(np.int64) << (8 * i)
    return np.stack([w0, w1, w2], axis=1)


# ---------------------------------------------------------------------------
# canonical_check / expand_canonical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k", [(0, 3), (1, 3), (257, 3), (600, 5)])
def test_canonical_check_plain_matches_pallas(b, k):
    jdg, tdg = _graphs(seed=b)
    rng = np.random.default_rng(b + k)
    members, n_valid = _members(rng, b, k, jdg.n)
    cand = rng.integers(-1, jdg.n, b).astype(np.int32)
    want = canonical_check_pallas(
        jnp.asarray(members.reshape(b, k)), jnp.asarray(n_valid),
        jnp.asarray(cand), jdg.adj_bits, block_b=64, interpret=True,
    )
    got = canonical_check_cuda(_t(members), _t(n_valid), _t(cand),
                               tdg.adj_bits)
    assert got.dtype == torch.bool and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        canonical_check_ref(_t(members), _t(n_valid), _t(cand),
                            tdg.adj_bits).numpy(),
        np.asarray(want),
    )


@pytest.mark.parametrize("c,k", [(0, 2), (1, 1), (13, 2), (33, 3), (9, 8)])
def test_expand_canonical_plain_matches_pallas(c, k):
    """The k = 8 case also puts real vertex ids in the slots past n_valid:
    the not-a-member rule reads all k members, the adjacency rules only
    the valid ones."""
    jdg, tdg = _graphs(seed=c + 1)
    rng = np.random.default_rng(c * 7 + k)
    members, n_valid = _members(rng, c, k, jdg.n)
    if k == 8:
        for i in range(c):
            members[i] = rng.choice(jdg.n, size=k, replace=False)
    want = expand_canonical_pallas(
        jnp.asarray(members.reshape(c, k)), jnp.asarray(n_valid), jdg.nbr,
        jdg.adj_bits, block_c=8, interpret=True,
    )
    got = expand_canonical_cuda(_t(members), _t(n_valid), tdg.nbr,
                                tdg.adj_bits)
    for g_, w_, name in zip(got, want, ("cand", "valid", "keep")):
        assert g_.shape == (c, k, tdg.max_degree), name
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# stream_compact
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# seg_unique + bin_rows
# ---------------------------------------------------------------------------


def test_pack_codes_round_trip():
    rng = np.random.default_rng(5)
    codes = _fake_codes(rng, 50, high_labels=True)
    packed = tk_agg.pack_codes_u32(_t(codes))
    np.testing.assert_array_equal(tk_agg.unpack_codes_u32(packed), codes)
    np.testing.assert_array_equal(
        tk_agg.unpack_codes_u32(packed),
        jk_agg.unpack_codes_u32(np.asarray(jk_agg.pack_codes_u32(
            jnp.asarray(codes)))),
    )
