"""The port's canonical refine (level 2 on the device) vs the JAX package's.

The plain route (``refine_codes_ref``, what the refine wrapper runs for CPU
tensors) is held against the JAX jnp route (``_refine_nv_jnp``, through
``refine_batch``) exhaustively for nv 2-5 and on seeded rows for nv 6-8,
with and without orbits, on mixed-nv batches with invalid rows, and on the
tie-break case of ``tests/test_canonical_refine.py``; the JAX Pallas route
in interpret mode on a few rows at nv <= 4. The host hook
(``make_canon_fn``) is held against the host permutation search. Outputs
are integers: tolerance 0. The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``); the permutation table it reads is checked
here.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64, as the package does)
from repro.kernels import canonical_refine as jcr
from repro_torch.core import canon_math
from repro_torch.kernels import canonical_refine as tcr
from torch_parity import assert_same_arrays


def _encode_all(nv, labels_pool):
    """Every adjacency mask × every label assignment for ``nv`` vertices."""
    out = []
    for mask in range(1 << canon_math.n_pair_bits(nv)):
        adj = np.zeros((nv, nv), dtype=bool)
        for bb in range(1, nv):
            for aa in range(bb):
                if mask & (1 << canon_math._pair_bit(aa, bb)):
                    adj[aa, bb] = adj[bb, aa] = True
        for labs in itertools.product(labels_pool, repeat=nv):
            out.append(canon_math.encode(nv, adj, np.array(labs)))
    return np.array(out, dtype=np.int64)


def _random_codes(nv, n, seed, n_labels=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        upper = np.triu(rng.random((nv, nv)) < 0.5, 1)
        labs = rng.integers(0, n_labels, size=nv)
        out.append(canon_math.encode(nv, upper | upper.T, labs))
    return np.array(out, dtype=np.int64)


def _both(codes, valid, nvs, with_orbits, **jkw):
    port = tcr.refine_codes(torch.from_numpy(codes), torch.from_numpy(valid),
                            nvs, with_orbits=with_orbits)
    ref = jcr.refine_batch(jnp.asarray(codes), jnp.asarray(valid), nvs,
                           with_orbits=with_orbits, **jkw)
    assert_same_arrays(port, ref)
    return port


@pytest.mark.parametrize("nv,pool", [(2, (0, 1, 2)), (3, (0, 1, 2)),
                                     (4, (0, 1, 2)), (5, (0, 1))])
def test_exhaustive_small_nv_matches_reference(nv, pool):
    codes = _encode_all(nv, pool)
    valid = np.ones(len(codes), bool)
    canon, sigma, _ = _both(codes, valid, (nv,), with_orbits=False)
    # canonical codes are fixed points, and their orbits match the host
    crows = np.unique(canon.numpy(), axis=0)
    _, _, rep = _both(crows, np.ones(len(crows), bool), (nv,),
                      with_orbits=True)
    for i in range(0, len(crows), max(1, len(crows) // 16)):
        np.testing.assert_array_equal(
            rep[i].numpy(), canon_math.automorphism_orbits(crows[i]))


@pytest.mark.parametrize("nv", [6, 7, 8])
def test_seeded_large_nv_matches_reference(nv):
    codes = _random_codes(nv, 6, seed=nv)
    _both(codes, np.ones(len(codes), bool), (nv,), with_orbits=True)


def test_mixed_nv_batch_with_invalid_and_foreign_rows():
    """nv 3 and 4 refined in one batch; invalid rows, nv <= 1 rows and an
    nv outside ``nvs`` pass through unchanged with identity sigma/rep."""
    codes = np.concatenate([
        _random_codes(3, 25, seed=1), _random_codes(4, 25, seed=2),
        _random_codes(5, 5, seed=3),
        np.array([[1 | (0 << 4), 7, 0], [0, 0, 0]], np.int64),
    ])
    valid = np.ones(len(codes), bool)
    valid[::7] = False
    canon, sigma, rep = _both(codes, valid, (3, 4), with_orbits=True)
    ident = np.arange(8, dtype=np.int32)
    for i in np.flatnonzero(~valid | ((codes[:, 0] & 0xF) > 4)
                            | ((codes[:, 0] & 0xF) < 2)):
        np.testing.assert_array_equal(canon[i].numpy(), codes[i])
        np.testing.assert_array_equal(sigma[i].numpy(), ident)
        np.testing.assert_array_equal(rep[i].numpy(), ident)
    for i in np.flatnonzero(valid & ((codes[:, 0] & 0xF) <= 4)
                            & ((codes[:, 0] & 0xF) >= 3)):
        want_c, want_s = canon_math.canonicalize_one(codes[i])
        assert tuple(canon[i].tolist()) == tuple(want_c)
        np.testing.assert_array_equal(sigma[i].numpy(), want_s)


def test_first_minimal_permutation_tie_break_and_pallas_route():
    """A fully symmetric triangle: every permutation attains the minimum,
    so sigma comes from the FIRST one (the identity) and every position is
    in orbit 0 — in the plain route and the JAX Pallas kernel alike."""
    adj = ~np.eye(3, dtype=bool)
    tri = np.array(canon_math.encode(3, adj, np.array([2, 2, 2])), np.int64)
    codes = np.concatenate([tri[None], _random_codes(3, 3, seed=4),
                            _random_codes(4, 3, seed=5)])
    valid = np.ones(len(codes), bool)
    canon, sigma, rep = _both(codes, valid, (3, 4), with_orbits=True,
                              use_kernel=True, interpret=True)
    assert tuple(canon[0].tolist()) == tuple(tri)
    np.testing.assert_array_equal(sigma[0].numpy(), np.arange(8))
    np.testing.assert_array_equal(rep[0, :3].numpy(), np.zeros(3))


def test_canon_fn_hook_matches_host_search():
    codes = np.unique(np.concatenate([_random_codes(4, 40, seed=8),
                                      _random_codes(3, 20, seed=9)]), axis=0)
    canon, sigma = tcr.make_canon_fn(device="cpu")(codes)
    for i, row in enumerate(codes):
        want_c, want_s = canon_math.canonicalize_one(row)
        assert tuple(canon[i]) == tuple(want_c)
        np.testing.assert_array_equal(sigma[i], want_s)
    empty = tcr.canonicalize_on_device(np.zeros((0, 3), np.int64),
                                       device="cpu")
    assert [a.shape[0] for a in empty] == [0, 0, 0]


def test_canon_fn_hook_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """With no device given the hook means the card, as every entry point
    of the port does: without one it raises instead of refining on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = _random_codes(3, 4, seed=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcr.canonicalize_on_device(codes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcr.make_canon_fn()(codes)
    canon, _ = tcr.make_canon_fn(device="cpu")(codes)
    assert canon.shape == codes.shape


def test_kernel_table_packs_every_permutation():
    """The CUDA kernel's table: per nv, nv! rows of eight words (the
    permutation as nibbles, then the 28 source-bit bytes), at the offsets
    and counts ``meta`` gives, and a power-of-two lane count per row."""
    table, meta, group = tcr._kernel_tables((3, 5, 1, 9), "cpu")
    meta = meta.numpy()
    rows = table.numpy().view(np.uint32)
    assert rows.shape == (6 + 120, 8) and group == 32
    for nv in (3, 5):
        perms, src = canon_math.perm_tables(nv)
        off, cnt = meta[nv], meta[9 + nv]
        assert cnt == len(perms)
        got = rows[off: off + cnt]
        nib = (got[:, :1] >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
        np.testing.assert_array_equal(nib[:, :nv], perms)
        np.testing.assert_array_equal(nib[:, nv:], np.tile(
            np.arange(nv, 8), (cnt, 1)))
        sb = got[:, 1:].copy().view(np.uint8)
        np.testing.assert_array_equal(sb[:, :src.shape[1]], src)
    assert meta[9 + 4] == 0 and meta[9 + 1] == 0
    assert tcr._kernel_tables((3,), "cpu")[2] == 8
    assert tcr._kernel_tables((2,), "cpu")[2] == 2
