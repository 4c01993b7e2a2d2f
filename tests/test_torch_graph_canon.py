"""The port's canonical-form math (``repro_torch.core.canon_math``) vs the
JAX package's on every small pattern: batch canonicalisation, single
codes, automorphism orbits and the permutation tables (moved from
``test_torch_graph.py``)."""
import itertools

import numpy as np
import pytest

from repro.core import canon_math as jcm
from repro_torch.core import canon_math as tcm


def _all_codes(nv, n_labels):
    pairs = [(a, b) for b in range(1, nv) for a in range(b)]
    for bits in range(1 << len(pairs)):
        adj = np.zeros((nv, nv), bool)
        for i, (a, b) in enumerate(pairs):
            if bits >> i & 1:
                adj[a, b] = adj[b, a] = True
        for labels in itertools.product(range(n_labels), repeat=nv):
            yield jcm.encode(nv, adj, np.array(labels))


@pytest.mark.parametrize("nv,n_labels", [(1, 3), (2, 3), (3, 3), (4, 2)])
def test_canon_math_exhaustive_small_patterns(nv, n_labels):
    codes = np.array(list(_all_codes(nv, n_labels)), dtype=np.int64)
    jb, js = jcm._canonicalize_batch(codes)
    tb, ts = tcm._canonicalize_batch(codes)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    for code in codes[:: max(1, len(codes) // 200)]:
        jk, jsig = jcm.canonicalize_one(code)
        tk, tsig = tcm.canonicalize_one(code)
        assert tk == jk
        np.testing.assert_array_equal(tsig, jsig)
        np.testing.assert_array_equal(
            tcm.automorphism_orbits(code), jcm.automorphism_orbits(code)
        )
    for a, b in zip(tcm.perm_tables(nv), jcm.perm_tables(nv)):
        np.testing.assert_array_equal(a, b)
