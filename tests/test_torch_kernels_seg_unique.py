"""The plain version of the port's ``seg_unique`` (what its wrapper runs
for CPU tensors) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs. Outputs are integers and booleans:
tolerance 0. ``tests/test_torch_cuda.py`` holds the CUDA kernel against
this plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import aggregate as jk_agg
from repro_torch.kernels import aggregate as tk_agg

from test_torch_kernels import _fake_codes, _t


def _sorted_flags(codes, valid):
    sc, sv, _ = jk_agg.sort_codes(jnp.asarray(codes), jnp.asarray(valid))
    new = sv & jnp.concatenate(
        [jnp.ones((1,), bool), (sc[1:] != sc[:-1]).any(axis=1)]
    )
    return np.asarray(new), np.asarray(sv)


@pytest.mark.parametrize("b", [1, 5, 127, 1000])
@pytest.mark.parametrize("cap", [8, 2048])
def test_seg_unique_plain_matches_pallas(b, cap):
    rng = np.random.default_rng(b + cap)
    new, sv = _sorted_flags(_fake_codes(rng, b), rng.random(b) < 0.8)
    want = jk_agg.seg_unique_pallas(jnp.asarray(new), jnp.asarray(sv), cap,
                                    block=64, interpret=True)
    got = tk_agg.seg_unique_cuda(_t(new), _t(sv), cap)
    for g_, w_, name in zip(got, want, ("src", "counts", "slot", "n")):
        assert g_.dtype == torch.int32, name
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_),
                                      err_msg=name)


def test_seg_unique_empty():
    src, counts, slot, n = tk_agg.seg_unique_cuda(
        torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.bool), 8
    )
    assert int(n) == 0 and slot.shape == (0,) and src.shape == (8,)
    assert not counts.any()
