"""The plain version of the port's stream compaction (what its wrapper
runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it, on the same numpy
inputs. Outputs are integers: tolerance 0. ``tests/test_torch_cuda.py``
holds the CUDA kernel against this plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compact import stream_compact_pallas
from repro_torch.kernels import compact as tk_compact

from test_torch_kernels import _t


@pytest.mark.parametrize("b", [0, 1, 5, 1000])
@pytest.mark.parametrize("out_cap", [1, 64, 2048])
def test_stream_compact_plain_matches_pallas(b, out_cap):
    rng = np.random.default_rng(b + out_cap)
    keep = rng.random(b) < 0.3
    idx_k, cnt_k = stream_compact_pallas(jnp.asarray(keep), out_cap,
                                         block=64, interpret=True)
    idx_t, cnt_t = tk_compact.stream_compact_cuda(_t(keep), out_cap)
    # the count is the UNCLAMPED kept total, a 0-d int32 on the device
    assert cnt_t.shape == () and cnt_t.dtype == torch.int32
    assert int(cnt_t) == int(cnt_k) == int(keep.sum())
    assert idx_t.dtype == torch.int32 and idx_t.shape == (out_cap,)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_k))
