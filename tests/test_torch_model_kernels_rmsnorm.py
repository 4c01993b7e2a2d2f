"""The plain version of the port's RMSNorm kernel (what its wrapper runs
on a CPU tensor) against the JAX package's kernel
(``rmsnorm(..., interpret=True)``) and its model stack's norm, on the same
inputs made with numpy from a seed.

Tolerances: f32 1e-5, the same arithmetic summed in another order; bf16:
both sides compute in f32 and round once, so they differ by at most one
bf16 rounding step (relative 2^-7).
"""
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models.layers import rmsnorm as jrmsnorm_model
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_ref

from test_torch_model_kernels import _both, _f32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 256, 512), (2, 100, 64), (1, 7, 128),
                                   (3, 5, 5120)])
def test_rmsnorm_plain_version_matches_reference_kernel(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    (xj, xt), (sj, st) = _both(x, dtype), _both(s, dtype)
    want = _f32(jrmsnorm(xj, sj, interpret=True))
    got = rmsnorm(xt, st)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, atol=1e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(_f32(got), want, atol=0, rtol=2**-7)
    # the wrapper's CPU route is the plain version
    np.testing.assert_array_equal(
        _f32(rmsnorm_cuda(xt.reshape(-1, shape[-1]), st)),
        _f32(rmsnorm_ref(xt.reshape(-1, shape[-1]), st)))


@pytest.mark.parametrize("dtype,scale_dtype", [("bfloat16", "float32"),
                                               ("float32", "bfloat16")])
def test_rmsnorm_takes_a_scale_of_another_type(dtype, scale_dtype):
    """As the TPU kernel casts any scale to f32, the port takes a scale of
    either kernel type for x of either, and answers in x's type."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 640)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(640)).astype(np.float32)
    (xj, xt), (sj, st) = _both(x, dtype), _both(s, scale_dtype)
    want = _f32(jrmsnorm(xj, sj, interpret=True))
    got = rmsnorm(xt, st)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, atol=1e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(_f32(got), want, atol=0, rtol=2**-7)


def test_rmsnorm_equals_model_stack_at_unit_scale():
    """The reference's model-stack rmsnorm rounds before the scale: with the
    scale at 1 (every norm at init) the two are equal bit for bit."""
    x = np.random.default_rng(1).standard_normal((6, 96)).astype(np.float32)
    (xj, xt), (sj, st) = _both(x, "bfloat16"), _both(np.ones(96, np.float32),
                                                      "bfloat16")
    np.testing.assert_array_equal(_f32(rmsnorm(xt, st)),
                                  _f32(jrmsnorm_model(xj, sj)))
