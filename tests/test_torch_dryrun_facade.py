"""The port's shape-only model members against the JAX package's
``Model`` facade: ``models.lm.{init_shapes, cache_shapes, train_inputs,
decode_inputs}`` for all ten registry archs at their published widths.
Nothing is allocated on either side (``jax.eval_shape`` and the port's
meta skeleton)."""
import jax
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs.base import SHAPE_BY_NAME as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro_torch.configs.base import SHAPE_BY_NAME
from repro_torch.configs.registry import ARCHS
from repro_torch.models import lm

@pytest.fixture(scope="module")
def j_shapes():
    """The reference's parameter shapes of every arch, by the port's
    names: ``jax.eval_shape`` of its init through ``lm.flatten_params``
    (each leaf a zero-stride numpy view, so a stack splits without
    memory)."""
    out = {}
    for name in sorted(J_ARCHS):
        tree = j_build(J_ARCHS[name]).init_shapes(jax.random.PRNGKey(0))
        out[name] = (tree, lm.flatten_params(jax.tree.map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
            tree)))
    return out


def _same_dtype(np_dtype, torch_dtype) -> bool:
    return str(np.dtype(np_dtype)) == str(torch_dtype).rsplit(".", 1)[-1]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_shapes_match_the_reference(arch, j_shapes):
    """Every parameter's name, shape and dtype, from the meta skeleton."""
    got = lm.init_shapes(ARCHS[arch])
    want = j_shapes[arch][1]
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == want[name].shape, name
        assert _same_dtype(want[name].dtype, t.dtype), name


def _tree_pairs(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            yield from _tree_pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield path, got, want


def test_cache_and_input_shapes_match_the_reference():
    """``cache_shapes``, ``train_inputs`` and ``decode_inputs`` (its
    ``pos`` the reference's 0-d int32) of every arch at train_4k and
    decode_32k: the reference's leaves, shape for shape and dtype for
    dtype, as meta tensors."""
    for arch in sorted(ARCHS):
        jm = j_build(J_ARCHS[arch])
        for shape_name in ("train_4k", "decode_32k"):
            shape, jshape = SHAPE_BY_NAME[shape_name], J_SHAPES[shape_name]
            b, s = shape.global_batch, shape.seq_len
            pairs = [("cache", lm.cache_shapes(ARCHS[arch], b, s),
                      jm.cache_shapes(b, s)),
                     ("train", lm.train_inputs(ARCHS[arch], shape),
                      jm.train_inputs(jshape)),
                     ("decode", lm.decode_inputs(ARCHS[arch], shape),
                      jm.decode_inputs(jshape))]
            for what, got, want in pairs:
                for path, g, w in _tree_pairs(got, want):
                    where = (arch, shape_name, what, path)
                    assert g.device.type == "meta", where
                    assert tuple(g.shape) == tuple(w.shape), where
                    assert _same_dtype(w.dtype, g.dtype), where
