"""The port's sharding rules against the JAX package's:
``layers.spec_for``, ``layers.build_param_specs`` and
``optimizer.opt_state_specs`` on both production meshes and under both
layouts, for all ten registry archs at their published widths, and the
specs' DTensor placements. Nothing is allocated on either side
(``jax.eval_shape`` and the port's meta skeleton). The reference's rules
read only a mesh's ``axis_names``, ``devices.shape`` and ``shape``, so a
plain stand-in serves them, with no 256-device JAX mesh."""
import types

import jax
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.training.optimizer import opt_state_specs as j_opt_state_specs
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training.optimizer import opt_state_specs

MESH_SIZES = {"data": 16, "model": 16}
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def stand_in(name):
    """What the reference's rules read of a mesh (and the port's)."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(
        axis_names=axes, devices=types.SimpleNamespace(shape=shape),
        shape=dict(zip(axes, shape)))


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


def norm(spec):
    """A spec as a tuple, a one-axis tuple entry as its axis (jax's
    PartitionSpec makes that normalisation itself)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("path,shape,want", [
    # ZeRO-1 layout: plain weights are tensor-parallel only
    ("layers/attn/wq/w", (7168, 7168), L.P(None, "model")),
    ("layers/mlp/w_out/w", (20480, 7168), L.P("model", None)),
    ("layers/moe/experts/w_gate", (160, 5120, 1536),
     L.P("model", ("data",), None)),
    ("embed", (102400, 5120), L.P(("data",), "model")),
    ("unembed", (5120, 102400), L.P(None, "model")),
    # whisper's vocabulary 51865 is not divisible by 16: replicated
    ("unembed", (512, 51865), L.P(None, None)),
    ("layers/ln1", (64,), L.P(None)),
])
def test_spec_for_rules(path, shape, want):
    """``tests/test_dryrun_units.py``'s five rules, and the reference's own
    answer for each."""
    got = L.spec_for(path, shape, MESH_SIZES, ("data",))
    assert got == want
    assert norm(got) == norm(JL.spec_for(path, shape, MESH_SIZES,
                                         ("data",)))


def _with_layout(layout, fn):
    tokens = (L.LAYOUT.set(layout), JL.LAYOUT.set(layout))
    try:
        return fn()
    finally:
        L.LAYOUT.reset(tokens[0])
        JL.LAYOUT.reset(tokens[1])


def _j_flat(tree):
    """A reference spec tree by the port's names (the stacked specs whole,
    keyed without stack indices)."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = norm(spec)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", ["opt", "baseline"])
def test_param_specs_match_the_reference(mesh, layout, j_shapes):
    """Every parameter of every arch: the port's spec (per layer) is the
    reference's (per stacked leaf) without its leading stack entries, and
    those are all ``None``."""
    m = stand_in(mesh)
    fsdp = tuple(a for a in m.axis_names if a in ("pod", "data"))
    for arch in sorted(ARCHS):
        tree = j_shapes[arch][0]
        want = _with_layout(layout, lambda: _j_flat(
            JL.build_param_specs(tree, m, fsdp)))
        got = _with_layout(layout, lambda: L.build_param_specs(
            lm.skeleton(ARCHS[arch]), m, fsdp))
        for name, spec in got.items():
            path, idx = L.reference_path(name)
            ref = want[path]
            assert all(e is None for e in ref[:len(idx)]), (arch, name)
            assert norm(spec) == ref[len(idx):], (arch, layout, name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_opt_state_specs_match_the_reference(mesh, j_shapes):
    """ZeRO-1 state specs of every arch: the reference's, less its leading
    stack entries, wherever the reference puts the data axes inside a
    layer. Where it puts them on a stack axis (a per-layer tensor has
    none), the port applies the rule to the layer's own dimensions: the
    first unsharded one the data axes divide."""
    m = stand_in(mesh)
    fsdp = tuple(a for a in m.axis_names if a in ("pod", "data"))
    n_stack_axis = 0
    for arch in sorted(ARCHS):
        tree = j_shapes[arch][0]
        jspecs = JL.build_param_specs(tree, m, fsdp)
        want = _j_flat(j_opt_state_specs(jspecs, tree, m, fsdp).master)
        model = lm.skeleton(ARCHS[arch])
        params = dict(model.named_parameters())
        got = opt_state_specs(L.build_param_specs(model, m, fsdp), params,
                              m, fsdp)
        assert got.step == L.P() and got.m is got.master
        for name, spec in got.master.items():
            path, idx = L.reference_path(name)
            ref = want[path]
            if all(e is None for e in ref[:len(idx)]):
                assert norm(spec) == ref[len(idx):], (arch, name)
                continue
            n_stack_axis += 1
            inner = ref[len(idx):]
            assert norm([fsdp])[0] not in inner
            fs = int(np.prod([m.shape[a] for a in fsdp]))
            free = [i for i, (e, d) in enumerate(zip(inner,
                                                     params[name].shape))
                    if e is None and d % fs == 0 and d >= fs]
            exp = list(inner)
            if free:
                exp[free[0]] = fsdp
            assert norm(spec) == norm(exp), (arch, name)
    if mesh == "single":
        assert n_stack_axis > 0       # qwen's, llama4's, internvl2's 48


def test_spec_placements_on_a_device_mesh():
    """A spec becomes DTensor placements on a torch mesh's named
    dimensions: Shard(i) where dimension i names the axis (alone or in a
    tuple), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert L.spec_placements(L.P(("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert L.spec_placements(L.P(None, None), m) == [Replicate()] * 3
