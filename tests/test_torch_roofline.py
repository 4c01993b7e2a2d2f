"""The port's roofline (``roofline.analysis``) against the JAX package's —
``count_params`` and ``model_flops_for`` for all ten registry archs and
every shape, ``Roofline``'s terms with the constants passed explicitly —
and the dry run's counting (``roofline.counter``, ``kernels.counting``):
one device's shards counted, the kernels' charges, and a count affine in
depth."""
import dataclasses
import math

import jax
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs.base import SHAPE_BY_NAME as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import counting
from repro_torch.kernels.canonical_check.canonical_check import (
    canonical_check_cuda)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import kept_pairs
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.roofline import analysis, hw
from repro_torch.launch.sharded import dtensor_patches
from repro_torch.roofline.counter import StepCounter


def test_param_counts_and_model_flops_match_the_reference():
    """Every arch's counts (total, embedding, experts) and MODEL_FLOPS at
    every shape, the port's skeleton against the reference's eval_shape
    tree."""
    for arch in sorted(ARCHS):
        tree = j_build(J_ARCHS[arch]).init_shapes(jax.random.PRNGKey(0))
        model = lm.skeleton(ARCHS[arch])
        assert analysis.count_params(model) == janalysis.count_params(tree)
        for shape in SHAPES:
            assert analysis.model_flops_for(ARCHS[arch], shape, model) == \
                janalysis.model_flops_for(J_ARCHS[arch],
                                          J_SHAPES[shape.name], tree)


def test_roofline_terms_and_bottleneck():
    """The reference's terms with its constants passed in, and the H100's
    by default."""
    kw = dict(flops=jhw.PEAK_FLOPS_BF16, hbm_bytes=jhw.HBM_BW * 2,
              coll_bytes=jhw.ICI_BW * 0.5, chips=256,
              model_flops=jhw.PEAK_FLOPS_BF16 * 256 * 0.5)
    r = analysis.Roofline(**kw, hw=jhw)
    want = janalysis.Roofline(**kw).to_dict()
    assert r.to_dict() == want
    assert r.t_memory == pytest.approx(2.0) and r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.25)
    assert r.bound_s == pytest.approx(2.0)
    h = analysis.Roofline(**kw)
    assert h.t_compute == pytest.approx(jhw.PEAK_FLOPS_BF16 / 989e12)
    assert h.t_memory == pytest.approx(jhw.HBM_BW * 2 / 3.35e12)
    assert h.t_collective == pytest.approx(jhw.ICI_BW * 0.5 / hw.ICI_BW)
    assert set(h.to_dict()) == set(want)


def test_from_counts():
    """The analogue of ``from_compiled``: a counter's FLOPs, bytes, the sum
    of its collectives and argument plus peak bytes."""
    c = StepCounter()
    c.flops, c.hbm_bytes = 3.0e12, 5.0e11
    c.collectives = dict.fromkeys(analysis.COLLECTIVES, 1.0e10)
    c.argument_bytes, c.peak_bytes = 7, 11
    r = analysis.from_counts(c, 256, model_flops=1.0e15)
    assert (r.flops, r.hbm_bytes, r.coll_bytes) == (3.0e12, 5.0e11, 5.0e10)
    assert r.per_device_hbm == 18 and r.chips == 256
    assert r.bottleneck == "collective"


def test_counter_counts_one_devices_shards():
    """On the fake 16 x 16 mesh a (256, 4096, 7168) x (7168, 7168) bf16
    product, batch over data and columns over model, counts 1/256 of its
    FLOPs; a gather of the columns is one all-gather of the result's
    bytes, and moving the batch's shards to the sequence one all-to-all
    of a shard; the peak holds the two products' shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with mesh_lib.production_mesh() as m:
        c = StepCounter()
        with c, dtensor_patches(c):
            a = DTensor.from_local(torch.empty(16, 4096, 7168,
                                               dtype=torch.bfloat16),
                                   m, [Shard(0), Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(7168, 448,
                                               dtype=torch.bfloat16),
                                   m, [Replicate(), Shard(1)],
                                   run_check=False)
            c.start()
            y = a @ w
            assert y.to_local().shape == (16, 4096, 448)
            z = y.redistribute(m, [Shard(0), Replicate()])
            moved = y.redistribute(m, [Shard(1), Shard(2)])
            c.stop()
    assert c.flops == 2 * 256 * 4096 * 7168 * 7168 / 256
    local = 16 * 4096 * 448 * 2
    # batch shards to sequence shards: one all-to-all of the shard
    assert moved.to_local().shape == (256, 256, 448)
    assert c.collectives["all-to-all"] == local
    assert c.collectives["all-gather"] == 16 * local
    assert c.hbm_bytes >= (16 * 4096 * 7168 + 7168 * 448) * 2 + local
    assert c.peak_bytes >= local + 16 * local
    del z


def test_kernels_charge_instead_of_running():
    """Under the counting mode each wrapper charges its kernel's formula
    (flash attention without its (Sq, Sk) scores) and returns an empty
    output of the kernel's shape; outside it, the plain versions run."""
    assert kept_pairs(5, 5, True) == 15
    assert kept_pairs(6, 6, True, window=2) == 11
    assert kept_pairs(3, 7, False) == 21
    for sq, w in ((64, 0), (64, 16), (100, 7)):
        brute = sum(min(i + 1, w or sq) for i in range(sq))
        assert kept_pairs(sq, sq, True, w) == brute
    c = StepCounter()
    with c, counting.counting(c):
        c.start()
        q = torch.empty(2, 64, 8, 32, dtype=torch.bfloat16)
        k = torch.empty(2, 64, 2, 32, dtype=torch.bfloat16)
        o = flash_attention(q, k, k)
        x = torch.empty(10, 48, dtype=torch.bfloat16)
        y = rmsnorm(x, torch.empty(48, dtype=torch.bfloat16))
        mem = torch.empty(20, 3, dtype=torch.int32)
        ok = canonical_check_cuda(mem, mem[:, 0], mem[:, 0],
                                  torch.empty(50, 2, dtype=torch.int32))
    assert o.shape == q.shape and y.shape == x.shape and ok.shape == (20,)
    assert dict(c.charged) == {"flash_attention": 1, "rmsnorm": 1,
                               "canonical_check": 1}
    fl = c.flops_by_op
    assert fl["flash_attention"] == 4 * 32 * kept_pairs(64, 64, True) * 16
    assert fl["rmsnorm"] == 4 * 10 * 48
    assert counting.active() is None
    x = torch.randn(4, 16)
    assert torch.equal(rmsnorm(x, torch.ones(16)),
                       x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5))


def test_count_is_affine_in_depth():
    """A reduced dense arch's train step counted at 1, 2 and 3 layers: each
    layer adds the same FLOPs, bytes and collective bytes (the port's loop
    counts every layer, so no depth ladder is needed)."""
    base = ARCHS["qwen2.5-14b"].reduced()
    shape = ShapeConfig("t", 128, 32, "train")
    got = []
    for n in (1, 2, 3):
        cfg = dataclasses.replace(base, n_layers=n)
        with mesh_lib.production_mesh() as m:
            c, _ = dryrun.count_program(cfg, shape, m)
        got.append((c.flops, c.hbm_bytes, sum(c.collectives.values())))
    for i in range(3):
        d1, d2 = got[1][i] - got[0][i], got[2][i] - got[1][i]
        assert d1 > 0 and math.isclose(d1, d2, rel_tol=1e-9), (i, got)


@pytest.fixture
def strict_views(monkeypatch):
    """DTensor's view rules as some torch releases have them: a view that
    would leave a strided shard (a flatten over a non-first sharded
    dimension, a split that a sharded dimension does not lead) raises
    instead. Cached strategies are dropped so that the rule is consulted."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import _view_ops as V
    from torch.distributed.tensor.placement_types import _StridedShard

    plain = V.propagate_shape_and_sharding

    def strict(src, shape, rule, mesh_sizes, strict_view=False):
        tgt, out = plain(src, shape, rule, mesh_sizes, strict_view)
        if (any(isinstance(p, _StridedShard) for p in out)
                and not any(isinstance(p, _StridedShard) for p in src)):
            raise RuntimeError(f"a strided shard from {list(src)} {shape}")
        return tgt, out

    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta"):
        getattr(getattr(prop, name, None), "cache_clear", lambda: None)()
    monkeypatch.setattr(V, "propagate_shape_and_sharding", strict)


@pytest.mark.parametrize("arch,shape", [("stablelm-1.6b", "decode_32k"),
                                        ("whisper-base", "decode_32k"),
                                        ("zamba2-2.7b", "prefill_32k")])
def test_cells_count_under_strict_view_rules(arch, shape, strict_views):
    """One layer of a cell at its published widths counts under the
    strict view rules: the decode steps' merges of heads, a MoE-free
    hybrid's scan and its column-parallel projections keep to views every
    torch release can shard."""
    cfg = ARCHS[arch]
    cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every or 1,
                              encoder_layers=min(cfg.encoder_layers, 1))
    with mesh_lib.production_mesh() as m:
        c, _ = dryrun.count_program(cfg, SHAPE_BY_NAME[shape], m)
    assert c.flops > 0 and c.hbm_bytes > 0
