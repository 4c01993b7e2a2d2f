"""The model zoo's configs and kernels in the port against the JAX package,
on the CPU: the port's own copy of the configs equals ``repro.configs``
field by field, and the plain versions of the RMSNorm and flash-attention
kernels (what their wrappers run on a CPU tensor) equal the reference's
kernel (``rmsnorm(..., interpret=True)``) and oracle
(``flash_attention/ref.py:attention_ref`` with the GQA mapping of
``ops.py``) on the same inputs, made with numpy from a seed.

Tolerances: f32 1e-5 (rmsnorm) and 2e-5 (attention, the JAX package's own
kernel-test bound): the same f32 arithmetic summed in another order. bf16:
both sides compute in f32 and round once, so they differ by at most one
bf16 rounding step (relative 2^-7) for rmsnorm, and by the JAX package's
own 2e-2 for attention."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro.models import layers as JL
from repro.models.layers import rmsnorm as jrmsnorm_model
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, flash_attention_ref, kernel_strides, tma_readable,
)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_ref
from repro_torch.models.layers import attention_narrow_v

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of
    ``dtype`` (both round f32 to bf16 to nearest even)."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_equal_reference(name):
    j, t = JARCHS[name], configs.get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.head_dim, t.is_subquadratic, t.has_decoder) == (
        j.head_dim, j.is_subquadratic, j.has_decoder)
    module = name.replace(".", "_").replace("-", "_")
    port_mod = __import__(f"repro_torch.configs.{module}", fromlist=["CONFIG"])
    assert port_mod.CONFIG == t


def test_shapes_and_runnable_cells_equal_reference():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == [
        dataclasses.asdict(s) for s in jbase.SHAPES]
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == [
        f.name for f in dataclasses.fields(jbase.ArchConfig)]
    for name in sorted(JARCHS):
        for js, ts in zip(jbase.SHAPES, tbase.SHAPES):
            assert tbase.cell_is_runnable(configs.ARCHS[name], ts) == \
                jbase.cell_is_runnable(JARCHS[name], js)
            assert ts.is_decode == js.is_decode
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _bhsd(a):
    """(B, S, H, D) -> the reference kernel's (B*H, S, D)."""
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bh,sq,sk,d,causal",
    [
        (2, 128, 128, 64, True),
        (2, 256, 256, 64, True),
        (1, 128, 256, 128, False),
        (3, 256, 256, 128, True),
        (2, 200, 200, 16, True),      # ragged: no multiple of any tile
        (1, 77, 130, 40, True),       # Sq != Sk, start-aligned mask
    ],
)
def test_flash_plain_version_matches_reference_oracle(bh, sq, sk, d, causal,
                                                      dtype):
    rng = np.random.default_rng(0)
    # the reference's (B*H, S, D) as one batch of B*H heads, H = KV
    q = rng.standard_normal((1, sq, bh, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, bh, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, bh, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = _f32(attention_ref(_bhsd(qj), _bhsd(kj), _bhsd(vj), causal=causal))
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_bhsd(_f32(got)), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,kv,d", [(2, 128, 8, 2, 64), (1, 50, 9, 3, 64),
                                        (2, 33, 5, 1, 128)])
def test_flash_gqa_mapping_matches_reference(b, s, h, kv, d):
    """Head h reads KV head h // (H / KV): the reference wrapper's
    ``jnp.repeat`` of the KV heads, rebuilt around its oracle."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    kk = jnp.repeat(jnp.asarray(k), h // kv, axis=2)
    vv = jnp.repeat(jnp.asarray(v), h // kv, axis=2)
    want = attention_ref(_bhsd(jnp.asarray(q)), _bhsd(kk), _bhsd(vv))
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    got = flash_attention_cuda(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(
        got.numpy(),
        flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v))).numpy())


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 1, 40, 40),            # each query keeps only itself
    (True, 5, 40, 40),
    (True, 64, 200, 200),         # past a 128-row tile: the kernel skips tiles
    (False, 7, 30, 30),           # a window without the causal mask
    (True, 6, 20, 33),            # Sq != Sk, start-aligned
])
def test_flash_window_matches_reference_sdpa(causal, window, sq, sk):
    """The window of the plain version (the wrapper's CPU route) against
    the reference's ``_sdpa``, which masks k_pos <= q_pos - window, with
    GQA (4 heads over 2), f32 at the JAX package's 2e-5."""
    rng = np.random.default_rng(4)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    pos = lambda s: jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = JL._sdpa(jnp.asarray(q).reshape(b, sq, kv, h // kv, d),
                    jnp.asarray(k), jnp.asarray(v), pos(sq), pos(sk),
                    d ** -0.5, causal, window)
    want = _f32(want).reshape(b, sq, h, d)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=2e-5)
    if window < sk:
        full = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal)
        assert np.abs(_f32(full) - _f32(got)).max() > 1e-2   # the window acts


@pytest.mark.parametrize("s,dk,dv", [(40, 24, 16), (1024, 192, 128)])
def test_mla_narrow_v_route_matches_blocked_attention(s, dk, dv):
    """MLA's route through the flash kernel (v zero-padded to the q/k head
    dim, the output sliced back) against the reference's
    ``blocked_attention`` with Dk != Dv (at S = 1,024 over its 512-query
    blocks), the scale Dk^-1/2 in both; f32 at 2e-5."""
    rng = np.random.default_rng(5)
    b, h = 1, 3
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = JL.blocked_attention(jnp.asarray(q)[:, :, :, None, :],
                                jnp.asarray(k), jnp.asarray(v), pos,
                                dk ** -0.5)
    want = _f32(want).reshape(b, s, h, dv)
    got = attention_narrow_v(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(_f32(got), want, atol=2e-5, rtol=2e-5)


def _tiled_bf16_flash(q, k, v, causal=True, block_k=128):
    """Tile-by-tile emulation of the card kernel's bf16 arithmetic
    (``csrc/flash_attention.cu``, ``flash_attention_tc``): q (B, Sq, H, D),
    k/v (B, Sk, KV, D) in bf16; per ``block_k``-row K/V tile the f32 scores
    Q K^T, the causal and ragged mask, an f32 running max and sum with the
    scale and log2 e folded into one exp2, P rounded to bf16 before an f32
    PV, then one division by the sum and one rounding to bf16."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)
    kh, vh = (t.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        s = qh @ kh[:, :, k0:k0 + block_k].transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, min(k0 + block_k, sk))[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m == float("-inf"), 0.0,
                            torch.exp2((m - m_new) * scale_log2))
        shift = torch.where(m_new == float("-inf"), 0.0, m_new * scale_log2)
        p = torch.exp2(s * scale_log2 - shift)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vh[:, :, k0:k0 + block_k]
        m = m_new
    out = torch.where(l > 0, o / l, 0.0)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def test_bf16_tile_arithmetic_holds_the_kernel_bound():
    """The card kernel's bf16 design (P rounded to bf16 per 128-row K tile,
    f32 running max and sum), emulated on the CPU, stays within the JAX
    package's bf16 bound for this kernel (2e-2) of the plain version and of
    the reference oracle, at B=1, S=300, 4 over 2 heads of 64. Head 0's row
    250 is steered onto key 200, so its scores span more than 30 units and
    its running max jumps in the second tile."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 1, 300, 4, 2, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    q[0, 250, 0] = 45.0 * k[0, 200, 0] / np.linalg.norm(k[0, 200, 0])
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in (q, k, v))
    scores = (qt[0, 250, 0].float() @ kt[0, :251, 0].float().T) / math.sqrt(d)
    assert float(scores.max() - scores.min()) >= 30
    got = _tiled_bf16_flash(qt, kt, vt)
    assert got.shape == qt.shape and got.dtype == torch.bfloat16
    want = flash_attention_ref(qt, kt, vt)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    kk = jnp.repeat(kj, h // kv, axis=2)
    vv = jnp.repeat(vj, h // kv, axis=2)
    oracle = attention_ref(_bhsd(qj), _bhsd(kk), _bhsd(vv))
    oracle = _f32(oracle).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), oracle, atol=2e-2, rtol=2e-2)


def test_tma_readability_and_kernel_strides():
    """Where the bf16 wrapper reads a tensor in place (TMA's 16-byte rules)
    and which strides it hands the kernel."""
    qkv = torch.zeros((2, 5, 12, 64), dtype=torch.bfloat16)
    k = qkv[:, :, 8:10]                       # a fused projection's view
    assert tma_readable(k) and kernel_strides(k) == [3840, 768, 64]
    flat = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=torch.bfloat16)
    assert not tma_readable(flat[1:].view(2, 5, 4, 64))   # base off by 2 B
    assert not tma_readable(torch.zeros((1, 4, 2, 12),
                                        dtype=torch.bfloat16)[..., :8])
    assert not tma_readable(qkv.transpose(2, 3)[..., :8])  # D strided
    one = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
    assert tma_readable(one) and kernel_strides(one) == [64, 64, 16]
    odd = torch.zeros((1, 3, 1, 16), dtype=torch.bfloat16).as_strided(
        (1, 3, 1, 16), (7, 16, 5, 1))         # size-1 strides never used
    assert tma_readable(odd) and kernel_strides(odd) == [48, 16, 16]


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA device has no route."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        rmsnorm_cuda(x, torch.empty(8, device="meta"))
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        flash_attention_cuda(q, q, q)
