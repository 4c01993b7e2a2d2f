"""Shared model layers of the dense decoder, port of ``repro.models.layers``:
init helpers, RMSNorm, RoPE, grouped-query attention (full sequence and
one-token decode) and the SwiGLU MLP. Parameters live in ``nn.Module``s
under the JAX package's names (``wq.w``, ``wq.b``, ``w_gate.w``, ...) in
its ``(d_in, d_out)`` layout, used as ``x @ w``, so carrying weights across
is a copy. bf16 parameters and activations, f32 reductions.

On a CUDA tensor :func:`rmsnorm` launches the RMSNorm kernel and
:func:`gqa_attention` the flash-attention kernel; on a CPU tensor both
take their kernels' plain versions. The sharding helpers of the reference
(``constrain``, ``activation_sharding``, ``spec_for``,
``build_param_specs``, ``LAYOUT``) have no meaning on one card and are not
ported; MLA and MoE raise ``NotImplementedError`` (ROADMAP.md queue A
item 6).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel

DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, cast to
    bf16 (the reference's ``_normal``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(DTYPE)


def _param(t: torch.Tensor) -> nn.Parameter:
    # inference only: no autograd graph is ever recorded
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` (d_in, d_out)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class Init:
    """Parameter factory drawing from one ``torch.Generator`` on the target
    device (the reference splits a JAX key instead: the two give different
    numbers from the same seed, so the parity tests carry weights across)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def normal(self, shape, scale) -> torch.Tensor:
        return _normal(self.gen, shape, scale)

    def ones(self, n) -> torch.Tensor:
        return torch.ones((n,), dtype=DTYPE, device=self.device)

    def dense(self, d_in, d_out, scale=None, bias=False) -> Dense:
        scale = scale if scale is not None else d_in ** -0.5
        w = self.normal((d_in, d_out), scale)
        b = torch.zeros((d_out,), dtype=DTYPE, device=self.device) if bias else None
        return Dense(w, b)


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    """The RMSNorm kernel's function (f32 statistics and scale, one
    rounding): on a CUDA tensor the kernel, on a CPU tensor its plain
    version. The reference's jnp version rounds before the scale; the two
    agree exactly while the scale is 1 (every norm at init)."""
    return _rmsnorm_kernel(x, scale, eps)


def rope_freqs(positions, dim, theta):
    """positions (...,) -> cos/sin (..., dim//2) fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., H, dh) with cos/sin (..., dh//2); rotates pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: GQA (full sequence + decode)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_gqa(cfg: ArchConfig, ini: Init) -> Attention:
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP.md queue A item 6)")
    dh = cfg.head_dim
    return Attention(
        wq=ini.dense(cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias),
        wk=ini.dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        wv=ini.dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        wo=ini.dense(cfg.n_heads * dh, cfg.d_model),
    )


def _proj(x, p: Dense):
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def gqa_attention(cfg: ArchConfig, p: Attention, x, positions):
    """Full-sequence causal attention. x (B,S,d); positions (B,S) = 0..S-1
    (the RoPE angles; the kernel's causal mask is 0..S-1 too).

    The attention itself is the flash-attention kernel (its plain version
    on a CPU tensor): scale D^-1/2 on the f32 scores, KV head h // G read
    at its strides. On the card in bf16 it rounds the softmax weights to
    bf16 before the weighted sum, as the reference's ``_sdpa`` does (an
    online softmax, so per 128-key tile and before the division by the
    sum); the plain version keeps them in f32. The windowed and non-causal
    attention of the hybrid and encoder families is not ported (ROADMAP.md
    queue A item 6)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = _proj(x, p.wq).reshape(b, s, cfg.n_heads, dh)
    k = _proj(x, p.wk).reshape(b, s, cfg.n_kv_heads, dh)
    v = _proj(x, p.wv).reshape(b, s, cfg.n_kv_heads, dh)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v).reshape(b, s, cfg.n_heads * dh)
    return _proj(o, p.wo)


def gqa_decode(cfg: ArchConfig, p: Attention, x, cache_k, cache_v, pos: int):
    """One-token decode. x (B,1,d); cache_k/v (B,S,kv,dh); ``pos`` the
    current index, a Python int (so no host sync). Writes this token's k/v
    into the caches IN PLACE (the reference's immutable
    ``dynamic_update_slice`` returns new caches) and returns
    ``(out, cache_k, cache_v)``."""
    b = x.shape[0]
    dh = cfg.head_dim
    q = _proj(x, p.wq).reshape(b, 1, cfg.n_heads, dh)
    k = _proj(x, p.wk).reshape(b, 1, cfg.n_kv_heads, dh)
    v = _proj(x, p.wv).reshape(b, 1, cfg.n_kv_heads, dh)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_freqs(posv, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)

    g = cfg.n_heads // cfg.n_kv_heads
    q = q.reshape(b, cfg.n_kv_heads, g, dh)
    # only slots 0..pos are valid: the reference masks the rest to -1e30,
    # whose softmax weight is exactly 0, so reading the prefix is the same
    keys = cache_k[:, :pos + 1].to(x.dtype)
    vals = cache_v[:, :pos + 1].to(x.dtype)
    scores = torch.einsum("bhgd,bkhd->bhgk", q.float(), keys.float()) * dh ** -0.5
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bhgk,bkhd->bhgd", w, vals).reshape(b, 1, cfg.n_heads * dh)
    return _proj(o, p.wo), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, w_gate: Dense, w_in: Dense, w_out: Dense):
        super().__init__()
        self.w_gate, self.w_in, self.w_out = w_gate, w_in, w_out


def init_mlp(d_model, d_ff, ini: Init) -> MLP:
    return MLP(
        w_gate=ini.dense(d_model, d_ff),
        w_in=ini.dense(d_model, d_ff),
        w_out=ini.dense(d_ff, d_model),
    )


def mlp(p: MLP, x):
    h = torch.nn.functional.silu(x @ p.w_gate.w) * (x @ p.w_in.w)
    return h @ p.w_out.w
