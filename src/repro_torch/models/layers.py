"""Shared model layers, port of ``repro.models.layers``: init helpers,
RMSNorm, RoPE, grouped-query attention (full sequence, with the causal
mask or without it and with a sliding window, and one-token decode),
DeepSeek-V2's multi-head latent attention (MLA: full sequence and the
absorbed-weight decode), the SwiGLU MLP and the top-k mixture of experts
(grouped, sorted, capacity-bounded dispatch). Parameters live in
``nn.Module``s under the JAX package's names (``wq.w``, ``wq.b``,
``w_gate.w``, ``experts.w_gate``, ...) in its ``(d_in, d_out)`` layout,
used as ``x @ w``, so carrying weights across is a copy. bf16 parameters
and activations, f32 reductions.

On a CUDA tensor :func:`rmsnorm` launches the RMSNorm kernel, and
:func:`gqa_attention`, :func:`mla_attention` and the encoder-decoder's
cross-attention the flash-attention kernel; on a CPU tensor they take the
kernels' plain versions. Where autograd records (training), both kernels'
gradients are their backward kernels on the card (each kernel's
``torch.autograd.Function``), and autograd differentiates the plain
versions on the CPU. :func:`cross_entropy` is the reference's loss. The
decode steps and the MoE stay plain PyTorch, as the reference computes
them outside any Pallas kernel. The sharding
helpers of the reference (``constrain``, ``activation_sharding``,
``spec_for``, ``build_param_specs``, ``LAYOUT``) have no meaning on one
card and are not ported: the MoE's token groups are the reference's count
without an activation context (8).
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
    # trainable; serving runs under torch.inference_mode, which records no
    # graph whatever a parameter's requires_grad
    return nn.Parameter(t)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` (d_in, d_out)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class Init:
    """Parameter factory drawing from one ``torch.Generator`` on the target
    device (the reference splits a JAX key instead: the two give different
    numbers from the same seed, so the parity tests carry weights across).
    Without a generator it makes the shapes only, on the ``meta`` device
    (the skeleton that :func:`~repro_torch.models.lm.model_from_numpy`
    fills)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen

    @property
    def device(self) -> torch.device:
        return torch.device("meta") if self.gen is None else self.gen.device

    def normal(self, shape, scale) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=DTYPE, device="meta")
        return _normal(self.gen, shape, scale)

    def ones(self, n) -> torch.Tensor:
        return torch.ones((n,), dtype=DTYPE, device=self.device)

    def zeros(self, n) -> torch.Tensor:
        return torch.zeros((n,), dtype=DTYPE, device=self.device)

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
    agree exactly while the scale is 1 (every norm at init). Its result
    takes the promoted type of x and the scale, as the reference's does (a
    bf16 x under an f32 scale gives f32: the bf16 values, widened)."""
    out = _rmsnorm_kernel(x, scale, eps)
    want = torch.promote_types(x.dtype, scale.dtype)
    return out if out.dtype == want else out.to(want)


def cross_entropy(logits, labels):
    """Mean next-token loss, the reference's: f32 log-sum-exp minus the
    gold logit, gathered (no one-hot of the vocabulary). logits (..., V),
    labels (...) int -> () f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def _promoted(*ts):
    """``ts`` in their promoted type: JAX promotes a bf16 x f32 product to
    f32 where PyTorch's matmul and einsum refuse mixed types. The model's
    own bf16 weights meet bf16 activations and are never copied here."""
    want = ts[0].dtype
    for t in ts[1:]:
        want = torch.promote_types(want, t.dtype)
    return [t if t.dtype == want else t.to(want) for t in ts]


def matmul(a, b):
    a, b = _promoted(a, b)
    return a @ b


def einsum(eq, *ts):
    return torch.einsum(eq, *_promoted(*ts))


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
    dh = cfg.head_dim
    return Attention(
        wq=ini.dense(cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias),
        wk=ini.dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        wv=ini.dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        wo=ini.dense(cfg.n_heads * dh, cfg.d_model),
    )


def _proj(x, p: Dense):
    y = matmul(x, p.w)
    if p.b is not None:
        y = y + p.b
    return y


def gqa_attention(cfg: ArchConfig, p: Attention, x, positions, *,
                  causal=True, window=0):
    """Full-sequence attention. x (B,S,d); positions (B,S) = 0..S-1 (the
    RoPE angles; the kernel's causal mask and window count 0..S-1 too).
    ``causal=False`` attends to every key (the encoder); ``window`` > 0
    also drops the keys at or before ``q_pos - window`` (the hybrid's
    sliding window), both in the kernel.

    The attention itself is the flash-attention kernel (its plain version
    on a CPU tensor): scale D^-1/2 on the f32 scores, KV head h // G read
    at its strides. On the card in bf16 it rounds the softmax weights to
    bf16 before the weighted sum, as the reference's ``_sdpa`` does (an
    online softmax, so per 128-key tile and before the division by the
    sum); the plain version keeps them in f32."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = _proj(x, p.wq).reshape(b, s, cfg.n_heads, dh)
    k = _proj(x, p.wk).reshape(b, s, cfg.n_kv_heads, dh)
    v = _proj(x, p.wv).reshape(b, s, cfg.n_kv_heads, dh)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal, window)
    return _proj(o.reshape(b, s, cfg.n_heads * dh), p.wo)


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


# ---- MLA ------------------------------------------------------------------

class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention (arXiv:2405.04434 §2.1)."""

    def __init__(self, wq_a: Dense, q_norm, wq_b: Dense, wkv_a: Dense,
                 kv_norm, wk_b: Dense, wv_b: Dense, wo: Dense):
        super().__init__()
        self.wq_a, self.wq_b, self.wkv_a = wq_a, wq_b, wkv_a
        self.q_norm, self.kv_norm = _param(q_norm), _param(kv_norm)
        self.wk_b, self.wv_b, self.wo = wk_b, wv_b, wo


def init_mla(cfg: ArchConfig, ini: Init) -> MLA:
    dq = cfg.nope_head_dim + cfg.rope_head_dim
    return MLA(
        wq_a=ini.dense(cfg.d_model, cfg.q_lora),          # q down
        q_norm=ini.ones(cfg.q_lora),
        wq_b=ini.dense(cfg.q_lora, cfg.n_heads * dq),     # q up (nope+rope)
        wkv_a=ini.dense(cfg.d_model, cfg.kv_lora + cfg.rope_head_dim),
        kv_norm=ini.ones(cfg.kv_lora),
        wk_b=ini.dense(cfg.kv_lora, cfg.n_heads * cfg.nope_head_dim),
        wv_b=ini.dense(cfg.kv_lora, cfg.n_heads * cfg.v_head_dim),
        wo=ini.dense(cfg.n_heads * cfg.v_head_dim, cfg.d_model),
    )


def _mla_q(cfg: ArchConfig, p: MLA, x):
    """The query through its low-rank bottleneck: (..., H * (dn + dr))."""
    return _proj(rmsnorm(_proj(x, p.wq_a), p.q_norm, cfg.norm_eps), p.wq_b)


def mla_attention(cfg: ArchConfig, p: MLA, x, positions):
    """Full-sequence MLA; materialises per-head K/V from the latent. The
    reference folds rope and nope into one q/k head dim (dn + dr) beside v
    at dv; the flash kernel takes one head dim for k and v, so v goes
    through :func:`attention_narrow_v` (zero-padded to dn + dr, exact)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    if dv > dn + dr:
        raise ValueError(f"MLA v head dim {dv} above the q/k head dim "
                         f"{dn + dr}: zero-padding v cannot reach it")
    q = _mla_q(cfg, p, x).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv = _proj(x, p.wkv_a)
    c_kv, k_rope = kv[..., :cfg.kv_lora], kv[..., cfg.kv_lora:]
    c_kv = rmsnorm(c_kv, p.kv_norm, cfg.norm_eps)
    k_nope = _proj(c_kv, p.wk_b).reshape(b, s, h, dn)
    v = _proj(c_kv, p.wv_b).reshape(b, s, h, dv)

    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # shared by heads

    q_cat = torch.cat([q_nope, q_rope], dim=-1)               # (b,s,h,dn+dr)
    k_cat = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    o = attention_narrow_v(q_cat, k_cat, v)
    return _proj(o.reshape(b, s, h * dv), p.wo)


def attention_narrow_v(q, k, v, causal=True):
    """Causal attention whose v head dim Dv is below q's and k's Dk,
    through the flash kernel, which takes one head dim: v zero-padded to
    Dk, the output sliced back to Dv. Exact: the scale stays Dk^-1/2 and
    the zero columns add nothing to the kept ones. q (B,S,H,Dk), k
    (B,S,KV,Dk), v (B,S,KV,Dv) -> (B,S,H,Dv)."""
    dk, dv = k.shape[-1], v.shape[-1]
    v_pad = torch.nn.functional.pad(v, (0, dk - dv))
    return flash_attention(q, k, v_pad, causal)[..., :dv]


def mla_decode(cfg: ArchConfig, p: MLA, x, cache_ckv, cache_krope, pos: int):
    """Absorbed-weight MLA decode: the cache holds only the compressed
    latent (kv_lora) and the shared rope key (rope_head_dim) per token,
    written IN PLACE at ``pos`` (a Python int); W_k_b is absorbed into q
    and W_v_b applied after the weighted sum. Returns
    ``(out, cache_ckv, cache_krope)``."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q = _mla_q(cfg, p, x).reshape(b, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_freqs(posv, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]

    kv = _proj(x[:, 0], p.wkv_a)
    c_kv = rmsnorm(kv[..., :cfg.kv_lora], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(kv[:, None, None, cfg.kv_lora:], cos, sin)[:, 0, 0]
    cache_ckv[:, pos] = c_kv.to(cache_ckv.dtype)
    cache_krope[:, pos] = k_rope.to(cache_krope.dtype)

    # absorb W_k_b into q: q_lat (b,h,kv_lora); slots past pos are masked
    # to -1e30 by the reference (weight exactly 0), so read the prefix
    q_lat = einsum("bhd,chd->bhc", q_nope,
                   p.wk_b.w.reshape(cfg.kv_lora, h, dn))
    ckv = cache_ckv[:, :pos + 1].to(x.dtype)
    krope = cache_krope[:, :pos + 1].to(x.dtype)
    scores = (torch.einsum("bhc,bkc->bhk", q_lat.float(), ckv.float())
              + torch.einsum("bhd,bkd->bhk", q_rope.float(), krope.float())
              ) * (dn + dr) ** -0.5
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = einsum("bhk,bkc->bhc", w, ckv)
    o = einsum("bhc,chd->bhd", o_lat, p.wv_b.w.reshape(cfg.kv_lora, h, dv))
    return _proj(o.reshape(b, 1, h * dv), p.wo), cache_ckv, cache_krope


# ---------------------------------------------------------------------------
# MLP / MoE
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
    h = (torch.nn.functional.silu(matmul(x, p.w_gate.w))
         * matmul(x, p.w_in.w))
    return matmul(h, p.w_out.w)


class Experts(nn.Module):
    """The expert banks: ``w_gate``/``w_in`` (E, d, f), ``w_out`` (E, f, d)."""

    def __init__(self, w_gate, w_in, w_out):
        super().__init__()
        self.w_gate, self.w_in, self.w_out = (_param(w_gate), _param(w_in),
                                              _param(w_out))


class MoE(nn.Module):
    def __init__(self, router: Dense, experts: Experts,
                 shared: Optional[MLP] = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def init_moe(cfg: ArchConfig, ini: Init) -> MoE:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    router = ini.dense(d, e, scale=0.02)
    experts = Experts(ini.normal((e, d, f), d ** -0.5),
                      ini.normal((e, d, f), d ** -0.5),
                      ini.normal((e, f, d), f ** -0.5))
    shared = (init_mlp(d, f * cfg.n_shared_experts, ini)
              if cfg.n_shared_experts else None)
    return MoE(router, experts, shared)


def _moe_groups(t: int) -> int:
    """Token-group count: the largest divisor of ``t`` up to 8 (the
    reference's count without an activation context; with one it aligns
    the groups with the data axes of a mesh)."""
    g = min(8, t)
    while t % g:
        g -= 1
    return max(g, 1)


def _moe_cap(cfg: ArchConfig, tg: int) -> int:
    e, k = cfg.n_experts, cfg.top_k
    return max(4, min(int(cfg.capacity_factor * tg * k / e), tg * k))


def _moe_route(cfg: ArchConfig, p: MoE, xt):
    """The router: xt (G, Tg, d) -> the f32 probabilities (G, Tg, E) and
    each token's top-k experts (G, Tg, k), the likeliest first."""
    probs = torch.softmax(matmul(xt, p.router.w).float(), dim=-1)
    # the reference's top_k puts the lower expert first among equal
    # probabilities (frequent: the router's logits are rounded to bf16);
    # a stable descending sort does the same, torch.topk need not
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return probs, order[..., :cfg.top_k]


def _moe_dispatch(cfg: ArchConfig, p: MoE, xt, cap: int):
    """Sorted capacity-bounded dispatch of every token group at once (the
    reference vmaps ``_moe_one_group`` over the groups; here they are the
    leading batch dimension). xt (G, Tg, d) -> the bf16 dispatch buffer
    (G, E, cap, d) and per group, in expert order, the routing
    ``(se, st, sw, keep, pos_in_e, dest)``, each (G, Tg * k); ``dest`` is
    an assignment's place in token order, its token's experts ascending.
    No host sync: a stable sort, a sorted search, and a scatter whose
    dropped assignments all land in one dump slot past the buffer's end."""
    g, tg, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    probs, topi = _moe_route(cfg, p, xt)
    topv = probs.gather(-1, topi)                               # (G, Tg, k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    n = tg * k
    flat_e = topi.reshape(g, n)
    flat_t = (torch.arange(n, device=dev) // k).expand(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    st = flat_t.gather(1, order)
    sw = topv.reshape(g, n).gather(1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    first = torch.searchsorted(se, experts, side="left")        # (G, E)
    pos_in_e = torch.arange(n, device=dev) - first.gather(1, se)
    keep = pos_in_e < cap

    slot = torch.where(keep, se * cap + pos_in_e, e * cap)      # dropped: dump
    rows = xt.gather(1, st[..., None].expand(g, n, d)).to(DTYPE)
    disp = torch.zeros((g, e * cap + 1, d), dtype=DTYPE, device=dev)
    disp.scatter_(1, slot[..., None].expand(g, n, d), rows)
    # a token's assignments meet its sum in expert order (the sorted order)
    rank = topi.argsort(dim=-1).argsort(dim=-1).reshape(g, n).gather(1, order)
    return (disp[:, :-1].reshape(g, e, cap, d),
            (se, st, sw, keep, pos_in_e, st * k + rank))


def _moe_combine(meta, out, tg: int, cap: int):
    """Each kept assignment's expert output times its routing weight (cast
    to bf16), summed per token in the order in which the reference's
    scatter-add into its bf16 (``DTYPE``) buffer meets them (the token's
    experts ascending), a fixed order on the CPU and on the card alike:
    bf16 contributions (the bf16 model) in bf16, rounded at each addition;
    f32 ones (an f32 model) in f32, rounded once. out (G, E, cap, d) ->
    (G, Tg, d) bf16."""
    se, st, sw, keep, pos_in_e, dest = meta
    g, n = se.shape
    d = out.shape[-1]
    idx = torch.where(keep, se * cap + pos_in_e, 0)
    contrib = out.reshape(g, -1, d).gather(1, idx[..., None].expand(g, n, d))
    contrib = contrib * torch.where(keep, sw, 0.0).to(DTYPE)[..., None]
    per_token = torch.empty_like(contrib).scatter_(
        1, dest[..., None].expand(g, n, d), contrib).reshape(g, tg, -1, d)
    y = per_token[:, :, 0]
    for j in range(1, per_token.shape[2]):
        y = y + per_token[:, :, j]
    return y.to(DTYPE)


def moe(cfg: ArchConfig, p: MoE, x):
    """Top-k token-choice MoE, grouped sorted dispatch (the GShard
    schedule): the tokens split into groups, each routed on its own into a
    (G, E, cap, d) buffer, the expert products batched over the experts,
    the outputs combined back per token, plus the shared experts' MLP."""
    b, s, d = x.shape
    t = b * s
    g = _moe_groups(t)
    tg = t // g
    cap = _moe_cap(cfg, tg)
    xt = x.reshape(g, tg, d)
    disp, meta = _moe_dispatch(cfg, p, xt, cap)
    ex = p.experts
    h = torch.nn.functional.silu(einsum("gecd,edf->gecf", disp, ex.w_gate))
    h = h * einsum("gecd,edf->gecf", disp, ex.w_in)
    out = einsum("gecf,efd->gecd", h, ex.w_out)
    y = _moe_combine(meta, out, tg, cap)
    if p.shared is not None:
        y = y + mlp(p.shared, xt)
    return y.reshape(b, s, d)
