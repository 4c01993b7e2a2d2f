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
versions on the CPU. :func:`cross_entropy` is the reference's loss
(:func:`next_token_loss` every family's). The
decode steps and the MoE stay plain PyTorch, as the reference computes
them outside any Pallas kernel.

The reference's sharding rules serve the dry run (``launch.dryrun``):
:func:`spec_for` and :func:`build_param_specs` give each parameter its
spec (:class:`P`, the reference's ``PartitionSpec``) under the
:data:`LAYOUT` in force, and :func:`spec_placements` turns a spec into
DTensor placements on a ``torch.distributed`` ``DeviceMesh``. Inside
:func:`activation_sharding` the reference's constraint points
(:func:`constrain`) redistribute a DTensor activation to the reference's
layout, and a MoE layer splits its tokens into 256 groups; outside it (on
one card) :func:`constrain` returns its argument and a MoE layer takes 8.
The work that DTensor cannot partition by its own rules takes the dry
run's forms (``launch.sharded``) in place of the plain functions here
while a count runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel

DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Sharding rules: specs, the layout and the activation constraints
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec, the reference's ``PartitionSpec``: one entry per
    dimension, ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dimension split over those axes, the first outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar("act_ctx",
                                                          default=None)
#: "opt" (tensor-parallel weights, ZeRO-1 optimizer state, activation
#: constraints) or "baseline" (weights also sharded over the data axes):
#: the reference's two layouts, which :func:`spec_for` reads
LAYOUT: contextvars.ContextVar = contextvars.ContextVar("layout",
                                                        default="opt")


@dataclasses.dataclass(frozen=True)
class ActSharding:
    dp: tuple          # data-parallel axes for the batch dim
    tp: str            # tensor axis name
    tp_size: int


@contextlib.contextmanager
def activation_sharding(dp_axes, tp_axis, tp_size):
    token = _ACT_CTX.set(ActSharding(tuple(dp_axes), tp_axis, tp_size))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def spec_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``torch.distributed``
    ``DeviceMesh`` with named dimensions: ``Shard(i)`` on each mesh
    dimension that dimension ``i`` of the spec names, ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def constrain(x, *dims):
    """The reference's activation constraint: inside
    :func:`activation_sharding`, a DTensor ``x`` redistributed to the spec
    ``dims`` names — ``"dp"`` (the batch axes, where the dimension is above
    1), ``"tp"`` (the tensor axis, where it divides the dimension) or
    ``None``; anything else is returned as it is."""
    ctx = _ACT_CTX.get()
    if ctx is None or not hasattr(x, "device_mesh"):
        return x
    parts = []
    for i, d in enumerate(dims):
        if d == "dp":
            parts.append(ctx.dp if x.shape[i] > 1 else None)
        elif d == "tp":
            parts.append(ctx.tp if (x.shape[i] % ctx.tp_size == 0
                                    and x.shape[i] >= ctx.tp_size) else None)
        else:
            parts.append(None)
    out = x.redistribute(x.device_mesh,
                         spec_placements(P(*parts), x.device_mesh))
    local = out.to_local()
    if not local.is_contiguous():
        # a shard cut from a padded one (an uneven split): DTensor runs
        # later views on the local shard, which must be viewable
        from torch.distributed.tensor import DTensor

        out = DTensor.from_local(local.contiguous(), out.device_mesh,
                                 out.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def shardwise(fn, x, dims):
    """``fn(x)``, for an ``fn`` that keeps ``x``'s shape except along
    ``dims`` and mixes values only along them (a pad, a cumulative sum).
    The dry run puts a DTensor form in its place (``launch.sharded``)."""
    return fn(x)


def batch_sharded(t):
    """``t``: taken before a decode step's reshapes that merge dimensions.
    The dry run puts a DTensor form in its place (``launch.sharded``)."""
    return t


def split_heads(y, n_heads: int, *shape):
    """``y.reshape(shape)`` where the reshape splits ``y``'s last dimension
    into ``n_heads`` heads. Inside :func:`activation_sharding`, where the
    tensor axis does not divide the heads, ``y`` is first gathered over it:
    DTensor cannot unflatten a sharded dimension unevenly."""
    ctx = _ACT_CTX.get()
    if ctx is not None and n_heads % ctx.tp_size:
        y = constrain(y, *(["dp"] + [None] * (y.dim() - 1)))
    return y.reshape(*shape)


def merge_heads(o, n_heads: int):
    """o (B, S, H, D) -> (B, S, H * D). Inside :func:`activation_sharding`,
    where the tensor axis does not divide the heads, the result is held
    replicated over it: the gradient that the row-parallel output
    projection sends back is sharded over H * D, and DTensor cannot
    unflatten that into heads unevenly, so it is gathered first."""
    b, s = o.shape[:2]
    out = o.reshape(b, s, n_heads * o.shape[-1])
    ctx = _ACT_CTX.get()
    if ctx is not None and n_heads % ctx.tp_size:
        out = constrain(out, "dp", None, None)
    return out


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def spec_for(path: str, shape, mesh_axis_sizes: dict, fsdp_axes,
             tp_axis="model") -> P:
    """The reference's rule for one parameter at ``path`` (its pytree path,
    "/"-joined). Under the "opt" layout weights are tensor-parallel only
    and replicated over the data axes (ZeRO-1: only the optimizer state,
    :func:`~repro_torch.training.optimizer.opt_state_specs`, is also
    data-sharded); expert banks are also sharded over the data axes on
    d_in, and the embedding on the vocabulary. "baseline" also shards each
    weight's other dimension over the data axes. A dimension is sharded
    only where the axis size divides it; parameters under 256 wide stay
    replicated."""
    tp = mesh_axis_sizes.get(tp_axis, 1)
    fs = (int(np.prod([mesh_axis_sizes.get(a, 1) for a in fsdp_axes]))
          if fsdp_axes else 1)
    nd = len(shape)
    spec = [None] * nd
    if nd == 0 or max(shape) < 256:
        return P(*spec)

    def put(dim, axis, size):
        if spec[dim] is None and _divisible(shape[dim], size):
            spec[dim] = axis
            return True
        return False

    fsdp = tuple(fsdp_axes) if fs > 1 else None
    p = path.lower()
    row_parallel = any(t in p for t in ("wo", "w_out", "out_proj", "down"))
    expert = "experts" in p
    zero1 = LAYOUT.get() != "baseline"
    if expert and nd >= 3:
        put(0, tp_axis, tp)
        if fsdp:
            put(1, fsdp, fs) or put(2, fsdp, fs)
    elif "unembed" in p and nd == 2:
        put(1, tp_axis, tp)
        if fsdp and not zero1:
            put(0, fsdp, fs)
    elif "embed" in p and nd == 2:
        put(1, tp_axis, tp)
        if fsdp:
            put(0, fsdp, fs)
    elif nd >= 2 and row_parallel:
        put(nd - 2, tp_axis, tp)
        if fsdp and not zero1:
            put(nd - 1, fsdp, fs)
    elif nd >= 2:
        put(nd - 1, tp_axis, tp)
        if fsdp and not zero1:
            put(nd - 2, fsdp, fs)
    return P(*spec)


def reference_path(name: str):
    """A port parameter name -> (the reference's pytree path, the stack
    indices in it): ``blocks.0.mamba.1.m.A_log`` -> (``blocks/mamba/m/
    A_log``, [0, 1])."""
    parts = name.split(".")
    return ("/".join(q for q in parts if not q.isdigit()),
            [int(q) for q in parts if q.isdigit()])


def build_param_specs(model, mesh, fsdp_axes) -> Dict[str, P]:
    """Each parameter of ``model`` (by the port's name) -> the reference's
    spec (``build_param_specs`` of its stacked pytree) without the leading
    stack entries: ``layers.3.attn.wq.w`` gets the spec of
    ``layers/attn/wq/w`` minus its leading ``None``. ``mesh`` needs only
    ``axis_names`` and ``shape`` (a name -> size mapping), as the
    reference's reads (a ``torch.distributed`` mesh: :func:`mesh_sizes`).
    Raises where the reference would shard a stack axis, which a
    per-layer parameter cannot carry."""
    sizes = mesh_sizes(mesh)
    out = {}
    for name, prm in model.named_parameters():
        path, idx = reference_path(name)
        stack = _stack_sizes(model, name)
        shape = tuple(stack) + tuple(prm.shape)
        stacked = (path.startswith("layers") or "/layers" in path
                   or "blocks" in path)
        if stacked and len(shape) >= 1:
            spec = P(None, *spec_for(path, shape[1:], sizes, fsdp_axes))
        else:
            spec = spec_for(path, shape, sizes, fsdp_axes)
        if any(e is not None for e in spec[:len(idx)]):
            raise ValueError(f"{name}: the reference shards a stack axis "
                             f"({spec})")
        out[name] = P(*spec[len(idx):])
    return out


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh: the reference's stand-ins (``axis_names``
    and ``shape``) or a ``torch.distributed`` ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, (mesh.shape[a]
                                      for a in mesh.axis_names)))


def _stack_sizes(model, name: str):
    """The lengths of the stacks a parameter lies in, outermost first (the
    reference's leading axes)."""
    parts = name.split(".")
    out = []
    for i, q in enumerate(parts):
        if q.isdigit():
            out.append(len(model.get_submodule(".".join(parts[:i]))))
    return out


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


def next_token_loss(logits, labels, skip: int = 0):
    """Every family's loss: :func:`cross_entropy` of the logits at
    positions ``skip``..``skip+S-2`` against ``labels`` 1..S-1 (the vlm
    skips its patch positions). logits (B, skip+S, V), labels (B, S). The
    dry run puts a DTensor form in its place (``launch.sharded``)."""
    return cross_entropy(logits[:, skip:-1], labels[:, 1:])


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
    q = split_heads(_proj(x, p.wq), cfg.n_heads, b, s, cfg.n_heads, dh)
    k = split_heads(_proj(x, p.wk), cfg.n_kv_heads, b, s, cfg.n_kv_heads, dh)
    v = split_heads(_proj(x, p.wv), cfg.n_kv_heads, b, s, cfg.n_kv_heads, dh)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal, window)
    return constrain(_proj(merge_heads(o, cfg.n_heads), p.wo),
                     "dp", None, None)


def write_slot(cache, pos: int, val):
    """``cache[:, pos] = val`` in the cache's type, in place: a decode
    step's write of its token (the reference's ``dynamic_update_slice``).
    The dry run puts a DTensor form in its place (``launch.sharded``)."""
    cache[:, pos] = val.to(cache.dtype)


def slot_softmax(scores):
    """``torch.softmax(scores, dim=-1)`` over a decode step's cache slots.
    The dry run puts a DTensor form in its place (``launch.sharded``)."""
    return torch.softmax(scores, dim=-1)


def _prefix(cache, pos: int):
    """Slots 0..pos of a (B, S, ...) cache; the cache itself at the last
    slot (no slice: a DTensor cache sharded on S would be gathered)."""
    return cache if pos + 1 == cache.shape[1] else cache[:, :pos + 1]


def gqa_decode(cfg: ArchConfig, p: Attention, x, cache_k, cache_v, pos: int):
    """One-token decode. x (B,1,d); cache_k/v (B,S,kv,dh); ``pos`` the
    current index, a Python int (so no host sync). Writes this token's k/v
    into the caches IN PLACE (the reference's immutable
    ``dynamic_update_slice`` returns new caches) and returns
    ``(out, cache_k, cache_v)``."""
    b = x.shape[0]
    dh = cfg.head_dim
    q = split_heads(_proj(x, p.wq), cfg.n_heads, b, 1, cfg.n_heads, dh)
    k = split_heads(_proj(x, p.wk), cfg.n_kv_heads, b, 1, cfg.n_kv_heads, dh)
    v = split_heads(_proj(x, p.wv), cfg.n_kv_heads, b, 1, cfg.n_kv_heads, dh)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_freqs(posv, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write_slot(cache_k, pos, k[:, 0])
    write_slot(cache_v, pos, v[:, 0])

    g = cfg.n_heads // cfg.n_kv_heads
    q = batch_sharded(q).reshape(b, cfg.n_kv_heads, g, dh)
    # only slots 0..pos are valid: the reference masks the rest to -1e30,
    # whose softmax weight is exactly 0, so reading the prefix is the same
    keys = _prefix(cache_k, pos).to(x.dtype)
    vals = _prefix(cache_v, pos).to(x.dtype)
    scores = torch.einsum("bhgd,bkhd->bhgk", q.float(), keys.float()) * dh ** -0.5
    w = slot_softmax(scores).to(x.dtype)
    o = batch_sharded(torch.einsum("bhgk,bkhd->bhgd", w, vals)).reshape(
        b, 1, cfg.n_heads * dh)
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
    q = split_heads(_mla_q(cfg, p, x), h, b, s, h, dn + dr)
    q = constrain(q, "dp", None, "tp", None)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv = _proj(x, p.wkv_a)
    c_kv, k_rope = kv[..., :cfg.kv_lora], kv[..., cfg.kv_lora:]
    c_kv = rmsnorm(c_kv, p.kv_norm, cfg.norm_eps)
    c_kv = constrain(c_kv, "dp", None, None)
    k_nope = constrain(split_heads(_proj(c_kv, p.wk_b), h, b, s, h, dn),
                       "dp", None, "tp", None)
    v = constrain(split_heads(_proj(c_kv, p.wv_b), h, b, s, h, dv),
                  "dp", None, "tp", None)

    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # shared by heads

    q_cat = torch.cat([q_nope, q_rope], dim=-1)               # (b,s,h,dn+dr)
    k_cat = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q_cat = constrain(q_cat, "dp", None, "tp", None)
    k_cat = constrain(k_cat, "dp", None, "tp", None)
    o = attention_narrow_v(q_cat, k_cat, v)
    return constrain(_proj(merge_heads(o, h), p.wo), "dp", None, None)


def attention_narrow_v(q, k, v, causal=True):
    """Causal attention whose v head dim Dv is below q's and k's Dk,
    through the flash kernel, which takes one head dim: v zero-padded to
    Dk, the output sliced back to Dv. Exact: the scale stays Dk^-1/2 and
    the zero columns add nothing to the kept ones. q (B,S,H,Dk), k
    (B,S,KV,Dk), v (B,S,KV,Dv) -> (B,S,H,Dv)."""
    dk, dv = k.shape[-1], v.shape[-1]
    v_pad = shardwise(lambda t: torch.nn.functional.pad(t, (0, dk - dv)),
                      v, (-1,))
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
    write_slot(cache_ckv, pos, c_kv)
    write_slot(cache_krope, pos, k_rope)

    # absorb W_k_b into q: q_lat (b,h,kv_lora); slots past pos are masked
    # to -1e30 by the reference (weight exactly 0), so read the prefix
    q_lat = einsum("bhd,chd->bhc", q_nope,
                   p.wk_b.w.reshape(cfg.kv_lora, h, dn))
    ckv = _prefix(cache_ckv, pos).to(x.dtype)
    krope = _prefix(cache_krope, pos).to(x.dtype)
    scores = (torch.einsum("bhc,bkc->bhk", q_lat.float(), ckv.float())
              + torch.einsum("bhd,bkd->bhk", q_rope.float(), krope.float())
              ) * (dn + dr) ** -0.5
    w = slot_softmax(scores).to(x.dtype)
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
    def hidden(w):
        # column-parallel: the hidden width over the tensor axis, in the
        # forward and (as a redistribution's backward) in the gradient
        y = matmul(x, w)
        return constrain(y, "dp", None, "tp") if y.dim() == 3 else y

    h = torch.nn.functional.silu(hidden(p.w_gate.w)) * hidden(p.w_in.w)
    out = matmul(h, p.w_out.w)
    return constrain(out, *(["dp"] + [None] * (out.dim() - 1)))


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
    """Token-group count: the largest divisor of ``t`` up to 8, or up to
    256 inside :func:`activation_sharding`, where the groups align with
    the data axes so that routing is local to a group and the (G, E, C, d)
    dispatch's change of layout is the expert-parallel all-to-all."""
    g = min(256 if _ACT_CTX.get() is not None else 8, t)
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


def _expert_ffn(disp, w_gate, w_in, w_out):
    """The experts' SwiGLU on their dispatch buffer: (G, E, C, d) ->
    (G, E, C, d), batched over the experts."""
    h = torch.nn.functional.silu(einsum("gecd,edf->gecf", disp, w_gate))
    h = h * einsum("gecd,edf->gecf", disp, w_in)
    return einsum("gecf,efd->gecd", h, w_out)


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
    disp = constrain(disp, "dp", "tp", None, None)   # (G, E, C, d) all-to-all
    ex = p.experts
    out = _expert_ffn(disp, ex.w_gate, ex.w_in, ex.w_out)
    out = constrain(out, "dp", "tp", None, None)
    y = _moe_combine(meta, out, tg, cap)
    if p.shared is not None:
        y = y + mlp(p.shared, xt)
    return constrain(y.reshape(b, s, d), "dp", None, None)
