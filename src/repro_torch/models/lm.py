"""Model assembly, port of ``repro.models.lm``, for the registry's ten
architectures.

Families:
  dense / moe  — decoder-only transformer (GQA or MLA attention, SwiGLU or
                 expert MLP; DeepSeek-V2's leading dense layers).
  hybrid       — Zamba2: Mamba2 backbone + ONE shared attention+MLP block
                 applied every ``attn_every`` blocks (own KV per application).
  ssm          — xLSTM: mLSTM blocks with an sLSTM block every
                 ``slstm_every``.
  encdec       — Whisper: bidirectional encoder over stub frame embeddings +
                 causal decoder with cross-attention.
  vlm          — InternVL2: the decoder consuming stub patch embeddings
                 prepended to the token sequence.

Each model is an ``nn.Module`` holding its weights under the reference's
parameter names: its stacked layers (``layers``, ``first``, ``blocks`` with
their nested ``mamba``/``mlstm`` stacks, ``enc_layers``, ``dec_layers``)
are ``nn.ModuleList``s indexed where the reference has a leading axis, and
run as a plain Python loop where the reference scans (its ``remat`` and
``unroll`` knobs are ignored). Serving: ``forward`` (full-sequence logits,
through the flash-attention kernel where the family attends) and
``decode_step`` (one token through the cache, updated in place), with the
RMSNorm kernel at every norm, both under ``torch.inference_mode``.
Training: ``loss(batch)``, the reference's mean next-token cross entropy,
through the same forward body with autograd recording, so that on the card
the two kernels' backward kernels give the gradients
(``repro_torch.training``). The reference's facade's shape-only members
(``init_shapes``, ``cache_shapes``, ``train_inputs``, ``decode_inputs``)
are functions of the config here, on the meta skeleton (``skeleton``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import DTYPE, Init


# ---------------------------------------------------------------------------
# Transformer blocks (dense / moe, GQA / MLA)
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """ln1, attention (``attn``: GQA or MLA), ln2, and the feed-forward
    under the reference's name: ``mlp``, or ``moe`` in a MoE layer."""

    def __init__(self, ln1, ln2, attn, ffn, kind: str = "dense"):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn = attn
        self.kind = kind
        if kind == "moe":
            self.moe = ffn
        else:
            self.mlp = ffn


def _init_block(cfg: ArchConfig, ini: Init, kind: str = "dense") -> Block:
    attn = L.init_mla(cfg, ini) if cfg.use_mla else L.init_gqa(cfg, ini)
    if kind == "moe":
        ffn = L.init_moe(cfg, ini)
    else:
        d_ff = (cfg.dense_d_ff if kind == "dense_first" and cfg.dense_d_ff
                else cfg.d_ff)
        ffn = L.init_mlp(cfg.d_model, d_ff, ini)
    return Block(ini.ones(cfg.d_model), ini.ones(cfg.d_model), attn, ffn,
                 kind)


def _ffn(cfg: ArchConfig, p: Block, h):
    return L.moe(cfg, p.moe, h) if p.kind == "moe" else L.mlp(p.mlp, h)


def _block_fwd(cfg: ArchConfig, p: Block, x, positions, window=0):
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    if cfg.use_mla:
        x = x + L.mla_attention(cfg, p.attn, h, positions)
    else:
        x = x + L.gqa_attention(cfg, p.attn, h, positions, window=window)
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + _ffn(cfg, p, h)


def _block_decode(cfg: ArchConfig, p: Block, x, cache, pos: int):
    """``cache`` this layer's {"k", "v"} or, with MLA, {"ckv", "krope"},
    written in place."""
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    if cfg.use_mla:
        a, _, _ = L.mla_decode(cfg, p.attn, h, cache["ckv"], cache["krope"],
                               pos)
    else:
        a, _, _ = L.gqa_decode(cfg, p.attn, h, cache["k"], cache["v"], pos)
    x = x + a
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + _ffn(cfg, p, h)


def _attn_cache(cfg: ArchConfig, n, b, s, device) -> Dict[str, torch.Tensor]:
    """``n`` layers' attention caches stacked on a leading axis: the MLA
    latent and shared rope key, or the GQA K/V."""
    if cfg.use_mla:
        shapes = {"ckv": (n, b, s, cfg.kv_lora),
                  "krope": (n, b, s, cfg.rope_head_dim)}
    else:
        shapes = {name: (n, b, s, cfg.n_kv_heads, cfg.head_dim)
                  for name in ("k", "v")}
    return {name: torch.zeros(shape, dtype=DTYPE, device=device)
            for name, shape in shapes.items()}


def _layer(stack: Dict[str, torch.Tensor], i: int):
    """Layer ``i``'s views of a stacked cache (written in place)."""
    return {name: t[i] for name, t in stack.items()}


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


class _LM(nn.Module):
    """What every family shares: the embedding, the final norm and the
    unembedding, the device, and inference mode on the entry points."""

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _embed(self, tokens):
        # a gather, as the reference's embed[tokens]; its gradient on the
        # card sums each row's contributions in a fixed (sorted) order.
        # The residual stream's layout, (dp, None, None), is pinned here
        # (a no-op outside the dry run's activation layout)
        return L.constrain(torch.nn.functional.embedding(tokens, self.embed),
                           "dp", None, None)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays (numpy or tensors) as tensors on the model's
        device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _logits(self, x):
        x = L.rmsnorm(x, self.ln_f, self.cfg.norm_eps)
        return L.matmul(x, self.unembed)

    def _head(self, ini: Init):
        cfg = self.cfg
        self.ln_f = L._param(ini.ones(cfg.d_model))
        self.unembed = L._param(
            ini.normal((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5))


# ---------------------------------------------------------------------------
# Decoder-only LM (dense, moe, vlm backbones share this)
# ---------------------------------------------------------------------------

class DecoderLM(_LM):
    """The decoder of the dense, moe and vlm families. It holds its
    weights, so it takes no ``params`` argument where the reference's
    functional ``Model`` facade does; ``forward`` and ``decode_step`` run
    under ``torch.inference_mode``, ``loss`` records for autograd."""

    def __init__(self, cfg: ArchConfig, ini: Init):
        """Weights from ``ini`` with the reference's distributions: N(0,
        0.02) embedding, N(0, 1/d_in) projections and N(0, 1/d_model)
        unembedding, each cast to bf16; router N(0, 0.02); zero biases;
        unit norm scales."""
        super().__init__()
        self.cfg = cfg
        self.kind = "moe" if cfg.family == "moe" else "dense"
        self.embed = L._param(ini.normal((cfg.vocab, cfg.d_model), 0.02))
        n_scan = cfg.n_layers - cfg.first_dense_layers
        self.layers = nn.ModuleList(
            [_init_block(cfg, ini, self.kind) for _ in range(n_scan)])
        self._head(ini)
        if cfg.first_dense_layers:
            self.first = nn.ModuleList(
                [_init_block(cfg, ini, "dense_first")
                 for _ in range(cfg.first_dense_layers)])
        if cfg.family == "vlm":
            self.patch_proj = ini.dense(cfg.d_model, cfg.d_model)

    def _stacks(self):
        """(cache key, blocks) in the order the forward runs them."""
        out = [("first", self.first)] if self.cfg.first_dense_layers else []
        return out + [("layers", self.layers)]

    @torch.inference_mode()
    def forward(self, tokens, patch_embeds=None):
        """tokens (B,S) int [, patch_embeds (B,P,d)] -> logits (B,P+S,V),
        the patches (cast to bf16 and projected) before the tokens."""
        return self._forward(tokens, patch_embeds)

    def loss(self, batch):
        """The reference's ``loss(params, batch)`` without ``params`` (the
        model holds its weights): mean cross entropy of the logits at
        positions 0..S-2 against ``labels`` 1..S-1, the vlm's patch
        positions dropped first. ``batch``: ``tokens``, ``labels`` and the
        vlm's ``patch_embeds``, numpy arrays or tensors."""
        batch = self._batch(batch)
        pe = batch.get("patch_embeds")
        logits = self._forward(batch["tokens"], pe)
        return L.next_token_loss(logits, batch["labels"],
                                 0 if pe is None else pe.shape[1])

    def _forward(self, tokens, patch_embeds=None):
        cfg = self.cfg
        x = self._embed(tokens)
        if patch_embeds is not None:
            pe = L.matmul(patch_embeds.to(DTYPE), self.patch_proj.w)
            x = torch.cat([pe, x], dim=1)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for _, blocks in self._stacks():
            for p in blocks:
                x = _block_fwd(cfg, p, x, positions)
        return self._logits(x)

    # -- decode -----------------------------------------------------------
    def init_cache(self, b, s):
        """{"layers": ...} (and {"first": ...}) stacked on a leading layer
        axis, as the reference's: {"k", "v"} (L, B, S, KV, dh), or with MLA
        {"ckv"} (L, B, S, kv_lora) and {"krope"} (L, B, S, rope_head_dim)."""
        return {name: _attn_cache(self.cfg, len(blocks), b, s, self.device)
                for name, blocks in self._stacks()}

    @torch.inference_mode()
    def decode_step(self, cache, token, pos: int):
        """token (B,1) int; ``pos`` a Python int. Returns (logits (B,1,V),
        cache), the cache updated in place."""
        x = self._embed(token)
        for name, blocks in self._stacks():
            for i, p in enumerate(blocks):
                x = _block_decode(self.cfg, p, x, _layer(cache[name], i), pos)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# Zamba2-style hybrid
# ---------------------------------------------------------------------------

class MambaLayer(nn.Module):
    def __init__(self, ln, m: S.Mamba2):
        super().__init__()
        self.ln, self.m = L._param(ln), m


class HybridSuper(nn.Module):
    def __init__(self, mamba: List[MambaLayer]):
        super().__init__()
        self.mamba = nn.ModuleList(mamba)


class HybridLM(_LM):
    def __init__(self, cfg: ArchConfig, ini: Init):
        super().__init__()
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                             f"attn_every = {cfg.attn_every}")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_every
        self.embed = L._param(ini.normal((cfg.vocab, cfg.d_model), 0.02))
        self.blocks = nn.ModuleList([HybridSuper([
            MambaLayer(ini.ones(cfg.d_model), S.init_mamba2(cfg, ini))
            for _ in range(cfg.attn_every)]) for _ in range(self.n_super)])
        self.shared = _init_block(cfg, ini, "dense")   # ONE shared attn+MLP
        self._head(ini)

    @torch.inference_mode()
    def forward(self, tokens, window=0):
        """tokens (B,S) -> logits (B,S,V); ``window`` > 0 limits the shared
        attention to the last ``window`` keys (the flash kernel's window)."""
        return self._forward(tokens, window)

    def loss(self, batch):
        """The reference's ``loss(params, batch)`` without ``params``: mean
        next-token cross entropy of ``tokens`` against ``labels``."""
        batch = self._batch(batch)
        logits = self._forward(batch["tokens"])
        return L.next_token_loss(logits, batch["labels"])

    def _forward(self, tokens, window=0):
        cfg = self.cfg
        x = self._embed(tokens)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for sp in self.blocks:
            for mp in sp.mamba:
                x = x + S.mamba2_forward(
                    cfg, mp.m, L.rmsnorm(x, mp.ln, cfg.norm_eps))
            x = _block_fwd(cfg, self.shared, x, positions, window=window)
        return self._logits(x)

    def init_cache(self, b, s):
        """The f32 SSM states (n_super, attn_every, B, H, N, 64), the conv
        windows (n_super, attn_every, B, 3, C) and the shared attention's
        K/V per application (n_super, B, S_attn, KV, dh), S_attn clamped
        to ``sliding_window_long`` past 65,536. The conv windows take the
        promoted type of bf16 and the weights', which the reference's bf16
        cache takes at its first step."""
        cfg = self.cfg
        d_inner, h, n = S.mamba_dims(cfg)
        s_attn = min(s, cfg.sliding_window_long) if s > 65536 else s
        dev = self.device
        lead = (self.n_super, cfg.attn_every, b)
        return {
            "ssm": torch.zeros(lead + (h, n, S.MAMBA_HEADDIM),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros(lead + (S.MAMBA_CONV - 1, d_inner + 2 * n),
                                dtype=torch.promote_types(DTYPE,
                                                          self.embed.dtype),
                                device=dev),
            "attn": _attn_cache(cfg, self.n_super, b, s_attn, dev),
        }

    @torch.inference_mode()
    def decode_step(self, cache, token, pos: int):
        cfg = self.cfg
        x = self._embed(token)
        s_attn = cache["attn"]["k"].shape[2]
        attn_pos = min(pos, s_attn - 1)   # the reference's clamp past the window
        for i, sp in enumerate(self.blocks):
            for j, mp in enumerate(sp.mamba):
                y, _, _ = S.mamba2_decode(
                    cfg, mp.m, L.rmsnorm(x, mp.ln, cfg.norm_eps),
                    cache["ssm"][i, j], cache["conv"][i, j])
                x = x + y
            x = _block_decode(cfg, self.shared, x, _layer(cache["attn"], i),
                              attn_pos)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

class MLSTMLayer(nn.Module):
    def __init__(self, ln, m: S.MLSTM):
        super().__init__()
        self.ln, self.m = L._param(ln), m


class XLSTMSuper(nn.Module):
    def __init__(self, mlstm: List[MLSTMLayer], sln, slstm: S.SLSTM):
        super().__init__()
        self.mlstm = nn.ModuleList(mlstm)
        self.sln, self.slstm = L._param(sln), slstm


class XLSTMLM(_LM):
    def __init__(self, cfg: ArchConfig, ini: Init):
        super().__init__()
        if cfg.n_layers % cfg.slstm_every:
            raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                             f"slstm_every = {cfg.slstm_every}")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.slstm_every
        self.m_per = cfg.slstm_every - 1
        self.embed = L._param(ini.normal((cfg.vocab, cfg.d_model), 0.02))
        self.blocks = nn.ModuleList([XLSTMSuper(
            [MLSTMLayer(ini.ones(cfg.d_model), S.init_mlstm(cfg, ini))
             for _ in range(self.m_per)],
            ini.ones(cfg.d_model), S.init_slstm(cfg, ini))
            for _ in range(self.n_super)])
        self._head(ini)

    @torch.inference_mode()
    def forward(self, tokens):
        """tokens (B,S) -> logits (B,S,V)."""
        return self._forward(tokens)

    def loss(self, batch):
        """The reference's ``loss(params, batch)`` without ``params``: mean
        next-token cross entropy of ``tokens`` against ``labels``."""
        batch = self._batch(batch)
        logits = self._forward(batch["tokens"])
        return L.next_token_loss(logits, batch["labels"])

    def _forward(self, tokens):
        cfg = self.cfg
        x = self._embed(tokens)
        for sp in self.blocks:
            for mp in sp.mlstm:
                x = x + S.mlstm_forward(
                    cfg, mp.m, L.rmsnorm(x, mp.ln, cfg.norm_eps))
            x = x + S.slstm_forward(cfg, sp.slstm,
                                    L.rmsnorm(x, sp.sln, cfg.norm_eps))
        return self._logits(x)

    def init_cache(self, b, s):
        """O(1) in the sequence length: the mLSTM memories mC (n_super,
        m_per, B, H, dqk, dv) and normalisers mN, f32, and the sLSTM cell
        sc (f32) and hidden sh (bf16), (n_super, B, heads, dh)."""
        cfg = self.cfg
        del s
        d_inner, h, dqk, dv = S.xlstm_dims(cfg)
        dh = cfg.d_model // cfg.n_heads
        dev, f32 = self.device, torch.float32
        lead = (self.n_super, self.m_per, b, h)
        return {
            "mC": torch.zeros(lead + (dqk, dv), dtype=f32, device=dev),
            "mN": torch.zeros(lead + (dqk,), dtype=f32, device=dev),
            "sc": torch.zeros((self.n_super, b, cfg.n_heads, dh), dtype=f32,
                              device=dev),
            "sh": torch.zeros((self.n_super, b, cfg.n_heads, dh), dtype=DTYPE,
                              device=dev),
        }

    @torch.inference_mode()
    def decode_step(self, cache, token, pos: int):
        cfg = self.cfg
        del pos
        x = self._embed(token)
        for i, sp in enumerate(self.blocks):
            for j, mp in enumerate(sp.mlstm):
                y, _, _ = S.mlstm_decode(
                    cfg, mp.m, L.rmsnorm(x, mp.ln, cfg.norm_eps),
                    cache["mC"][i, j], cache["mN"][i, j])
                x = x + y
            y, _, _ = S.slstm_decode(
                cfg, sp.slstm, L.rmsnorm(x, sp.sln, cfg.norm_eps),
                cache["sc"][i], cache["sh"][i])
            x = x + y
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# Whisper enc-dec
# ---------------------------------------------------------------------------

class EncBlock(nn.Module):
    def __init__(self, ln1, attn: L.Attention, ln2, mlp: L.MLP):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn, self.mlp = attn, mlp


class DecBlock(nn.Module):
    def __init__(self, ln1, self_attn: L.Attention, lnx, cross_q, cross_k,
                 cross_v, cross_o, ln2, mlp: L.MLP):
        super().__init__()
        self.ln1, self.lnx, self.ln2 = (L._param(ln1), L._param(lnx),
                                        L._param(ln2))
        self.self_attn, self.mlp = self_attn, mlp
        self.cross_q, self.cross_k = cross_q, cross_k
        self.cross_v, self.cross_o = cross_v, cross_o


class EncDecLM(_LM):
    def __init__(self, cfg: ArchConfig, ini: Init):
        super().__init__()
        self.cfg = cfg
        d, dq = cfg.d_model, cfg.n_heads * cfg.head_dim
        dkv = cfg.n_kv_heads * cfg.head_dim
        self.enc_pos = L._param(ini.normal((cfg.encoder_seq, d), 0.02))
        self.enc_layers = nn.ModuleList([EncBlock(
            ini.ones(d), L.init_gqa(cfg, ini), ini.ones(d),
            L.init_mlp(d, cfg.d_ff, ini)) for _ in range(cfg.encoder_layers)])
        self.enc_ln = L._param(ini.ones(d))
        self.embed = L._param(ini.normal((cfg.vocab, d), 0.02))
        self.dec_layers = nn.ModuleList([DecBlock(
            ini.ones(d), L.init_gqa(cfg, ini), ini.ones(d),
            ini.dense(d, dq), ini.dense(d, dkv), ini.dense(d, dkv),
            ini.dense(dq, d), ini.ones(d), L.init_mlp(d, cfg.d_ff, ini))
            for _ in range(cfg.n_layers)])
        self._head(ini)

    def encode(self, frames):
        """frames (B, encoder_seq, d) -> the encoder's output: non-causal
        attention (the flash kernel without its mask) over the frames."""
        cfg = self.cfg
        x = frames.to(DTYPE) + self.enc_pos[None]
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for lp in self.enc_layers:
            hh = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
            x = x + L.gqa_attention(cfg, lp.attn, hh, positions, causal=False)
            hh = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
            x = x + L.mlp(lp.mlp, hh)
        return L.rmsnorm(x, self.enc_ln, cfg.norm_eps)

    def _cross_attn(self, lp: DecBlock, x, enc):
        """The decoder's queries over every encoder frame: the flash kernel,
        non-causal, Sq != Sk. The reference's plain softmax rounds the
        scores to the activations' type before the scale; the kernel keeps
        them in f32."""
        cfg = self.cfg
        b, s, _ = x.shape
        se = enc.shape[1]
        dh = cfg.head_dim
        kv = cfg.n_kv_heads
        q = L.split_heads(L.matmul(x, lp.cross_q.w), cfg.n_heads,
                          b, s, cfg.n_heads, dh)
        k = L.split_heads(L.matmul(enc, lp.cross_k.w), kv, b, se, kv, dh)
        v = L.split_heads(L.matmul(enc, lp.cross_v.w), kv, b, se, kv, dh)
        o = L.flash_attention(q, k, v, causal=False)
        return L.matmul(L.merge_heads(o, cfg.n_heads), lp.cross_o.w)

    @torch.inference_mode()
    def forward(self, tokens, frames):
        """tokens (B,S), frames (B, encoder_seq, d) -> logits (B,S,V)."""
        return self._forward(tokens, frames)

    def loss(self, batch):
        """The reference's ``loss(params, batch)`` without ``params``: mean
        next-token cross entropy of ``tokens`` (decoded over ``frames``)
        against ``labels``."""
        batch = self._batch(batch)
        logits = self._forward(batch["tokens"], batch["frames"])
        return L.next_token_loss(logits, batch["labels"])

    def _forward(self, tokens, frames):
        cfg = self.cfg
        enc = self.encode(frames)
        x = self._embed(tokens)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        for lp in self.dec_layers:
            hh = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
            x = x + L.gqa_attention(cfg, lp.self_attn, hh, positions)
            hh = L.rmsnorm(x, lp.lnx, cfg.norm_eps)
            x = x + self._cross_attn(lp, hh, enc)
            hh = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
            x = x + L.mlp(lp.mlp, hh)
        return self._logits(x)

    def init_cache(self, b, s):
        """The decoder's self-attention K/V {"self": {"k", "v"}} (L, B, S,
        KV, dh) and the cross-attention K/V (L, B, encoder_seq, KV, dh),
        zeros: the reference's serving launcher never fills them."""
        cfg = self.cfg
        cross = (cfg.n_layers, b, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        return {
            "self": _attn_cache(cfg, cfg.n_layers, b, s, self.device),
            "cross_k": torch.zeros(cross, dtype=DTYPE, device=self.device),
            "cross_v": torch.zeros(cross, dtype=DTYPE, device=self.device),
        }

    @torch.inference_mode()
    def decode_step(self, cache, token, pos: int):
        cfg = self.cfg
        x = self._embed(token)
        dh = cfg.head_dim
        b = token.shape[0]
        g = cfg.n_heads // cfg.n_kv_heads
        for i, lp in enumerate(self.dec_layers):
            hh = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
            a, _, _ = L.gqa_decode(cfg, lp.self_attn, hh,
                                   cache["self"]["k"][i],
                                   cache["self"]["v"][i], pos)
            x = x + a
            hh = L.rmsnorm(x, lp.lnx, cfg.norm_eps)
            q = L.split_heads(L.matmul(hh, lp.cross_q.w), cfg.n_heads,
                              b, cfg.n_kv_heads, g, dh)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            sc = L.einsum("bhgd,bkhd->bhgk", q, ck).float() * dh ** -0.5
            w = torch.softmax(sc, dim=-1).to(x.dtype)
            o = L.batch_sharded(L.einsum("bhgk,bkhd->bhgd", w, cv)).reshape(
                b, 1, cfg.n_heads * dh)
            x = x + L.matmul(o, lp.cross_o.w)
            hh = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
            x = x + L.mlp(lp.mlp, hh)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "hybrid": HybridLM, "ssm": XLSTMLM, "encdec": EncDecLM}


def _family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return FAMILIES[cfg.family]


def build_model(cfg: ArchConfig, device=None, seed: int = 0) -> _LM:
    """The family's model with random weights drawn on ``device`` (the card
    unless the caller passes ``device="cpu"``) from
    ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _family(cfg)(cfg, Init(gen))


# ---------------------------------------------------------------------------
# The shape-only members of the reference's Model facade
# ---------------------------------------------------------------------------
# The port's build_model returns the family's module, which holds its
# weights, so there is no facade object to carry these; they are functions
# of the config, since a shape-only model is one that is never built with
# weights (llama4-maverick-400b-a17b's would not fit any card). Each builds
# the family's skeleton on the meta device: names, shapes and dtypes, no
# memory.

def skeleton(cfg: ArchConfig) -> _LM:
    """The family's model on the ``meta`` device (``Init(None)``)."""
    return _family(cfg)(cfg, Init(None))


def init_shapes(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The reference's ``Model.init_shapes``: every parameter as a meta
    tensor, by the port's name (the reference's tree through
    :func:`flatten_params`)."""
    return dict(skeleton(cfg).named_parameters())


def cache_shapes(cfg: ArchConfig, b: int, s: int,
                 model: Optional[_LM] = None) -> Dict[str, Any]:
    """The reference's ``Model.cache_shapes``: the family's
    ``init_cache(b, s)`` on the meta device (``model``: a skeleton to
    reuse)."""
    return (model if model is not None else skeleton(cfg)).init_cache(b, s)


def train_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The reference's ``Model.train_inputs``: ``tokens`` and ``labels``
    (B, S) int32, and the vlm's ``patch_embeds`` or the encdec's ``frames``
    (B, n, d) bf16, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta),
             "labels": torch.empty((b, s), dtype=torch.int32, **meta)}
    extra = {"vlm": ("patch_embeds", cfg.n_patches),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        batch[name] = torch.empty((b, n, cfg.d_model), dtype=DTYPE, **meta)
    return batch


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig,
                  model: Optional[_LM] = None) -> Dict[str, Any]:
    """The reference's ``Model.decode_inputs``: ``token`` (B, 1) int32,
    ``pos`` () int32 and the cache at (B, S), as meta tensors. (The port's
    ``decode_step`` takes ``pos`` as a Python int.)"""
    b, s = shape.global_batch, shape.seq_len
    return {"token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
            "cache": cache_shapes(cfg, b, s, model)}


def make_batch(cfg: ArchConfig, shape: ShapeConfig,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A real (small) batch on ``gen``'s device, as the reference's
    ``Model.make_batch``: uniform tokens (the labels are the tokens), and
    N(0, 1) bf16 ``patch_embeds`` (vlm) or ``frames`` (encdec)."""
    b, s = shape.global_batch, shape.seq_len
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    extra = {"vlm": ("patch_embeds", cfg.n_patches),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        batch[name] = torch.randn((b, n, cfg.d_model), generator=gen,
                                  device=dev).to(DTYPE)
    return batch


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; JAX's bf16 arrays (the
    ``ml_dtypes`` bfloat16, which ``torch.from_numpy`` refuses) cross as
    their uint16 bits."""
    a = np.array(a)            # a writable copy: torch keeps the buffer
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


#: the reference's stacked subtrees: a leading axis over layers (or over
#: the hybrid's and xLSTM's inner blocks, inside ``blocks``)
STACKS = ("layers", "first", "blocks", "mamba", "mlstm", "enc_layers",
          "dec_layers")


def flatten_params(tree: Dict[str, Any], prefix: str = "",
                   out: Optional[dict] = None) -> Dict[str, Any]:
    """The reference's parameter pytree as the port's state-dict names:
    nested keys joined by ".", each stacked subtree (:data:`STACKS`) split
    along its leading axis into ``<name>.<i>``."""
    out = {} if out is None else out
    for key, val in tree.items():
        name = prefix + key
        if not isinstance(val, dict):
            out[name] = val
        elif key in STACKS:
            n = len(np.asarray(_first_leaf(val)))
            for i in range(n):
                flatten_params(_index(val, i), f"{name}.{i}.", out)
        else:
            flatten_params(val, name + ".", out)
    return out


def reference_ranks(model: nn.Module) -> Dict[str, int]:
    """Each parameter's rank in the reference's pytree: its own, plus one
    for each stacked subtree (:data:`STACKS`) it lies in (``layers.3.ln1``
    is a row of the reference's (L, d) ``layers.ln1``;
    ``blocks.0.mamba.1.m.A_log`` of a (n_super, attn_every, h) stack). The
    reference's AdamW decays the leaves of rank 2 and more."""
    ranks = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        ranks[name] = p.dim() + sum(a in STACKS and b.isdigit()
                                    for a, b in zip(parts, parts[1:]))
    return ranks


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def model_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                     device=None) -> _LM:
    """The port's model holding the weights of the reference's parameter
    pytree ``tree`` (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``), leaf for leaf (:func:`flatten_params`): the family's
    skeleton is built without memory and every parameter assigned from the
    tree, which must name exactly the skeleton's parameters."""
    dev = resolve_device(device)
    model = _family(cfg)(cfg, Init(None))
    state = {k: _tensor(v, dev) for k, v in flatten_params(tree).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model
