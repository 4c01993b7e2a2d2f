"""Model assembly of the dense decoder, port of ``repro.models.lm``.

``DecoderLM`` is an ``nn.Module``: the embedding, one :class:`Block` per
layer in an ``nn.ModuleList``, the final norm and the unembedding, under
the reference's parameter names. The reference stacks the layers on a
leading axis and runs them under ``lax.scan`` (with ``remat``/``unroll``
knobs); here the blocks are a plain Python loop and those config fields
are ignored. The port runs inference only: ``forward`` (full-sequence
logits, through the flash-attention kernel) and ``decode_step`` (one
token through the KV cache, updated in place), with the RMSNorm kernel in
both.

The families the reference also assembles here (``moe``, ``hybrid``,
``ssm``, ``encdec``, ``vlm``) and MLA attention raise
``NotImplementedError`` (ROADMAP.md queue A item 6), as do the loss and
training.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import DTYPE, Init

UNPORTED = ("moe", "hybrid", "ssm", "encdec", "vlm")


# ---------------------------------------------------------------------------
# Transformer blocks (dense, GQA)
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, ln1, ln2, attn: L.Attention, mlp: L.MLP):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn, self.mlp = attn, mlp


def _init_block(cfg: ArchConfig, ini: Init) -> Block:
    return Block(ini.ones(cfg.d_model), ini.ones(cfg.d_model),
                 L.init_gqa(cfg, ini), L.init_mlp(cfg.d_model, cfg.d_ff, ini))


def _block_fwd(cfg: ArchConfig, p: Block, x, positions):
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + L.gqa_attention(cfg, p.attn, h, positions)
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp(p.mlp, h)


def _block_decode(cfg: ArchConfig, p: Block, x, cache, pos: int):
    """``cache`` {"k", "v"} of this layer, written in place."""
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    a, _, _ = L.gqa_decode(cfg, p.attn, h, cache["k"], cache["v"], pos)
    x = x + a
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp(p.mlp, h)


# ---------------------------------------------------------------------------
# Decoder-only LM (dense)
# ---------------------------------------------------------------------------

class DecoderLM(nn.Module):
    """The model that :func:`build_model` and :func:`model_from_numpy`
    return. It holds its weights, so it takes no ``params`` argument where
    the reference's functional ``Model`` facade does; ``forward`` and
    ``decode_step`` run under ``torch.inference_mode``."""

    def __init__(self, cfg: ArchConfig, embed, layers: List[Block], ln_f,
                 unembed):
        super().__init__()
        self.cfg = cfg
        self.embed = L._param(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_f = L._param(ln_f)
        self.unembed = L._param(unembed)

    @classmethod
    def init(cls, cfg: ArchConfig, gen: torch.Generator) -> "DecoderLM":
        """Random weights from ``gen`` on its device, with the reference's
        distributions: N(0, 0.02) embedding, N(0, 1/d_in) projections and
        N(0, 1/d_model) unembedding, each cast to bf16; zero biases; unit
        norm scales."""
        ini = Init(gen)
        embed = ini.normal((cfg.vocab, cfg.d_model), 0.02)
        layers = [_init_block(cfg, ini) for _ in range(cfg.n_layers)]
        unembed = ini.normal((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5)
        return cls(cfg, embed, layers, ini.ones(cfg.d_model), unembed)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens):
        b, s = tokens.shape
        return self.embed.index_select(0, tokens.reshape(-1)).reshape(b, s, -1)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.inference_mode()
    def forward(self, tokens):
        """tokens (B,S) int -> logits (B,S,V) bf16."""
        cfg = self.cfg
        x = self._embed(tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for p in self.layers:
            x = _block_fwd(cfg, p, x, positions)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        return x @ self.unembed

    # -- decode -----------------------------------------------------------
    def init_cache(self, b, s):
        """{"layers": {"k", "v"}} stacked (L, B, S, KV, dh), as the
        reference's; layer i's slice is a view written in place."""
        cfg = self.cfg
        shape = (len(self.layers), b, s, cfg.n_kv_heads, cfg.head_dim)
        return {"layers": {
            name: torch.zeros(shape, dtype=DTYPE, device=self.device)
            for name in ("k", "v")}}

    @torch.inference_mode()
    def decode_step(self, cache, token, pos: int):
        """token (B,1) int; ``pos`` a Python int. Returns (logits (B,1,V),
        cache), the cache updated in place."""
        cfg = self.cfg
        x = self._embed(token)
        stack = cache["layers"]
        for i, p in enumerate(self.layers):
            x = _block_decode(cfg, p, x,
                              {"k": stack["k"][i], "v": stack["v"][i]}, pos)
        x = L.rmsnorm(x, self.ln_f, cfg.norm_eps)
        return x @ self.unembed, cache


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet "
            "(ROADMAP.md queue A item 6)")
    if cfg.family != "dense":
        raise ValueError(cfg.family)
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP.md queue A item 6)")


def build_model(cfg: ArchConfig, device=None, seed: int = 0) -> DecoderLM:
    """The dense decoder with random weights drawn on ``device`` (the card
    unless the caller passes ``device="cpu"``) from
    ``torch.Generator(device).manual_seed(seed)``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return DecoderLM.init(cfg, gen)


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


def model_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                     device=None) -> DecoderLM:
    """The port's model holding the weights of the reference's parameter
    pytree ``tree`` (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``): the stacked ``layers`` leaves are split along axis 0."""
    _check_ported(cfg)
    dev = resolve_device(device)

    def dense(d, i):
        return L.Dense(_tensor(d["w"][i], dev),
                       _tensor(d["b"][i], dev) if "b" in d else None)

    lt = tree["layers"]
    layers = []
    for i in range(np.shape(lt["ln1"])[0]):
        a, m = lt["attn"], lt["mlp"]
        layers.append(Block(
            _tensor(lt["ln1"][i], dev), _tensor(lt["ln2"][i], dev),
            L.Attention(dense(a["wq"], i), dense(a["wk"], i),
                        dense(a["wv"], i), dense(a["wo"], i)),
            L.MLP(dense(m["w_gate"], i), dense(m["w_in"], i),
                  dense(m["w_out"], i)),
        ))
    return DecoderLM(cfg, _tensor(tree["embed"], dev), layers,
                     _tensor(tree["ln_f"], dev), _tensor(tree["unembed"], dev))
