"""Architecture + shape configuration schema for the model zoo: the port's
own copy of ``repro/configs/base.py``, field for field (the parity tests
compare every field of every config and of its ``reduced()``).

``remat``, ``unroll`` and the scan they steer have no counterpart in the
port: PyTorch runs eagerly, inference keeps no activations for a backward
pass, and the blocks run as a plain Python loop. The fields stay so the
configs compare equal; the port ignores them."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0     # leading dense layers (DeepSeek-V2: 1)
    dense_d_ff: int = 0             # d_ff of those dense layers
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0             # zamba2: shared attn block period
    slstm_every: int = 0            # xlstm: sLSTM block period
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0            # stub frame count after conv frontend
    # --- vlm ---
    n_patches: int = 0              # stub patch-embedding count
    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window_long: int = 4096  # hybrid attn window in long-context mode
    remat: bool = True               # ignored by the port (no backward)
    #: unroll layer loops instead of lax.scan in the JAX package (its dry-run
    #: cost extrapolation); ignored by the port, whose blocks are a Python loop
    unroll: bool = False
    source: str = ""                 # provenance per the assignment table

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-window families)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink(x, lo, cap):
            return 0 if x == 0 else max(lo, min(x, cap))

        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        new_kv = max(1, 4 // ratio)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=new_kv * ratio,
            n_kv_heads=new_kv if self.n_kv_heads else 0,
            d_head=16,
            d_ff=shrink(self.d_ff, 1, 128),
            vocab=256,
            n_experts=shrink(self.n_experts, 4, 8),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            dense_d_ff=shrink(self.dense_d_ff, 1, 128),
            kv_lora=32 if self.use_mla else 0,
            q_lora=32 if self.q_lora else 0,
            rope_head_dim=8 if self.use_mla else self.rope_head_dim,
            nope_head_dim=16 if self.use_mla else self.nope_head_dim,
            v_head_dim=16 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            sliding_window_long=64,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode | long-decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long-decode")


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="long-decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (arch x shape) dry-run cells run vs. skip (DESIGN.md §5)."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "pure full-attention family: 512k dense decode skipped per assignment"
    if shape.name == "long_500k" and arch.family == "encdec":
        return False, "enc-dec audio family has no 512k decode context"
    return True, ""
