"""The 10 assigned architectures, exact configs from the assignment table
(the port's copy of ``repro/configs/registry.py``, values unchanged)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

_A = ArchConfig

ARCHS = {
    "stablelm-1.6b": _A(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, d_head=64,
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
    ),
    "smollm-135m": _A(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab=49152, d_head=64,
        source="hf:HuggingFaceTB/SmolLM-135M; hf",
    ),
    "qwen2.5-14b": _A(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, d_head=128, qkv_bias=True,
        source="hf:Qwen/Qwen2.5-0.5B; hf",
    ),
    "yi-34b": _A(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000, d_head=128,
        source="arXiv:2403.04652; hf",
    ),
    "deepseek-v2-236b": _A(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab=102400,
        n_experts=160, top_k=6, n_shared_experts=2,
        first_dense_layers=1, dense_d_ff=12288,
        use_mla=True, kv_lora=512, q_lora=1536,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128, d_head=192,
        source="arXiv:2405.04434; hf",
    ),
    "llama4-maverick-400b-a17b": _A(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, d_head=128,
        n_experts=128, top_k=1, n_shared_experts=1,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    ),
    "zamba2-2.7b": _A(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, d_head=80,
        ssm_state=64, attn_every=6,
        source="arXiv:2411.15242; hf",
    ),
    "whisper-base": _A(
        name="whisper-base", family="encdec",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865, d_head=64,
        encoder_layers=6, encoder_seq=1500,
        source="arXiv:2212.04356; unverified",
    ),
    "xlstm-1.3b": _A(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, d_head=512,
        slstm_every=8,
        source="arXiv:2405.04517; unverified",
    ),
    "internvl2-26b": _A(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553, d_head=128,
        n_patches=256,
        source="arXiv:2404.16821; hf",
    ),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
