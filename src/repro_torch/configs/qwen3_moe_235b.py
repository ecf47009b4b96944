"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) per-expert d_ff=1536
vocab=151936, 128 experts top-8, head_dim=128.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=128,
        n_experts=128,
        n_experts_per_tok=8,
        rope_theta=1_000_000.0,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=512,
        head_dim=16,
        n_experts=8,
        n_experts_per_tok=2,
        rope_theta=1_000_000.0,
        **overrides,
    )
