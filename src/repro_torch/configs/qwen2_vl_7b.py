"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (temporal/height/width sections 16/24/24 of hd/2=64), dynamic
resolution -- the vision tower is a STUB per the assignment (input_specs
provides precomputed patch embeddings + 3-D position ids).
[arXiv:2409.12191; hf]
"""
from .base import ArchConfig

ARCH_ID = "qwen2-vl-7b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(4, 2, 2),  # head_dim 16 -> hd/2 = 8
        **overrides,
    )
