"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA with QKV bias, tied embeddings.  [arXiv:2407.10671; hf]
"""
from .base import ArchConfig

ARCH_ID = "qwen2-1.5b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        **overrides,
    )
