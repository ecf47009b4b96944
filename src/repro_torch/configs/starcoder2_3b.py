"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA + RoPE, LayerNorm, plain GeLU MLP with biases, QKV bias.
[arXiv:2402.19173; hf]
"""
from .base import ArchConfig

ARCH_ID = "starcoder2-3b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        norm_type="layer",
        gated_mlp=False,
        act="gelu",
        mlp_bias=True,
        qkv_bias=True,
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
        d_ff=256,
        vocab_size=512,
        norm_type="layer",
        gated_mlp=False,
        act="gelu",
        mlp_bias=True,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        **overrides,
    )
