"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.

RG-LRU + local attention, pattern (R,R,A); window 2048; gemma conventions.
[arXiv:2402.19427; hf]
"""
from .base import ArchConfig

ARCH_ID = "recurrentgemma-2b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        window=2048,
        block_pattern=("rglru", "rglru", "attn"),
        act="gelu",
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=5,  # 1 full (R,R,A) group + (R,R) tail
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        window=8,
        block_pattern=("rglru", "rglru", "attn"),
        act="gelu",
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        **overrides,
    )
