"""gemma-7b [dense]: 28L d=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000.

GeGLU, head_dim=256, (1+w) RMSNorm, sqrt(d) embedding scale, tied embeddings.
[arXiv:2403.08295; hf]
"""
from .base import ArchConfig

ARCH_ID = "gemma-7b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        d_ff=24576,
        vocab_size=256000,
        head_dim=256,
        act="gelu",
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        act="gelu",
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        **overrides,
    )
