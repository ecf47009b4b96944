"""yi-9b [dense]: 48L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

llama-architecture GQA.  [arXiv:2403.04652; hf]
"""
from .base import ArchConfig

ARCH_ID = "yi-9b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        rope_theta=5_000_000.0,
        **overrides,
    )
