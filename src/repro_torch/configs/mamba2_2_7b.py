"""mamba2-2.7b [ssm]: 64L d=2560, attention-free, vocab=50280, ssm_state=128.

SSD (state-space duality), d_inner = 2*d, headdim=64 (80 heads), conv k=4.
[arXiv:2405.21060; unverified]
"""
from .base import ArchConfig

ARCH_ID = "mamba2-2.7b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        head_dim=1,  # unused (attention-free)
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=128,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        head_dim=1,
        ssm_state=16,
        ssm_headdim=16,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=8,
        **overrides,
    )
