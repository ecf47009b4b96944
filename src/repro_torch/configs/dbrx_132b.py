"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

16 experts, top-4, fine-grained; LayerNorm.  [hf:databricks/dbrx-base; unverified]
"""
from .base import ArchConfig

ARCH_ID = "dbrx-132b"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        n_experts_per_tok=4,
        norm_type="layer",
        rope_theta=500_000.0,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        n_experts=4,
        n_experts_per_tok=2,
        norm_type="layer",
        rope_theta=500_000.0,
        **overrides,
    )
