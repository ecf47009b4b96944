"""mamba2-2.7b [ssm]: 64L d=2560, attention-free, vocab 50,288, ssm_state=128.

SSD (state-space duality, arXiv:2405.21060).  The full preset is the
published model: ``huggingface.co/state-spaces/mamba2-2.7b`` ``config.json``
(d_model 2560, n_layer 64, vocab_size 50,277 padded to a multiple of 16 as
``mamba_ssm`` builds the embedding and its logits, tied embeddings) with
``mamba_ssm``'s ``Mamba2`` layer defaults: d_state 128, headdim 64 (80
heads), expand 2 (d_inner 5120), ngroups 1, d_conv 4, chunk_size 256, and
RMSNorm epsilon 1e-5 in the blocks, the final norm and the gated norm, and
the residual stream in float32 (``residual_in_fp32``).  The smoke preset
keeps the reference's tiny values.
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
        vocab_size=50288,
        head_dim=1,  # unused (attention-free)
        tie_embeddings=True,
        norm_eps=1e-5,
        residual_in_fp32=True,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=256,
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
