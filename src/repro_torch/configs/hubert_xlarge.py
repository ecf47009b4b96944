"""hubert-xlarge [audio]: 48L d=1280 16H d_ff=5120 vocab=504, encoder-only.

Same backbone arch as wav2vec2; the convolutional waveform frontend is a STUB
per the assignment (input_specs provides precomputed frame embeddings).
Training objective: masked-frame cluster prediction (CE over 504 units).
[arXiv:2106.07447; unverified]
"""
from .base import ArchConfig

ARCH_ID = "hubert-xlarge"


def full_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID,
        family="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        is_causal=False,
        norm_type="layer",
        gated_mlp=False,
        act="gelu",
        mlp_bias=True,
        qkv_bias=True,
        **overrides,
    )


def smoke_config(**overrides) -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke",
        family="encoder",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        is_causal=False,
        norm_type="layer",
        gated_mlp=False,
        act="gelu",
        mlp_bias=True,
        qkv_bias=True,
        **overrides,
    )
