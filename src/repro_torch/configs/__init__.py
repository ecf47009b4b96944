"""Architecture registry: ``--arch <id>`` lookup (port of ``repro.configs``)."""
from __future__ import annotations

from typing import Dict, List

from . import (
    dbrx_132b,
    gemma_7b,
    hubert_xlarge,
    mamba2_2_7b,
    qwen2_1_5b,
    qwen2_vl_7b,
    qwen3_moe_235b,
    recurrentgemma_2b,
    starcoder2_3b,
    yi_9b,
)
from .base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    m.ARCH_ID: m
    for m in (
        qwen2_1_5b,
        yi_9b,
        gemma_7b,
        starcoder2_3b,
        hubert_xlarge,
        recurrentgemma_2b,
        qwen2_vl_7b,
        dbrx_132b,
        qwen3_moe_235b,
        mamba2_2_7b,
    )
}

ARCH_IDS: List[str] = list(_MODULES)

# Which shape cells are applicable per arch (DESIGN.md §5 skip notes):
#   - encoder-only: no autoregressive decode
#   - pure full-attention decoders: no long_500k (quadratic regime)
_FULL_ATTENTION = {
    "qwen2-1.5b", "yi-9b", "gemma-7b", "starcoder2-3b", "qwen2-vl-7b",
    "dbrx-132b", "qwen3-moe-235b-a22b",
}


def get_config(arch: str, smoke: bool = False, **overrides) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    m = _MODULES[arch]
    return m.smoke_config(**overrides) if smoke else m.full_config(**overrides)


def applicable_shapes(arch: str) -> Dict[str, ShapeConfig]:
    cfg = get_config(arch)
    out = {}
    for name, shape in SHAPES.items():
        if cfg.family == "encoder" and shape.kind == "decode":
            continue  # no autoregressive step
        if name == "long_500k" and arch in _FULL_ATTENTION:
            continue  # needs sub-quadratic attention
        out[name] = shape
    return out


def skipped_shapes(arch: str) -> Dict[str, str]:
    """Cells recorded as N/A-by-design with the reason (EXPERIMENTS §Dry-run)."""
    cfg = get_config(arch)
    out = {}
    for name, shape in SHAPES.items():
        if cfg.family == "encoder" and shape.kind == "decode":
            out[name] = "encoder-only arch: no autoregressive decode step"
        elif name == "long_500k" and arch in _FULL_ATTENTION:
            out[name] = "pure full-attention arch: 512k dense KV decode is the quadratic regime"
    return out


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "skipped_shapes",
]
