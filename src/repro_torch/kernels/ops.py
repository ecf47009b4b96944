"""Public wrappers over the hand-written kernels (port of ``repro.kernels.ops``).

The reference picks Pallas interpret mode off the TPU; here the choice
follows the tensor: on the CPU each wrapper runs its kernel's plain version,
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_fwd
from .rmsnorm import rms_norm_fused

__all__ = ["attention", "rmsnorm"]


def attention(
    q: torch.Tensor,  # model layout: (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KH, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash-attention with the model's (B, S, H, hd) layout (positions ``arange``)."""
    out = flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window
    )
    return out.transpose(1, 2)


def rmsnorm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, plus_one: bool = False
) -> torch.Tensor:
    """Fused RMSNorm over the last axis."""
    return rms_norm_fused(x, weight, eps=eps, plus_one=plus_one)
