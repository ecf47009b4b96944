"""Gradient-compression collectives (port of ``repro.distributed.collectives``).

``compressed_allreduce_mean`` is int8 error-feedback all-reduce over a
process group (in the reference, a slow mesh axis under ``shard_map``): each
member quantizes its tensor to int8 with a per-member fp32 scale,
all-gathers the int8 payloads + scales (1 byte/element/member on the wire
vs 4), and dequant-sums locally.  The quantization residual is returned as
the error-feedback buffer to be added to the *next* step's input, so the
compression error telescopes instead of accumulating.

The reference's expressions in its order: ``scale = max(max|y|, 1e-12) /
127``, ``round`` half to even, clip to +-127, cast to int8;
``tensordot(scales, q) / n``; ``new_ef = y - q * scale``.  ``q``, ``scale``
and ``new_ef`` are bitwise the reference's; the mean's sum runs in the
order of ``torch.tensordot``.  Every division is by a device tensor: torch
on CUDA divides by a host scalar as a multiply by its reciprocal.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["allreduce_mean", "compressed_allreduce_mean", "dequantize_int8", "quantize_int8"]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / _scalar(127.0, xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allreduce_mean(x: torch.Tensor, ef: torch.Tensor,
                              group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean over ``group``'s members with int8 payload + error feedback.

    Every member calls it with its own ``x`` and error-feedback buffer.
    Returns (mean estimate, new error-feedback buffer).
    """
    y = x.float() + ef
    q, scale = quantize_int8(y)
    n = dist.get_world_size(group)
    # wire format: int8 payload + fp32 scalar per member
    qs = torch.empty((n * q.numel(),), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1).contiguous(), group=group)
    qs = qs.reshape(n, -1)
    scales = torch.empty((n,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    total = torch.tensordot(scales, qs.float(), dims=1).reshape(x.shape)
    mean = total / _scalar(float(n), total)
    new_ef = y - dequantize_int8(q, scale)  # my own residual
    return mean, new_ef


def allreduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Uncompressed path: the float32 sum over ``group`` over its size."""
    y = x.float().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / _scalar(float(dist.get_world_size(group)), y)
