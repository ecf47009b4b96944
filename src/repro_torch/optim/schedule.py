"""Learning-rate schedules (step -> lr), port of ``repro.optim.schedule``.

Each takes the step as an int32 tensor (or a number) and returns a float32
scalar tensor on its device, the reference's expressions in its order.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_with_warmup", "linear_with_warmup"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_with_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        decay = peak + (floor - peak) * frac
        return torch.where(step < warmup, warm, decay)

    return fn


def cosine_with_warmup(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    floor = peak * floor_frac

    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        decay = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, decay)

    return fn
