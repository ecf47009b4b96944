"""Device and dtype resolution shared by every entry point of the port.

Entry points take ``device=None`` and then mean the CUDA card.  There is no
silent CPU fallback: with no card present and no ``device`` given they raise,
and the caller opts into the CPU explicitly with ``device="cpu"`` (as the
tests do).
"""
from __future__ import annotations

import torch

__all__ = ["DTYPES", "resolve_device", "resolve_dtype", "time_on_card"]

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


def resolve_dtype(dtype: str) -> torch.dtype:
    """Map ``"float32"`` / ``"float64"`` to a torch dtype."""
    try:
        return DTYPES[dtype]
    except (KeyError, TypeError):
        raise ValueError(f"dtype must be 'float32' or 'float64', got {dtype!r}") from None


def time_on_card(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream.

    Timed with CUDA events around ``iters`` back-to-back calls after
    ``warmup`` untimed ones.  Raises without a card: a time taken on the
    host is not a device time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_on_card needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
