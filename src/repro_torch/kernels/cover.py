"""Masked earliest-cover reduction ``max_b min_r``: the CUDA kernel and its wrappers.

Port of ``repro.kernels.cover`` (the Pallas ``masked_cover_times``).  One
hand-written kernel (``csrc/cover.cu``) serves both callers of the
reduction:

* :func:`frontier_cover` -- ``(C, S, n_slots)`` draws, candidate ``c``
  reading its slots row-major as ``i * r_c + j`` and scaling them by
  ``scale_c``; the frontier scorer of :mod:`repro_torch.cluster.vectorized`;
* :func:`masked_cover_times` -- ``(reps, B_pad, r_pad)`` draws masked to one
  ``(b, r)``; behind :func:`repro_torch.core.simulator.gang_cover_times`.

Each wrapper takes its plain PyTorch version (``*_ref``) only for a tensor
on the CPU.  For a CUDA tensor it launches the kernel or raises: there is no
fallback.  :data:`launches` counts kernel launches, so a run can show that
its main path went through the kernel.  The reference's
``pallas_cover_wins`` / ``REPRO_PALLAS_COVER`` opt-in has no counterpart:
on CUDA the kernel is always the path, and its speed is judged against its
memory bound (``PERF.md``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._device import DTYPES, time_on_card
from . import _build

__all__ = [
    "bench_masked_cover",
    "frontier_cover",
    "frontier_cover_ref",
    "masked_cover_times",
    "masked_cover_times_ref",
]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

_MAX_GRID_Y = 65535
_INT_MAX = 2**31 - 1


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick of correctness)
# --------------------------------------------------------------------------


def masked_cover_times_ref(draws: torch.Tensor, n_batches: int, replication: int):
    """``max_{i < b} min_{j < r} draws[..., i, j]`` by masking, as the reference does."""
    b_pad, r_pad = draws.shape[-2], draws.shape[-1]
    cols = torch.arange(r_pad, device=draws.device)
    rows = torch.arange(b_pad, device=draws.device)
    t_batch = torch.where(cols < replication, draws, torch.inf).amin(dim=-1)
    return torch.where(rows < n_batches, t_batch, -torch.inf).amax(dim=-1)


def frontier_cover_ref(x: torch.Tensor, bs, rs, scales: torch.Tensor) -> torch.Tensor:
    """Per candidate ``c``: ``max_i min_j scale_c * x[c, :, i * r_c + j]``."""
    n_cand, n_reps = x.shape[0], x.shape[1]
    out = torch.empty((n_cand, n_reps), dtype=x.dtype, device=x.device)
    for c, (b, r) in enumerate(zip(bs, rs)):
        scaled = x[c, :, : b * r] * scales[c]
        out[c] = scaled.reshape(n_reps, b, r).amin(dim=-1).amax(dim=-1)
    return out


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check_draws(x: torch.Tensor, name: str) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError(f"{name} must be a 3-D tensor")
    if x.dtype not in DTYPES.values():
        raise ValueError(f"{name} must be float32 or float64, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must lie on the CPU or a CUDA device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def frontier_cover(x: torch.Tensor, bs, rs, scales: torch.Tensor) -> torch.Tensor:
    """``(C, S, n_slots)`` flat draws -> ``(C, S)`` cover times, one candidate per row.

    ``bs`` / ``rs`` are host integers (candidate ``c`` reads ``bs[c] * rs[c]``
    leading slots, packed ``i * r + j``); ``scales`` is a ``(C,)`` tensor of
    the draws' dtype and device.  Bitwise equal to
    ``repro.cluster.vectorized._frontier_cover`` on the same draws.
    """
    _check_draws(x, "x")
    n_cand, n_reps, n_slots = x.shape
    bs, rs = [int(b) for b in bs], [int(r) for r in rs]
    if len(bs) != n_cand or len(rs) != n_cand:
        raise ValueError(f"need one (b, r) per candidate row: {n_cand} rows")
    for b, r in zip(bs, rs):
        if b < 1 or r < 1 or b * r > n_slots:
            raise ValueError(f"candidate (b={b}, r={r}) needs 1 <= b, r and b*r <= {n_slots}")
    if scales.shape != (n_cand,) or scales.dtype != x.dtype or scales.device != x.device:
        raise ValueError("scales must be a (C,) tensor of the draws' dtype and device")
    if x.device.type == "cpu":
        return frontier_cover_ref(x, bs, rs, scales)
    geom = torch.tensor([[b, r, r] for b, r in zip(bs, rs)], dtype=torch.int32)
    return _launch(x, geom.to(x.device), scales.contiguous())


def masked_cover_times(draws: torch.Tensor, n_batches: int, replication: int) -> torch.Tensor:
    """Masked ``max_b min_r`` over a padded ``(reps, B_pad, r_pad)`` replica grid.

    Semantically identical to ``gang_cover_times(draws, n_batches,
    replication)``, and bitwise equal to the reference's Pallas
    ``masked_cover_times`` on the same draws.
    """
    _check_draws(draws, "draws")
    n_reps, b_pad, r_pad = draws.shape
    b, r = int(n_batches), int(replication)
    if not (1 <= b <= b_pad and 1 <= r <= r_pad):
        raise ValueError(f"need 1 <= n_batches <= {b_pad} and 1 <= replication <= {r_pad}")
    if draws.device.type == "cpu":
        return masked_cover_times_ref(draws, b, r)
    geom = torch.tensor([[b, r, r_pad]], dtype=torch.int32).to(draws.device)
    scale = torch.ones(1, dtype=draws.dtype, device=draws.device)
    return _launch(draws.view(1, n_reps, b_pad * r_pad), geom, scale).view(n_reps)


@functools.cache
def _entry(dtype: torch.dtype):
    lib = _build.load("cover")
    fn = lib.cover_f32 if dtype == torch.float32 else lib.cover_f64
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, geom: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    global launches
    n_cand, n_reps, n_slots = x.shape
    out = torch.empty((n_cand, n_reps), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if n_cand > _MAX_GRID_Y or n_reps > _INT_MAX or n_slots > _INT_MAX:
        raise ValueError(f"cover kernel takes at most {_MAX_GRID_Y} rows of < 2**31 reps/slots")
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), geom.data_ptr(), scale.data_ptr(), out.data_ptr(),
            n_cand, n_reps, n_slots, stream,
        )
    if err:
        raise RuntimeError(f"cover kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def bench_masked_cover(reps: int = 4096, b_pad: int = 8, r_pad: int = 8, iters: int = 5) -> dict:
    """Time the cover kernel and its plain version on the card.

    Returns ``{"kernel_ms", "plain_ms"}`` per call (CUDA events) for
    exponential draws of shape ``(reps, b_pad, r_pad)`` masked to half the
    grid.  Raises without a CUDA device.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("bench_masked_cover times the kernel on a CUDA device; none is present")
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = torch.empty((reps, b_pad, r_pad), device="cuda").exponential_(generator=gen)
    b, r = max(b_pad // 2, 1), max(r_pad // 2, 1)
    return {
        "kernel_ms": time_on_card(lambda: masked_cover_times(draws, b, r), iters),
        "plain_ms": time_on_card(lambda: masked_cover_times_ref(draws, b, r), iters),
    }
