"""Masked earliest-cover reduction ``max_b min_r``: the CUDA kernels and their wrappers.

Port of ``repro.kernels.cover`` (the Pallas ``masked_cover_times``).  Two
hand-written kernels in ``csrc/cover.cu`` serve the callers of the reduction:

* kernel A, draws in (:func:`frontier_cover`, :func:`masked_cover_times`):
  ``(C, S, n_slots)`` draws, candidate ``c`` reading its slots row-major as
  ``i * ld_c + j`` and scaling them by ``scale_c``; ``masked_cover_times``
  takes ``(reps, B_pad, r_pad)`` draws masked to one ``(b, r)`` and sits
  behind :func:`repro_torch.core.simulator.gang_cover_times`
  (``simulate_balanced``, ``simulate_fifo``);
* kernel B, fused sample-and-cover (:func:`frontier_sample_cover`): draws
  each replica time in registers from the counter-based Philox stream of
  :mod:`repro_torch.kernels.philox` and never writes a draw; the frontier
  scorer of :mod:`repro_torch.cluster.vectorized`.

Each wrapper takes its plain PyTorch version (``*_ref``) only for a tensor
on the CPU.  For a CUDA tensor it launches its kernel or raises: there is no
fallback.  :data:`launches` counts launches of both kernels,
:data:`draws_launches` kernel A's and :data:`philox_launches` kernel B's, so
a run can show which kernel its main path went through.  The reference's
``pallas_cover_wins`` / ``REPRO_PALLAS_COVER`` opt-in has no counterpart:
on CUDA the kernels are always the path, and their speed is judged against
their bounds (``PERF.md``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._device import DTYPES, resolve_device, resolve_dtype, time_on_card
from ..spans import span
from . import _build, philox

__all__ = [
    "bench_masked_cover",
    "frontier_cover",
    "frontier_cover_ref",
    "frontier_sample_cover",
    "frontier_sample_cover_ref",
    "frontier_uniforms",
    "masked_cover_times",
    "masked_cover_times_ref",
]

# kernel launches since import (or since a caller last reset them to 0): of
# both kernels, of kernel A (draws in) and of kernel B (Philox sample-and-cover)
launches = 0
draws_launches = 0
philox_launches = 0

_MAX_GRID_Y = 65535
_INT_MAX = 2**31 - 1
_REP_LIMIT = 2**32  # a rep is one 32-bit word of the Philox counter


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


def frontier_sample_cover_ref(dist, bs, rs, scales, n_reps: int, seed: int, rep0: int = 0,
                              dtype=torch.float32, device=None) -> torch.Tensor:
    """Kernel B's plain version: the same Philox draws, made in torch, then
    :func:`frontier_cover_ref`.  Holds ``(C, n_reps, max_c b_c r_c)`` draws."""
    bs, rs, n_reps, rep0, dt, law = _sample_args(dist, bs, rs, n_reps, rep0, dtype)
    dev = resolve_device(device)
    n_slots = max(b * r for b, r in zip(bs, rs))
    x = philox.draws(law, seed, len(bs), rep0, n_reps, n_slots, dt, dev)
    return frontier_cover_ref(x, bs, rs, _scales(scales, len(bs), dt, dev))


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


def _sample_args(dist, bs, rs, n_reps, rep0, dtype):
    bs, rs = [int(b) for b in bs], [int(r) for r in rs]
    if not bs or len(bs) != len(rs):
        raise ValueError("need one (b, r) per candidate, and at least one candidate")
    for b, r in zip(bs, rs):
        if b < 1 or r < 1 or b * r > _INT_MAX:
            raise ValueError(f"candidate (b={b}, r={r}) needs 1 <= b, r and b*r < 2**31")
    n_reps, rep0 = int(n_reps), int(rep0)
    if n_reps < 0 or rep0 < 0 or rep0 + n_reps > _REP_LIMIT:
        raise ValueError(f"reps [{rep0}, {rep0 + n_reps}) must lie in [0, 2**32)")
    dt = dtype if isinstance(dtype, torch.dtype) else resolve_dtype(dtype)
    if dt not in DTYPES.values():
        raise ValueError(f"dtype must be float32 or float64, got {dt}")
    return bs, rs, n_reps, rep0, dt, dist.philox_law()


def _scales(scales, n_cand: int, dtype: torch.dtype, device) -> torch.Tensor:
    out = torch.as_tensor(scales, dtype=dtype).to(device)
    if out.shape != (n_cand,):
        raise ValueError(f"scales must hold one value per candidate: {n_cand}")
    return out


def frontier_sample_cover(dist, bs, rs, scales, n_reps: int, seed: int, rep0: int = 0,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """``(C, n_reps)`` cover times of freshly drawn replica times, one candidate per row.

    ``out[c, s] = max_{i < b_c} min_{j < r_c} scale_c * F^-1(u(seed, c,
    rep0 + s, i * r_c + j))`` for the law of ``dist``
    (:meth:`~repro_torch.core.service_time.ServiceTime.philox_law`) and the
    Philox stream of :mod:`repro_torch.kernels.philox`: row ``s`` depends on
    its absolute rep ``rep0 + s`` only, so a range of reps gives the same rows
    as the slice of a longer run.  On ``device`` (default: the CUDA card) it
    launches kernel B, which keeps every draw in registers; on the CPU it
    runs :func:`frontier_sample_cover_ref`.
    """
    global launches, philox_launches
    bs, rs, n_reps, rep0, dt, law = _sample_args(dist, bs, rs, n_reps, rep0, dtype)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return frontier_sample_cover_ref(dist, bs, rs, scales, n_reps, seed, rep0, dt, dev)
    if dev.type != "cuda":
        raise ValueError(f"device must be the CPU or a CUDA device, got {dev}")
    code, consts, table = law
    n_cand = len(bs)
    out = torch.empty((n_cand, n_reps), dtype=dt, device=dev)
    with span("cover.upload"):
        scale = _scales(scales, n_cand, dt, dev)
        geom = torch.tensor([[b, r, r] for b, r in zip(bs, rs)], dtype=torch.int32).to(dev)
        consts_t = torch.tensor(consts, dtype=dt).to(dev)
        tab = None if table is None else torch.as_tensor(table, dtype=dt).to(dev)
    if out.numel() == 0:
        return out
    if n_cand > _MAX_GRID_Y or n_reps > _INT_MAX:
        raise ValueError(f"the sample-and-cover kernel takes at most {_MAX_GRID_Y} candidates "
                         "of < 2**31 reps")
    if tab is not None and not 0 < tab.numel() <= _INT_MAX:
        raise ValueError("an empirical table needs 1 to 2**31 - 1 entries")
    k0, k1 = philox.key_of(seed)
    fn = _sample_entry(dt)
    with span("cover.launch"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            code, geom.data_ptr(), scale.data_ptr(), consts_t.data_ptr(),
            None if tab is None else tab.data_ptr(), 0 if tab is None else tab.numel(),
            out.data_ptr(), n_cand, n_reps, rep0, k0, k1, stream,
        )
    if err:
        raise RuntimeError(f"sample-and-cover kernel launch failed with CUDA error {err}")
    launches += 1
    philox_launches += 1
    return out


def frontier_uniforms(seed: int, n_cand: int, n_reps: int, n_slots: int, rep0: int = 0,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """``(n_cand, n_reps, n_slots)`` uniforms of the Philox stream, written out.

    The check that the card draws the plain version's bits: kernel B never
    writes a draw.  On the CPU, :mod:`~repro_torch.kernels.philox`'s plain
    version; on CUDA a small kernel of ``csrc/cover.cu`` (not counted in
    :data:`launches`: it is no part of any path).
    """
    dt = dtype if isinstance(dtype, torch.dtype) else resolve_dtype(dtype)
    dev = resolve_device(device)
    per = philox.draws_per_counter(philox.EXPONENTIAL, dt)
    if dev.type == "cpu":
        words = philox.stream_words(seed, n_cand, rep0, n_reps, -(-n_slots // per), dev)
        return philox.uniforms(words, dt, n_slots)
    if rep0 < 0 or rep0 + n_reps > _REP_LIMIT or n_cand > _MAX_GRID_Y or n_reps > _INT_MAX:
        raise ValueError("reps must lie in [0, 2**32), at most 2**31 - 1 of them, and "
                         "candidates number at most 65535")
    out = torch.empty((n_cand, n_reps, n_slots), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    fn = _uniforms_entry(dt)
    k0, k1 = philox.key_of(seed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(out.data_ptr(), n_cand, n_reps, n_slots, rep0, k0, k1, stream)
    if err:
        raise RuntimeError(f"uniforms kernel launch failed with CUDA error {err}")
    return out


@functools.cache
def _entry(dtype: torch.dtype):
    lib = _build.load("cover")
    fn = lib.cover_f32 if dtype == torch.float32 else lib.cover_f64
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sample_entry(dtype: torch.dtype):
    lib = _build.load("cover")
    fn = lib.sample_cover_f32 if dtype == torch.float32 else lib.sample_cover_f64
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _uniforms_entry(dtype: torch.dtype):
    lib = _build.load("cover")
    fn = lib.philox_uniforms_f32 if dtype == torch.float32 else lib.philox_uniforms_f64
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, geom: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    global launches, draws_launches
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
    draws_launches += 1
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
