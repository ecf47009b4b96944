"""Vectorized torch backend for the cluster engine's static semantics.

Port of the static path of ``repro.cluster.vectorized``: gang dispatch,
earliest-cover completion (``T = max_b min_r``, the cover kernel of
:mod:`repro_torch.kernels.cover`), replica-cancellation accounting and
whole-cluster FIFO multi-job queueing, batched over (candidate B, replication
r, Monte-Carlo rep) so one device pass scores an entire frontier.

Two entry points:

* :func:`frontier_job_times` -- i.i.d. single-job compute times for every
  candidate at once (the ``plan_cluster`` / ``plan_sweep`` workhorse).  Each
  candidate's replicas are drawn as ``n_slots`` flat slots packed
  ``i * r + j``, and the kernel reads that packing directly: the reference's
  padded ``(B_pad, r_pad)`` gather (``C * n_reps * B_pad * r_pad`` values)
  never exists.
* :func:`simulate_fifo` -- multi-job FIFO gang queueing, a Python loop over
  job arrivals carrying the cluster's slack, batched over reps.

Draws come from a ``torch.Generator`` seeded with ``seed``.  They differ from
the reference's ``jax.random`` draws, so the two agree in law (3 sigma) and
not draw for draw.  The reference's ``rep_chunk`` (bit-identical under any
chunking) needs draws indexed by rep, which a ``torch.Generator`` cannot
give; it raises here until a counter-based (Philox) sampler lands.  Space
sharing, churn and the stream slab come with later slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..core.service_time import ServiceTime
from ..core.simulator import gang_cover_times
from ..kernels.cover import frontier_cover

__all__ = ["frontier_job_times", "simulate_fifo", "FifoReport"]

_REP_CHUNK_TODO = (
    "rep_chunk needs draws indexed by rep, which a torch.Generator cannot give; "
    "it comes with a counter-based (Philox) sampler (ROADMAP.md, queue 1, item 1)"
)


def _candidate_grid(n_workers: int, candidates) -> tuple[np.ndarray, np.ndarray]:
    bs = np.asarray(list(candidates), dtype=np.int32)
    if bs.size == 0:
        raise ValueError("need at least one candidate B")
    if (bs < 1).any() or (bs > n_workers).any():
        raise ValueError(f"candidates must lie in [1, {n_workers}], got {bs.tolist()}")
    rs = (n_workers // bs).astype(np.int32)
    return bs, rs


def frontier_job_times(
    dist: ServiceTime,
    n_workers: int,
    candidates,
    n_reps: int,
    *,
    seed: int = 0,
    size_dependent: bool = True,
    n_tasks: int | None = None,
    rep_chunk: int | None = None,
    device=None,
    dtype="float32",
) -> np.ndarray:
    """i.i.d. job compute times for every candidate B in one device pass.

    Returns an ``(len(candidates), n_reps)`` array; row i is statistically
    identical to the reference's row for ``candidates[i]`` (and to
    ``simulate_balanced``).  Device memory holds ``C * n_reps * n_slots``
    draws, where ``n_slots = max_c B_c * r_c``.
    """
    if rep_chunk is not None:
        raise NotImplementedError(_REP_CHUNK_TODO)
    bs, rs = _candidate_grid(n_workers, candidates)
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    if n_tasks is None:
        n_tasks = n_workers
    n_slots = int((bs * rs).max())  # replicas a gang actually dispatches
    scales = (n_tasks / bs) if size_dependent else np.ones(len(bs))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = dist.sample(gen, (len(bs), int(n_reps), n_slots), dev, dt)
    t = frontier_cover(flat, bs, rs, torch.as_tensor(scales, dtype=dt, device=dev))
    return t.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class FifoReport:
    """Batched outcome of :func:`simulate_fifo` (axis 0 = Monte-Carlo rep).

    Carries the engine's accounting invariant
    ``worker_seconds(cancel on) + saved == worker_seconds(cancel off)``.
    """

    arrivals: np.ndarray  # (n_jobs,)
    starts: np.ndarray  # (n_reps, n_jobs)
    finishes: np.ndarray  # (n_reps, n_jobs)
    worker_seconds: np.ndarray  # (n_reps,)
    cancelled_seconds_saved: np.ndarray  # (n_reps,)

    @property
    def compute_times(self) -> np.ndarray:
        """Per-(rep, job) compute time: finish minus start."""
        return self.finishes - self.starts

    @property
    def response_times(self) -> np.ndarray:
        """Per-(rep, job) response time: finish minus arrival."""
        return self.finishes - self.arrivals[None, :]

    @property
    def queue_waits(self) -> np.ndarray:
        """Per-(rep, job) queueing delay: start minus arrival."""
        return self.starts - self.arrivals[None, :]


def _fifo_scan(draws: torch.Tensor, gaps: np.ndarray, first_arrival: float, cancel: bool):
    """draws: (S, J, b, r) scaled durations -> per-rep FIFO schedule.

    The loop carries *slack* -- the cluster's free time relative to the next
    job's arrival (the initial carry is ``-arrivals[0]``, then each step
    subtracts the inter-arrival gap) -- so only queue-backlog-sized
    magnitudes flow through the device dtype; the caller rebuilds absolute
    start times in float64.  Carrying absolute times would quantize queue
    waits by the (arbitrarily large) arrival timestamps.
    """
    r = draws.shape[-1]
    batch_min = draws.amin(dim=-1)  # (S, J, b)
    t_job = gang_cover_times(draws)  # (S, J) cover time: the kernel on CUDA
    # the cluster frees at the cover time when losers are cancelled, at the
    # last replica otherwise (stragglers delay the next gang dispatch)
    hold = t_job if cancel else draws.amax(dim=(-2, -1))
    # busy worker-seconds: with cancellation each of a batch's r replicas
    # burns exactly the batch min (winner's duration); without it every
    # replica runs to completion
    busy_off = draws.sum(dim=(-2, -1))  # (S, J)
    busy = r * batch_min.sum(dim=-1) if cancel else busy_off
    saved = busy_off - busy
    slack = torch.full((draws.shape[0],), -first_arrival, dtype=draws.dtype, device=draws.device)
    waits = torch.empty_like(t_job)
    for k, gap in enumerate(gaps.tolist()):
        wait = slack.clamp_min(0.0)
        waits[:, k] = wait
        slack = wait + hold[:, k] - gap
    return waits, t_job, busy.sum(dim=-1), saved.sum(dim=-1)


def simulate_fifo(
    dist: ServiceTime,
    n_workers: int,
    n_batches: int,
    arrivals,
    n_reps: int,
    *,
    seed: int = 0,
    cancel_redundant: bool = False,
    size_dependent: bool = True,
    n_tasks: int | None = None,
    scheduler: str = "fifo_gang",
    workers_per_job: int | None = None,
    job_plans=None,
    device=None,
) -> FifoReport:
    """Whole-cluster FIFO gang queueing, batched over Monte-Carlo reps.

    ``arrivals`` is the (sorted) job arrival-time vector shared by all reps;
    each rep redraws every replica duration.  Statistically identical to the
    reference's ``simulate_fifo`` on the same workload (no churn,
    homogeneous speeds).  The device loop runs in float32 and absolute times
    are rebuilt in float64 on the host.  Space-sharing knobs (``scheduler``
    other than ``fifo_gang``, ``workers_per_job``, ``job_plans``) run on the
    epoch scan's space lane, which the port has not reached: they raise
    :class:`NotImplementedError`.
    """
    from .scheduler import is_space

    if is_space(scheduler, workers_per_job, job_plans):
        raise NotImplementedError(
            "space-sharing knobs run on the epoch scan's space lane, which the port "
            "reaches in a later slice (ROADMAP.md, queue 1, item 4)"
        )
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.ndim != 1 or arrivals.size == 0:
        raise ValueError("arrivals must be a non-empty 1-D array")
    if (np.diff(arrivals) < 0).any():
        raise ValueError("arrivals must be sorted (FIFO order)")
    bs, rs = _candidate_grid(n_workers, [n_batches])
    b, r = int(bs[0]), int(rs[0])
    dev = resolve_device(device)
    if n_tasks is None:
        n_tasks = n_workers
    scale = (n_tasks / b) if size_dependent else 1.0
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    draws = dist.sample(gen, (int(n_reps), arrivals.size, b, r), dev, torch.float32) * scale
    # gaps rounded to the device dtype, as the reference passes them
    gaps = np.append(np.diff(arrivals), 0.0).astype(np.float32)  # last gap is never read
    waits, t_job, busy, saved = _fifo_scan(
        draws, gaps, float(np.float32(arrivals[0])), bool(cancel_redundant)
    )
    # absolute times rebuilt in float64: the device loop only ever sees
    # queue-backlog-sized magnitudes (waits, holds, inter-arrival gaps)
    starts = arrivals[None, :] + waits.double().cpu().numpy()
    return FifoReport(
        arrivals=arrivals,
        starts=starts,
        finishes=starts + t_job.double().cpu().numpy(),
        worker_seconds=busy.double().cpu().numpy(),
        cancelled_seconds_saved=saved.double().cpu().numpy(),
    )
