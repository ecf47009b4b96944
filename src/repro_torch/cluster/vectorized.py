"""Vectorized torch backend for the cluster engine's static semantics.

Port of the static path of ``repro.cluster.vectorized``: gang dispatch,
earliest-cover completion (``T = max_b min_r``, the cover kernel of
:mod:`repro_torch.kernels.cover`), replica-cancellation accounting and
whole-cluster FIFO multi-job queueing, batched over (candidate B, replication
r, Monte-Carlo rep) so one device pass scores an entire frontier.

Two entry points:

* :func:`frontier_job_times` -- i.i.d. single-job compute times for every
  candidate at once (the ``plan_cluster`` / ``plan_sweep`` workhorse).  Each
  candidate's replicas are slots packed ``i * r + j``, drawn inside the
  fused sample-and-cover kernel (:func:`repro_torch.kernels.cover.
  frontier_sample_cover`) from a counter-based Philox stream: no draw is
  ever written to device memory, and neither the reference's padded
  ``(B_pad, r_pad)`` gather nor its flat ``(C, n_reps, n_slots)`` draws exist.
* :func:`simulate_fifo` -- multi-job FIFO gang queueing, a Python loop over
  job arrivals carrying the cluster's slack, batched over reps.

The frontier's draws are a pure function of (seed, candidate, rep, slot):
the seed is the Philox key and the absolute rep a word of the counter, the
port's counterpart of the reference's ``fold_in(key(seed), rep)``.  So
``rep_chunk`` is bit-identical under any chunking, as in the reference.
``simulate_fifo`` draws from a ``torch.Generator`` seeded with ``seed``.
Neither stream is the reference's ``jax.random`` stream, so the two agree in
law (3 sigma) and not draw for draw.

The stream slab (:func:`_stream_slab`, behind
:func:`repro_torch.cluster.stream.simulate_stream`) is the trace-scale
sibling of the FIFO scan: G symmetric gang pools, an accumulator dict in
place of per-job outputs, and host numpy draws (``TraceStream.sample_slab``)
that both packages consume identically, so it is held to the reference
exactly rather than in law.  ``simulate_fifo``'s space-sharing knobs
delegate to the epoch scan's space lane
(:func:`repro_torch.cluster.epoch_scan.simulate_epochs`), as the
reference's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..core.service_time import ServiceTime
from ..core.simulator import gang_cover_times
from ..kernels.cover import frontier_sample_cover
from ..spans import span

__all__ = [
    "frontier_job_times",
    "simulate_fifo",
    "FifoReport",
    "STREAM_HIST_EDGES",
    "STREAM_HIST_BINS",
    "STREAM_QUANTILE_RTOL",
    "stream_acc_init",
]


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
    ``simulate_balanced``).  The replica times are drawn inside the cover
    kernel, so device memory holds only the ``C * n_reps`` outputs.  With
    ``rep_chunk``, the reps go in launches of at most ``rep_chunk`` reps
    each: rep ``k`` draws the same numbers in every chunking, so the result
    is bit-identical for every ``rep_chunk`` and for ``None``.
    """
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    bs, rs = _candidate_grid(n_workers, candidates)
    if rep_chunk is not None and int(rep_chunk) < 1:
        raise ValueError("rep_chunk must be >= 1")
    n_reps = int(n_reps)
    if n_tasks is None:
        n_tasks = n_workers
    scales = (n_tasks / bs) if size_dependent else np.ones(len(bs))
    chunk = n_reps if rep_chunk is None else int(rep_chunk)
    parts = []
    for lo in range(0, n_reps, max(chunk, 1)):
        part = frontier_sample_cover(
            dist, bs, rs, scales, min(lo + chunk, n_reps) - lo, seed, rep0=lo, dtype=dt, device=dev
        )
        with span("cover.readback"):
            parts.append(part.cpu().numpy())
    if not parts:
        return np.empty((len(bs), 0), dtype=np.float32 if dt == torch.float32 else np.float64)
    return np.concatenate(parts, axis=1)


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
    dtype: str = "float32",
    device=None,
) -> FifoReport:
    """Whole-cluster FIFO gang queueing, batched over Monte-Carlo reps.

    ``arrivals`` is the (sorted) job arrival-time vector shared by all reps;
    each rep redraws every replica duration.  Statistically identical to the
    reference's ``simulate_fifo`` on the same workload (no churn,
    homogeneous speeds).  The device loop runs in float32 and absolute times
    are rebuilt in float64 on the host.

    Space-sharing knobs (``scheduler`` other than ``fifo_gang``,
    ``workers_per_job``, ``job_plans``) delegate, as the reference's do, to
    the epoch scan's space lane
    (:func:`~repro_torch.cluster.epoch_scan.simulate_epochs` on a churn-free
    timeline, host numpy draws, so float64 equals the reference bit for bit
    but the two worker-second sums).  Its lanes carry absolute times in
    ``dtype``; ``dtype`` applies to that path only.
    """
    from .scheduler import is_space

    if is_space(scheduler, workers_per_job, job_plans):
        from .epoch_scan import simulate_epochs
        from .scenario import scenario_from_kwargs

        rep = simulate_epochs(
            dist,
            n_workers,
            n_batches,
            arrivals,
            n_reps,
            seed=seed,
            scenario=scenario_from_kwargs(
                cancel_redundant=cancel_redundant,
                size_dependent=size_dependent,
                n_tasks=n_tasks,
                scheduler=scheduler,
                workers_per_job=workers_per_job,
                job_plans=job_plans,
                dtype=dtype,
            ),
            device=device,
        )
        return FifoReport(
            arrivals=rep.arrivals,
            starts=rep.starts,
            finishes=rep.finishes,
            worker_seconds=rep.worker_seconds,
            cancelled_seconds_saved=rep.cancelled_seconds_saved,
        )
    if dtype != "float32":
        raise ValueError(
            "dtype applies to the space-sharing delegation only; the gang path "
            "already rebuilds absolute times in float64"
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


# --------------------------------------------------------------------------
# the stream slab: trace-scale multi-gang FIFO with on-device accumulators
# --------------------------------------------------------------------------

# Log-spaced response-time histogram edges shared by the device fold and the
# host reference fold: 1 ms .. 1e6 s at ~18% per-bin resolution.  Bin i holds
# responses in [edges[i-1], edges[i]); integer counts make the sketch exactly
# order-independent, so streaming equals materialized bit for bit.
STREAM_HIST_EDGES = np.logspace(-3.0, 6.0, 128)
STREAM_HIST_BINS = STREAM_HIST_EDGES.size + 1

# Committed accuracy of histogram quantiles: the estimator returns the upper
# edge of the bin holding the k-th order statistic, so for any response in
# [edges[0], edges[-1]] the true quantile r satisfies
# ``r <= estimate <= r * (1 + STREAM_QUANTILE_RTOL)`` -- one log bin, never
# an underestimate.
STREAM_QUANTILE_RTOL = float(STREAM_HIST_EDGES[1] / STREAM_HIST_EDGES[0]) - 1.0

# accumulators folded as running sums, in this order, by _stream_slab
_SUM_FIELDS = ("resp_sum", "resp_sq", "comp_sum", "busy_sum", "saved_sum")


def stream_acc_init(n_reps: int, dtype: torch.dtype, n_classes: int = 0, *, device) -> dict:
    """Zeroed accumulator carry for :func:`_stream_slab` (one row per rep).

    With ``n_classes > 0`` the carry also holds per-class response state
    (count / response sum / histogram), keyed by the job's source-trace
    index -- the substrate of per-class SLO quantiles.
    """
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    acc = {
        "count": zeros(n_reps, dt=torch.int32),
        **{k: zeros(n_reps) for k in _SUM_FIELDS},
        "resp_min": torch.full((n_reps,), torch.inf, dtype=dtype, device=device),
        "resp_max": torch.full((n_reps,), -torch.inf, dtype=dtype, device=device),
        "hist": zeros(n_reps, STREAM_HIST_BINS, dt=torch.int32),
    }
    if n_classes:
        acc["class_count"] = zeros(n_reps, n_classes, dt=torch.int32)
        acc["class_resp_sum"] = zeros(n_reps, n_classes)
        acc["class_hist"] = zeros(n_reps, n_classes, STREAM_HIST_BINS, dt=torch.int32)
    return acc


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, one add per slot.

    The order is explicit so the card and the CPU add in the same order and
    agree bitwise; the reference's ``jnp.sum`` takes XLA's reduction order,
    which agrees with this one only to rounding.
    """
    out = x[..., 0].clone()
    for i in range(1, x.shape[-1]):
        out += x[..., i]
    return out


def _stream_slab(
    draws: torch.Tensor,  # (S, J, b, r) unscaled service draws, compute dtype
    scales: torch.Tensor,  # (J,) per-job batch-size scale, compute dtype
    gaps: np.ndarray,  # (J,) inter-arrival deltas (gap[j] = a[j+1] - a[j]), compute dtype
    mask: np.ndarray,  # (J,) bool: real job vs slab padding (padding last)
    cls: np.ndarray,  # (J,) job-class ids (ignored when n_classes == 0)
    rel_free: torch.Tensor,  # (S, G) pool free-times relative to current arrival
    load: torch.Tensor,  # (S, G) cumulative placed load (balanced tie-break)
    acc: dict,  # accumulator carry, see stream_acc_init; updated in place
    edges: torch.Tensor,  # histogram edges in the compute dtype
    *,
    b: int,
    r: int,
    n_gangs: int,
    cancel_redundant: bool,
    balanced: bool,
    collect: bool,
    n_classes: int = 0,
):
    """One slab of the multi-gang streaming FIFO scan.

    Each arrival is a gang of ``b`` batches x ``r`` replicas dispatched to
    the earliest-free pool (ties: lowest index for packed/fifo, least
    cumulative placed load for balanced).  The per-job tensors come first,
    the cover times from one launch of the cover kernel (kernel A) on CUDA;
    then a Python loop over the slab's jobs carries ``rel_free`` and
    ``load`` on the device.  The accumulators fold each real job's response
    (wait + cover time) in job order: running sums one add per job, as the
    reference's scan step does; minima, maxima and the integer histograms,
    which no order changes, once per slab.  ``collect=True`` also returns the
    per-job arrays (waits, cover times, charged / planned / saved
    worker-seconds) for the materialized reference path.
    """
    d = draws * scales[None, :, None, None]
    n_reps, n_jobs = d.shape[0], d.shape[1]
    batch_min = d.amin(dim=-1)  # (S, J, b)
    t_job = gang_cover_times(d)  # (S, J): kernel A on CUDA
    hold = t_job if cancel_redundant else d.amax(dim=(-2, -1))
    planned = _slot_sum(d.reshape(n_reps, n_jobs, b * r))  # every replica's full duration
    busy = _slot_sum(batch_min) * r if cancel_redundant else planned
    saved = planned - busy
    dev, dt = d.device, d.dtype
    t_rows, h_rows = t_job.T.contiguous(), hold.T.contiguous()  # (J, S)
    pl_rows = planned.T.contiguous() if balanced else None
    gidx = torch.arange(n_gangs, dtype=dt, device=dev)
    cols = torch.arange(n_gangs, device=dev)
    resp = torch.empty((n_jobs, n_reps), dtype=dt, device=dev)
    waits = torch.zeros((n_jobs, n_reps), dtype=dt, device=dev) if collect else None
    for j, (gap, real) in enumerate(zip(gaps.tolist(), mask.tolist())):
        if not real:  # slab padding: the carry only moves by its gap (0)
            rel_free = rel_free - gap
            continue
        feas = rel_free.amin(dim=1)  # (S,) earliest any pool frees
        elig = rel_free <= feas[:, None]
        key = torch.where(elig, load if balanced else gidx, torch.inf)
        g = key.argmin(dim=1)  # ties -> lowest pool index
        wait = feas.clamp_min(0.0)
        torch.add(wait, t_rows[j], out=resp[j])
        sel = cols == g[:, None]
        rel_free = torch.where(sel, (wait + h_rows[j])[:, None], rel_free) - gap
        if balanced:
            load = load + torch.where(sel, pl_rows[j][:, None], 0.0)
        if collect:
            waits[j] = wait
    k = int(mask.sum())
    _fold_slab(acc, resp[:k], t_rows[:k], busy.T[:k], saved.T[:k],
               torch.as_tensor(cls[:k], device=dev), edges, n_classes)
    if collect:
        return rel_free, load, acc, (waits.T, t_job, busy, planned, saved)
    return rel_free, load, acc, None


def _fold_slab(acc, resp, comp, busy, saved, cls, edges, n_classes):
    """Fold a slab's real jobs, ``(k, S)`` rows in job order, into ``acc``."""
    k, n_reps = resp.shape
    if k == 0:
        return
    # max(sq, 0) is a value-identity on a square; it mirrors the reference,
    # where it pins the multiply as a standalone IEEE op against contraction
    resp2 = torch.clamp_min(resp * resp, 0.0)
    parts = [x[:, None, :] for x in (resp, resp2, comp, busy, saved)]
    sums = torch.stack([acc[f] for f in _SUM_FIELDS])  # (5, S)
    if n_classes:
        onehot = cls[:, None] == torch.arange(n_classes, device=resp.device)  # (k, C)
        parts.append(torch.where(onehot[:, :, None], resp[:, None, :], 0.0))  # (k, C, S)
        sums = torch.cat([sums, acc["class_resp_sum"].T])
    terms = torch.cat(parts, dim=1)  # (k, 5 + C, S)
    for j in range(k):  # one add per job, in job order, as the reference's scan
        sums += terms[j]
    for i, f in enumerate(_SUM_FIELDS):
        acc[f].copy_(sums[i])
    if n_classes:
        acc["class_resp_sum"].copy_(sums[len(_SUM_FIELDS):].T)
    acc["count"] += k
    torch.minimum(acc["resp_min"], resp.amin(dim=0), out=acc["resp_min"])
    torch.maximum(acc["resp_max"], resp.amax(dim=0), out=acc["resp_max"])
    bins = torch.searchsorted(edges, resp, right=True)  # (k, S)
    rep_ids = torch.arange(n_reps, device=resp.device).expand(k, n_reps)
    one = torch.ones((), dtype=torch.int32, device=resp.device).expand(k, n_reps)
    acc["hist"].index_put_((rep_ids, bins), one, accumulate=True)
    if n_classes:
        cls_ids = cls[:, None].expand(k, n_reps)
        acc["class_count"].index_put_((rep_ids, cls_ids), one, accumulate=True)
        acc["class_hist"].index_put_((rep_ids, cls_ids, bins), one, accumulate=True)
