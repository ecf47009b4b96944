"""The epoch scan in torch: churn, rescue, speeds, adaptive policies, space sharing.

Port of ``repro.cluster.epoch_scan``.  It replays the dynamic semantics of
the event-driven cluster engine (:mod:`repro_torch.cluster.master`) --
worker fail/join churn, replica rescue, per-worker speed factors, FIFO
multi-job gang dispatch, replica cancellation, the windowed online replanner
and reactive (speculative) backup replicas -- as a bounded step loop,
batched over Monte-Carlo reps (and, for planning, over a whole candidate
frontier).  On the gang lane each step performs exactly one action:

  * *rescue*: dispatch the oldest pending rescue onto the earliest-freeing
    alive worker, or
  * *backup*: with speculation on, launch one backup replica at a heartbeat
    epoch before the next completion, or
  * *commit + dispatch*: commit batch wins up to the next churn boundary
    (with speculation on, only the earliest completion-time group), feed the
    replanner's window, and gang-dispatch the next queued job, or
  * *commit + boundary*: apply one fail/join event (replica kill, rescue
    queueing, the engine's sim-over churn truncation).

The space lane (:func:`_space_step`; ``scheduler="packed"|"balanced"``,
``workers_per_job``, ``job_plans``) runs concurrent jobs on disjoint worker
subsets, each under its own (workers, B, cancellation) plan: every step
commits the wins and retirements up to the next churn boundary, then takes
one action -- a rescue (the job's own free workers first, else a regranted
unallocated one), a first-fit dispatch, or one fail/join event.

Every lane is one row of ``(L, ...)`` tensors on one device; a step is a
fixed sequence of eager torch operations on all of them, with no host
synchronisation.  The loop runs in chunks of :data:`_STEP_CHUNK` steps, and a
lane whose ``done`` predicate holds at a chunk boundary leaves the batch with
its state as it stands -- the freezing granularity of the reference's batched
``while_loop``, which fixes when straggling replicas commit and so the order
of the worker-second sums.

Reproducibility: lane ``i`` draws every replica duration, rescue duration,
backup duration and (under sampled churn) its own fail/join timeline on the
host from ``numpy.random.default_rng(SeedSequence((seed, i)))``, at the
reference's bucketed shapes (:func:`_shapes`), so both packages consume the
same numbers and ``rep_chunk`` is bit-identical to one call.  In float64
every output is the reference's bit for bit except ``worker_seconds`` and
``cancelled_seconds_saved``, sums over replica slots whose order neither XLA
nor torch fixes -- and except the replanner's refit: its logarithms and
``lgamma`` differ from XLA's in the last bits, so it is held to the
reference's *decisions* (which family, which B, when), and every time
downstream of equal decisions is bitwise.  ``outputs="stream"`` folds the
same lanes' per-job records into :class:`EpochStreamReport` on the device,
in arrival order.  Lane batches are not padded to powers of two: the
reference pads them for its compile cache, and padding lanes carry no result.
``devices > 1`` is refused by name: the port runs every lane on one device.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..core.analysis import divisor_table, harmonic_tables
from ..core.service_time import ServiceTime
from .scenario import UNSET, Scenario, Speculation, resolve_scenario
from .scheduler import is_space
from .workers import ChurnProcess, ChurnSchedule

__all__ = [
    "ReplanConfig",
    "EpochReport",
    "EpochStreamReport",
    "simulate_epochs",
    "frontier_job_times_dynamic",
]

# steps run since import (or since a caller last reset it to 0), summed over
# lane batches: each batch adds _STEP_CHUNK per chunk it runs
steps_run = 0


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """The in-scan replanner's knobs: a static mirror of
    :class:`~repro_torch.cluster.control.OnlineReplanner`'s.

    ``to_controller`` builds the equivalent controller, so one config drives
    both the scan and its function-level oracle.
    """

    window: int = 512
    refit_every: int = 128
    min_observations: int = 64
    objective: str = "mean"
    blend: float = 0.5

    def to_controller(self, n_workers: int):
        """Materialize this config as an :class:`~repro_torch.cluster.control.OnlineReplanner`."""
        from .control import OnlineReplanner

        return OnlineReplanner(
            n_workers,
            objective=self.objective,
            window=self.window,
            refit_every=self.refit_every,
            min_observations=self.min_observations,
            blend=self.blend,
        )


@dataclasses.dataclass(frozen=True)
class EpochReport:
    """Batched outcome of :func:`simulate_epochs` (axis 0 = Monte-Carlo rep).

    Mirrors the engine's ``EngineReport`` field for field where the
    semantics overlap; ``inf`` marks jobs never dispatched / completed (dead
    cluster), exactly like the engine's unfinished records.
    ``epoch_times`` are the applied churn-event times per rep (inf-padded).
    """

    arrivals: np.ndarray  # (n_jobs,)
    starts: np.ndarray  # (n_reps, n_jobs)
    finishes: np.ndarray  # (n_reps, n_jobs)
    n_batches_used: np.ndarray  # (n_reps, n_jobs)
    replication_used: np.ndarray  # (n_reps, n_jobs)
    worker_seconds: np.ndarray  # (n_reps,)
    cancelled_seconds_saved: np.ndarray  # (n_reps,)
    n_worker_failures: np.ndarray  # (n_reps,)
    n_replicas_rescued: np.ndarray  # (n_reps,)
    n_replans: np.ndarray  # (n_reps,)
    epoch_times: np.ndarray  # (n_reps, n_events) applied boundaries, inf pad
    n_speculative: np.ndarray = None  # (n_reps,) reactive backups launched
    # (n_reps,) bool: the rep's timeline outran its sampled churn horizon;
    # None when churn is scheduled or absent -- see simulate_epochs
    churn_truncated: np.ndarray = None

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

    @property
    def final_n_batches(self) -> np.ndarray:
        """The B each rep ended the run on."""
        return self.n_batches_used[:, -1]

    def accounting(self) -> dict:
        """Per-rep counters, keyed identically to ``EngineReport.accounting``."""
        return {
            "worker_seconds": self.worker_seconds,
            "cancelled_seconds_saved": self.cancelled_seconds_saved,
            "n_worker_failures": self.n_worker_failures,
            "n_replicas_rescued": self.n_replicas_rescued,
            "n_replans": self.n_replans,
            "n_speculative": (
                self.n_speculative
                if self.n_speculative is not None
                else np.zeros_like(self.n_replans)
            ),
            # task-level payload failures exist on the engine and the live
            # runtime only; the lanes report structural zeros so the
            # accounting key set stays identical across backends
            "n_task_failures": np.zeros_like(self.n_replans),
            "n_retries": np.zeros_like(self.n_replans),
        }


@dataclasses.dataclass(frozen=True)
class EpochStreamReport:
    """``Scenario.outputs="stream"`` outcome of :func:`simulate_epochs`.

    Carries O(n_reps) streaming aggregates instead of ``(n_reps, n_jobs)``
    per-job records: ``stats`` is a
    :class:`~repro_torch.cluster.stream.StreamStats` whose response/compute
    fields come from the fold on the device (its ``busy_sum`` / ``saved_sum``
    are the lane's per-rep worker-seconds totals), plus the usual per-rep
    counters.  ``n_unfinished`` counts jobs never completed (dead cluster);
    they are left out of the statistics.  On float64 lanes the stats equal
    :func:`~repro_torch.cluster.stream.epoch_stream_stats` of the equivalent
    ``outputs="full"`` report bit for bit.
    """

    arrivals: np.ndarray  # (n_jobs,)
    stats: object  # StreamStats (stream.py is imported lazily)
    n_unfinished: np.ndarray  # (n_reps,)
    worker_seconds: np.ndarray  # (n_reps,)
    cancelled_seconds_saved: np.ndarray  # (n_reps,)
    n_worker_failures: np.ndarray  # (n_reps,)
    n_replicas_rescued: np.ndarray  # (n_reps,)
    n_replans: np.ndarray  # (n_reps,)
    n_speculative: np.ndarray = None  # (n_reps,)
    churn_truncated: np.ndarray = None  # see EpochReport

    def accounting(self) -> dict:
        """Per-rep counters, keyed identically to ``EpochReport.accounting``."""
        return EpochReport.accounting(self)


# --------------------------------------------------------------------------
# shape buckets (part of the draw contract: draws are made at these shapes)
# --------------------------------------------------------------------------

_STEP_CHUNK = 16  # steps per early-exit check


def _pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1): the shape-bucket rounding."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def _bucket_workers(n: int) -> int:
    """Worker counts bucket to multiples of 4 (the reference's padding)."""
    return max(4, -(-int(n) // 4) * 4)


@dataclasses.dataclass(frozen=True)
class _RunnerCfg:
    """Static configuration of one lane batch."""

    n: int  # padded worker count
    jobs_pad: int
    ev_pad: int
    resc_cap: int
    n_chunks: int
    cancel: bool
    size_dep: bool
    dtype: str
    # False drops the per-event epoch-times buffer and the per-job B/r
    # records; the planning path and the streaming fold read starts/finishes
    full_outputs: bool = True
    replan: Optional[ReplanConfig] = None
    # reactive backups: a third replica-slot range and event-granular commits
    spec: Optional[Speculation] = None
    # fold starts/finishes into EpochStreamReport accumulators on the device
    stream: bool = False
    # None runs the single-gang lane; a policy name runs the space lane
    # (per-worker job assignment, per-job plan tables)
    scheduler: Optional[str] = None

    @property
    def n_slots(self) -> int:
        """Replica slots: [0, n) gang replica of worker i, [n, 2n) rescue of
        batch i - n, and with speculation [2n, 3n) the backup of batch i - 2n."""
        return (3 if self.spec is not None else 2) * self.n


# --------------------------------------------------------------------------
# the lane batch: one Monte-Carlo rep of one candidate per row
# --------------------------------------------------------------------------


def _init_state(cfg: _RunnerCfg, b0: torch.Tensor, n_real: int, dt, dev) -> dict:
    n, L = cfg.n, b0.shape[0]
    ns = cfg.n_slots
    inf = float("inf")
    i64 = torch.int64

    def lanes(dtype, fill=0):
        return torch.full((L,), fill, dtype=dtype, device=dev)

    # buffers written by gated scatters carry one sentinel column past their
    # end: a write switched off points there (the reference's dropped
    # out-of-bounds scatter) and every read slices it away
    alive = torch.zeros(L, n + 1, dtype=torch.bool, device=dev)
    alive[:, :n_real] = True
    st = {
        "t_cursor": lanes(dt),
        "e": lanes(i64),
        "alive": alive,
        "q": lanes(i64),
        "job_active": lanes(torch.bool, False),
        "job_b": lanes(i64, 1),
        "q_active": lanes(i64),
        "g_b": torch.zeros(L, n, dtype=i64, device=dev),
        "rb_w": torch.zeros(L, n + 1, dtype=i64, device=dev),
        "rp_live": torch.zeros(L, ns + 1, dtype=torch.bool, device=dev),
        "rp_start": torch.zeros(L, ns + 1, dtype=dt, device=dev),
        "rp_end": torch.full((L, ns + 1), inf, dtype=dt, device=dev),
        "batch_done": torch.ones(L, n, dtype=torch.bool, device=dev),
        "batch_done_t": torch.full((L, n), -inf, dtype=dt, device=dev),
        "resc_pending": torch.zeros(L, n + 1, dtype=torch.bool, device=dev),
        "resc_t": torch.full((L, n), inf, dtype=dt, device=dev),
        "resc_k": lanes(i64),
        "busy": lanes(dt),
        "saved": lanes(dt),
        "n_fail": lanes(i64),
        "n_resc": lanes(i64),
        "n_replans": lanes(i64),
        "plan_b": b0.to(i64),
        "starts": torch.full((L, cfg.jobs_pad + 1), inf, dtype=dt, device=dev),
        "fins": torch.full((L, cfg.jobs_pad + 1), inf, dtype=dt, device=dev),
        # the lane's global row in the batch's inputs and outputs
        "row": torch.arange(L, device=dev),
    }
    if cfg.full_outputs:
        st["br"] = torch.zeros(L, cfg.jobs_pad + 1, dtype=i64, device=dev)
        st["ep_times"] = torch.full((L, cfg.ev_pad + 1), inf, dtype=dt, device=dev)
    if cfg.replan is not None:
        w = cfg.replan.window
        # the observation ring: task times and their censoring counts
        st["obs_val"] = torch.zeros(L, w + 1, dtype=dt, device=dev)
        st["obs_comp"] = torch.ones(L, w + 1, dtype=dt, device=dev)
        st["obs_head"] = lanes(i64)
        st["obs_count"] = lanes(i64)
        st["since_refit"] = lanes(i64)
    if cfg.spec is not None:
        st["sb_w"] = torch.zeros(L, n + 1, dtype=i64, device=dev)
        st["spec_obs"] = torch.full((L, n), inf, dtype=dt, device=dev)
        st["spec_used"] = lanes(i64)
        st["spec_k"] = lanes(i64)
        st["spec_now"] = lanes(dt)
        st["n_spec"] = lanes(i64)
    return st


def _obs_push(cfg: _RunnerCfg, st: dict, vals, comps, times, valid) -> None:
    """Push the valid observations into the ring in completion-time order:
    they take ranks 0..nv-1 under a stable sort of their times and land at
    head + rank; the rest go to the sentinel column."""
    w = cfg.replan.window
    valid = valid & (vals > 0.0) & torch.isfinite(vals)
    nv = valid.sum(1)
    order = torch.argsort(torch.where(valid, times, float("inf")), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    pos = torch.where(valid, (st["obs_head"][:, None] + rank) % w, w)
    st["obs_val"].scatter_(1, pos, vals)
    st["obs_comp"].scatter_(1, pos, comps)
    st["obs_head"] = (st["obs_head"] + nv) % w
    st["obs_count"] = (st["obs_count"] + nv).clamp(max=w)
    st["since_refit"] += nv


def _replan_pick(cfg: _RunnerCfg, st: dict, inp: dict, alive) -> tuple:
    """Every lane's refit and re-pick of B (the reference's expressions).

    Maximum-likelihood fits of Exp / SExp / Pareto on the window, picked by
    log-likelihood (``core.planner.fit_service_time``), the min-of-c
    censoring inversion (``control._inverse_min``), and the closed-form
    frontier argmin over the divisors of the alive count (``core.analysis``
    forms, ``lgamma`` for the Pareto moments).  Returns each lane's new B
    (lanes with no alive worker keep theirs) and the family it fitted
    (0 Exp, 1 SExp, 2 Pareto).
    """
    w = cfg.replan.window
    inf, tiny = float("inf"), 1e-30
    m = torch.arange(w, device=alive.device) < st["obs_count"][:, None]
    x = st["obs_val"][:, :w]
    dt = x.dtype
    nobs = st["obs_count"].clamp(min=1).to(dt)
    sx = torch.where(m, x, 0.0).sum(1)
    mean = sx / nobs
    xmin = torch.where(m, x, inf).amin(1)
    slogx = torch.where(m, torch.log(x.clamp(min=tiny)), 0.0).sum(1)
    mu_e = 1.0 / mean.clamp(min=tiny)
    ll_e = nobs * torch.log(mu_e) - mu_e * sx
    gap = mean - xmin
    mu_s = 1.0 / gap.clamp(min=tiny)
    ll_s = torch.where(gap > 0, nobs * torch.log(mu_s) - mu_s * (sx - nobs * xmin), -inf)
    log_xmin = torch.log(xmin.clamp(min=tiny))
    slogs = slogx - nobs * log_xmin
    alpha = nobs / slogs.clamp(min=tiny)
    ll_p = torch.where(
        slogs > 0, nobs * torch.log(alpha) + nobs * alpha * log_xmin - (alpha + 1.0) * slogx, -inf
    )
    fam = torch.stack([ll_e, ll_s, ll_p], 1).argmax(1)[:, None]
    c = (torch.where(m, st["obs_comp"][:, :w], 0.0).sum(1) / nobs).clamp(min=1.0)
    mu_e, mu_s, alpha_c = (mu_e / c)[:, None], (mu_s / c)[:, None], (alpha / c)[:, None]
    xmin = xmin[:, None]

    n_alive = alive.sum(1)
    cands = inp["div_tab"][n_alive]  # (L, D), zero-padded
    c1 = cands.clamp(min=1)
    b = c1.to(dt)
    h1, h2 = inp["h1"][c1], inp["h2"][c1]
    na = n_alive.to(dt)[:, None]
    mean_e = h1 / mu_e
    cov_e = torch.sqrt(h2) / h1
    mean_s = na * xmin / b + h1 / mu_s
    cov_s = torch.sqrt(h2) / (na * xmin * mu_s / b + h1)
    xp = b / (na * alpha_c).clamp(min=tiny)
    lg = torch.lgamma
    lgm = torch.log((na * xmin / b).clamp(min=tiny)) + lg(b + 1.0)
    lgm = lgm - lg(b + 1.0 - xp) + lg(1.0 - xp)
    mean_p = torch.where(xp < 1.0, torch.exp(lgm), inf)
    lgq = (
        lg(1.0 - 2.0 * xp)
        + 2.0 * lg(b + 1.0 - xp)
        - lg(b + 1.0)
        - lg(b + 1.0 - 2.0 * xp)
        - 2.0 * lg(1.0 - xp)
    )
    cov_p = torch.where(2.0 * xp < 1.0, torch.sqrt((torch.exp(lgq) - 1.0).clamp(min=0.0)), inf)
    vb = cands > 0
    means = torch.where(vb, torch.where(fam == 0, mean_e, torch.where(fam == 1, mean_s, mean_p)),
                        inf)
    covs = torch.where(vb, torch.where(fam == 0, cov_e, torch.where(fam == 1, cov_s, cov_p)), inf)
    objective = cfg.replan.objective
    if objective == "mean":
        score = means
    elif objective == "cov":
        score = covs
    else:  # "blend" (Scenario.validate refuses any other)
        finite = torch.isfinite(means) & torch.isfinite(covs)

        def norm01(v):
            lo = torch.where(finite, v, inf).amin(1, keepdim=True)
            hi = torch.where(finite, v, -inf).amax(1, keepdim=True)
            return torch.where(finite, (v - lo) / (hi - lo).clamp(min=1e-12), 0.0)

        blend = inp["blend"]
        score = torch.where(finite, blend * norm01(means) + (1.0 - blend) * norm01(covs), inf)
    new_b = cands.gather(1, score.argmin(1, keepdim=True))[:, 0]
    return torch.where(n_alive > 0, new_b.clamp(min=1), st["plan_b"]), fam[:, 0]


def _spec_launch(cfg: _RunnerCfg, st: dict, inp: dict, rp_b, rp_w, win, can_r, t_next,
                 batch_scale):
    """The speculative backup trigger, and a launch where it fires (in place).

    The running lower median of the job's completed sibling durations, each
    unfinished batch's youngest live replica crossing at start + theta x
    median, and the launch on the first heartbeat epoch strictly after both
    the crossing and the last processed event -- ``SpeculativePolicy``'s
    float expressions.  A launch happens only strictly before the next
    replica-completion event ``t_evm`` (a batch win under cancellation, any
    replica end otherwise), which the commit then uses to take one
    completion-time group per step.  Returns ``(can_s, t_evm)``.
    """
    n, ns, spec = cfg.n, cfg.n_slots, cfg.spec
    inf = float("inf")
    row = st["row"]
    L = row.shape[0]
    bidx = wid = inp["bidx"]
    live = st["rp_live"][:, :ns]
    rp_start = st["rp_start"][:, :ns]
    alive = st["alive"][:, :n]
    obs = st["spec_obs"]
    ofin = torch.isfinite(obs)
    cnt = ofin.sum(1)
    mid = ((cnt - 1) // 2).clamp(min=0)
    med = torch.sort(torch.where(ofin, obs, inf), 1).values.gather(1, mid[:, None])[:, 0]
    y_b = torch.full((L, n), -inf, dtype=obs.dtype, device=row.device).scatter_reduce_(
        1, rp_b, torch.where(live, rp_start, -inf), "amax"
    )
    occ = torch.zeros(L, n + 1, dtype=torch.bool, device=row.device).scatter_(
        1, torch.where(live, rp_w, n), True
    )[:, :n]
    free = alive & ~occ
    elig = (
        (st["job_active"] & (cnt >= spec.min_observations) & free.any(1)
         & (st["spec_used"] < spec.max_backups))[:, None]
        & ~st["batch_done"]
        & torch.isfinite(y_b)  # the batch holds a live replica
        & ~live[:, 2 * n:]  # one live backup per batch
    )
    now_s = torch.maximum(st["t_cursor"], st["spec_now"])
    # a device scalar: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which would round differently from the CPU
    iv = inp["interval"]
    thm = (spec.theta * med)[:, None]
    k = torch.maximum(torch.floor((y_b + thm) / iv), torch.floor(now_s / iv)[:, None]) + 1.0
    t_spec = torch.where(elig, k * iv, inf).amin(1)
    if cfg.cancel:
        t_evm = torch.where(~st["batch_done"], win, inf).amin(1)
    else:
        t_evm = torch.where(live, st["rp_end"][:, :ns], inf).amin(1)
    can_s = ~can_r & torch.isfinite(t_spec) & (t_spec < t_evm) & (t_spec < t_next)
    # the check at the epoch itself (the engine's lagging(now - y, med)); a
    # check that launches nothing still consumes the epoch
    lag = elig & ((t_spec[:, None] - y_b) > thm)
    b_s = torch.where(lag, bidx, n).argmin(1)
    do_l = can_s & lag.any(1)
    w_s = torch.where(free, wid, n).argmin(1)
    sk = st["spec_k"].clamp(0, inp["tau_spec"].shape[1] - 1)
    dur_s = inp["tau_spec"][row, sk, b_s] * batch_scale(st["job_b"]) / inp["speeds"][w_s]
    i_sl = torch.where(do_l, 2 * n + b_s, ns)[:, None]
    st["sb_w"].scatter_(1, torch.where(do_l, b_s, n)[:, None], w_s[:, None])
    st["rp_start"].scatter_(1, i_sl, t_spec[:, None])
    st["rp_end"].scatter_(1, i_sl, (t_spec + dur_s)[:, None])
    st["rp_live"].scatter_(1, i_sl, True)
    st["spec_used"] += do_l
    st["n_spec"] += do_l
    st["spec_k"] += do_l
    st["spec_now"] = torch.where(can_s, t_spec, st["spec_now"])
    return can_s, t_evm


def _step(cfg: _RunnerCfg, st: dict, inp: dict) -> None:
    """One action per step, as one gated pass over every lane (in place).

    The expressions, and the order in which each reads the state, are the
    reference's (``epoch_scan.py::_build_lane``), so every value but the two
    worker-second sums is bitwise equal in float64 (given equal replanner
    decisions).
    """
    n, jobs_pad, ev_pad, resc_cap = cfg.n, cfg.jobs_pad, cfg.ev_pad, cfg.resc_cap
    ns = cfg.n_slots
    spec, replan = cfg.spec, cfg.replan
    inf = float("inf")
    row = st["row"]
    L = row.shape[0]
    bidx = wid = inp["bidx"]
    speeds, n_tasks = inp["speeds"], inp["n_tasks"]
    e = st["e"]
    t_next = inp["ev_t"][row, e]
    # replica slot -> (batch, worker): gang, rescue, then the backup bank
    rp_b = [st["g_b"], bidx.expand(L, n)]
    rp_w = [wid.expand(L, n), st["rb_w"][:, :n]]
    if spec is not None:
        rp_b.append(bidx.expand(L, n))
        rp_w.append(st["sb_w"][:, :n])
    rp_b, rp_w = torch.cat(rp_b, 1), torch.cat(rp_w, 1)
    live = st["rp_live"][:, :ns]
    rp_start = st["rp_start"][:, :ns]
    rp_end = st["rp_end"][:, :ns]
    alive = st["alive"][:, :n]
    resc_pending = st["resc_pending"][:, :n]
    # per-batch earliest live replica end (segment min; seg always in bounds)
    win = torch.full((L, n), inf, dtype=rp_end.dtype, device=row.device).scatter_reduce_(
        1, rp_b, torch.where(live, rp_end, inf), "amin"
    )

    def batch_scale(job_b):
        return n_tasks / job_b.to(n_tasks.dtype) if cfg.size_dep else inp["one"]

    # -- rescue: oldest pending rescue onto the earliest-freeing alive worker,
    # from the pre-commit state
    if cfg.cancel:
        proj_vals = torch.where(live, win.gather(1, rp_b), -inf)
    else:
        proj_vals = torch.where(live, rp_end, -inf)
    proj = torch.full_like(win, -inf).scatter_reduce_(1, rp_w, proj_vals, "amax")
    wfree = torch.where(alive, torch.maximum(proj, st["t_cursor"][:, None]), inf)
    wfree = torch.where(wfree <= t_next[:, None], wfree, inf)
    tgt = torch.argmin(torch.where(resc_pending, st["resc_t"], inf), 1)
    wstar = torch.argmin(wfree, 1)
    td_r = wfree.gather(1, wstar[:, None])[:, 0]
    can_r = resc_pending.any(1) & torch.isfinite(td_r) & st["job_active"]
    rk = st["resc_k"].clamp(0, resc_cap - 1)
    dur_r = inp["tau_resc"][row, rk, tgt] * batch_scale(st["job_b"]) / speeds[wstar]
    i_tgt = torch.where(can_r, tgt, n)[:, None]
    i_slot = torch.where(can_r, n + tgt, ns)[:, None]
    st["rb_w"].scatter_(1, i_tgt, wstar[:, None])
    st["rp_start"].scatter_(1, i_slot, td_r[:, None])
    st["rp_end"].scatter_(1, i_slot, (td_r + dur_r)[:, None])
    st["rp_live"].scatter_(1, i_slot, True)
    st["resc_pending"].scatter_(1, i_tgt, False)
    st["n_resc"] += can_r
    st["resc_k"] += can_r

    # -- speculative backup trigger (reactive replication)
    if spec is not None:
        can_s, t_evm = _spec_launch(cfg, st, inp, rp_b, rp_w, win, can_r, t_next, batch_scale)

    # -- commit completions up to the next boundary (none on rescue steps);
    # with speculation on, only the earliest completion-time group, so later
    # completions see the launches that precede them
    newly = ~st["batch_done"] & (win <= t_next[:, None]) & torch.isfinite(win) & ~can_r[:, None]
    if spec is not None:
        newly &= (win == t_evm[:, None]) & ~can_s[:, None]
    if cfg.cancel:
        win_r = win.gather(1, rp_b)
        done_r = live & newly.gather(1, rp_b)
        busy_add = torch.where(done_r, win_r - rp_start, 0.0).sum(1)
        saved_add = torch.where(done_r, rp_end - win_r, 0.0).sum(1)
        t_new = torch.where(newly, win, -inf).amax(1)
    else:
        done_r = live & (rp_end <= t_next[:, None]) & ~can_r[:, None]
        if spec is not None:
            done_r &= (rp_end == t_evm[:, None]) & ~can_s[:, None]
        busy_add = torch.where(done_r, rp_end - rp_start, 0.0).sum(1)
        saved_add = None
        t_new = torch.where(done_r, rp_end, -inf).amax(1)
    if spec is not None:
        # the winning replica's wall-clock duration is the sibling
        # observation the median runs over; ties keep the smallest start
        is_w = live & newly.gather(1, rp_b) & (rp_end <= win.gather(1, rp_b))
        w_st = torch.full((L, n + 1), inf, dtype=rp_start.dtype, device=row.device)
        w_st = w_st.scatter_reduce_(1, torch.where(is_w, rp_b, n), rp_start, "amin")[:, :n]
        st["spec_obs"] = torch.where(newly, win - w_st, st["spec_obs"])
    done2 = st["batch_done"] | newly
    done_t2 = torch.where(newly, win, st["batch_done_t"])
    all_done = done2.all(1)
    fin = torch.where(bidx < st["job_b"][:, None], done_t2, -inf).amax(1)
    settled = all_done & ~can_r
    completes = st["job_active"] & settled
    live &= ~done_r
    st["busy"] += busy_add
    if saved_add is not None:
        st["saved"] += saved_add
    st["batch_done"] = done2
    st["batch_done_t"] = done_t2
    st["t_cursor"] = torch.maximum(
        st["t_cursor"], torch.maximum(t_new, torch.where(completes, fin, -inf))
    )
    st["fins"].scatter_(1, torch.where(completes, st["q_active"], jobs_pad)[:, None], fin[:, None])
    st["job_active"] &= ~settled
    resc_pending &= ~completes[:, None]

    if replan is not None:
        sc = batch_scale(st["job_b"])
        sc = sc[:, None] if cfg.size_dep else sc
        spd = speeds[rp_w]
        raced = live | done_r  # the replicas live before this commit
        if cfg.cancel:
            # one observation per newly won batch: the winner's task time,
            # censored by however many rivals it raced
            cand = raced & (rp_end <= win.gather(1, rp_b))
            slots = torch.arange(ns, device=row.device).expand(L, ns)
            win_slot = torch.full((L, n + 1), ns, dtype=torch.int64, device=row.device)
            win_slot = win_slot.scatter_reduce_(1, torch.where(cand, rp_b, n), slots, "amin")
            ws = win_slot[:, :n].clamp(0, ns - 1)
            vals = (win - rp_start.gather(1, ws)) * spd.gather(1, ws) / sc
            comps = torch.zeros(L, n + 1, dtype=torch.int64, device=row.device).scatter_add_(
                1, torch.where(raced, rp_b, n), torch.ones_like(rp_b)
            )[:, :n].to(vals.dtype)
            _obs_push(cfg, st, vals, comps, win, newly)
        else:
            # every replica that completes while its job is active is an
            # uncensored observation (stragglers outliving their job drop)
            fin_limit = torch.where(completes, fin, inf)
            ovalid = done_r & (st["job_active"] | completes)[:, None] & (
                rp_end <= fin_limit[:, None]
            )
            vals = (rp_end - rp_start) * spd / sc
            _obs_push(cfg, st, vals, torch.ones_like(vals), rp_end, ovalid)
        do_replan = (
            completes
            & (st["obs_count"] >= replan.min_observations)
            & (st["since_refit"] >= replan.refit_every)
        )
        # computed for every lane on every step, as the reference's is: a
        # host-side test of do_replan would synchronise on every step
        new_b, _ = _replan_pick(cfg, st, inp, alive)
        st["plan_b"] = torch.where(do_replan, new_b, st["plan_b"])
        st["n_replans"] += do_replan
        st["since_refit"] = torch.where(do_replan, 0, st["since_refit"])

    # -- gang-dispatch the next queued job (whole-cluster FIFO gangs)
    n_alive = alive.sum(1)
    q = st["q"]
    can_d = ~st["job_active"] & (q < inp["jobs_real"]) & (n_alive > 0) & ~live.any(1) & ~can_r
    # an out-of-range job index clamps, as a jax gather does; can_d is
    # already false there
    qc = q.clamp(max=jobs_pad - 1)
    td = torch.maximum(st["t_cursor"], inp["arrivals"][qc])
    can_d &= td < t_next
    b = torch.where(st["plan_b"] > 0, st["plan_b"], n_alive)
    b = torch.minimum(b.clamp(min=1), n_alive.clamp(min=1))
    r = n_alive // b.clamp(min=1)
    rank = torch.cumsum(alive, 1) - 1
    sel = alive & (rank < (b * r)[:, None])
    # draw index = alive-rank (free workers in wid order draw sequentially);
    # batch = rank mod b.  A leading dead worker's rank of -1 clamps: its
    # value is masked out below
    dur = inp["tau"][row, qc].gather(1, rank.clamp(min=0)) * batch_scale(b)[..., None] / speeds
    go = can_d[:, None] & sel
    st["g_b"] = torch.where(go, rank % b[:, None], st["g_b"])
    # can_d needs every slot dead, so dispatch writes the gang slots only
    live[:, :n] |= go
    rp_start[:, :n] = torch.where(go, td[:, None], rp_start[:, :n])
    rp_end[:, :n] = torch.where(go, td[:, None] + dur, rp_end[:, :n])
    over = bidx >= b[:, None]
    st["batch_done"] = torch.where(can_d[:, None], over, st["batch_done"])
    st["batch_done_t"] = torch.where(
        can_d[:, None], torch.where(over, -inf, inf), st["batch_done_t"]
    )
    st["job_active"] |= can_d
    st["job_b"] = torch.where(can_d, b, st["job_b"])
    st["q_active"] = torch.where(can_d, q, st["q_active"])
    i_q = torch.where(can_d, q, jobs_pad)[:, None]
    st["starts"].scatter_(1, i_q, td[:, None])
    if cfg.full_outputs:
        st["br"].scatter_(1, i_q, (b << 16 | r)[:, None])
    st["q"] = q + can_d
    if spec is not None:
        # the policy's per-job state resets at dispatch
        st["spec_obs"] = torch.where(can_d[:, None], inf, st["spec_obs"])
        st["spec_used"] = torch.where(can_d, 0, st["spec_used"])

    # -- otherwise apply one fail/join event (the engine stops replaying
    # churn once every job is recorded: the sim_over gate)
    t_ev = t_next
    w_raw = inp["ev_w"][row, e]
    up = inp["ev_up"][row, e]
    do_b = ~can_r & ~can_d
    if spec is not None:
        # a launch or a committed completion group consumed this step
        do_b &= ~can_s & ~newly.any(1) & ~done_r.any(1)
    sim_over = (st["q"] >= inp["jobs_real"]) & ~st["job_active"]
    act = do_b & (w_raw >= 0) & torch.isfinite(t_ev) & ~sim_over
    w = w_raw.clamp(0, n - 1)
    was = alive.gather(1, w[:, None])[:, 0]
    do_fail = act & ~up & was
    flip = do_fail | (act & up & ~was)
    # a fail flips alive to False (= up), a join to True (= up)
    st["alive"].scatter_(1, torch.where(flip, w, n)[:, None], up[:, None])
    kill = live & (rp_w == w[:, None]) & do_fail[:, None]
    st["busy"] += torch.where(kill, t_ev[:, None] - rp_start, 0.0).sum(1)
    live &= ~kill
    # a batch that just lost its last live replica needs a rescue: one
    # segment count carries both indicators (kills in the low bits,
    # survivors shifted past any possible kill count)
    seg = torch.zeros(L, n, dtype=torch.int32, device=row.device).scatter_add_(
        1, rp_b, kill.to(torch.int32) + 4096 * live.to(torch.int32)
    )
    lost = ((seg & 4095) > 0) & (seg < 4096) & ~st["batch_done"]
    resc_pending |= lost
    st["resc_t"] = torch.where(lost, t_ev[:, None], st["resc_t"])
    st["n_fail"] += do_fail
    # a churn event that itself frees the gang dispatches at its own time
    st["t_cursor"] = torch.maximum(
        st["t_cursor"],
        torch.where(do_b & torch.isfinite(t_ev), t_ev.clamp(min=0.0), -inf),
    )
    if cfg.full_outputs:
        st["ep_times"].scatter_(1, torch.where(flip, e, ev_pad)[:, None], t_ev[:, None])
    st["e"] = (e + do_b).clamp(max=ev_pad - 1)


# --------------------------------------------------------------------------
# the space lane: concurrent jobs on disjoint worker subsets
# --------------------------------------------------------------------------


def _init_space_state(cfg: _RunnerCfg, b0: torch.Tensor, n_real: int, dt, dev) -> dict:
    """The space lane's state, under the reference's names
    (``epoch_scan.py::_build_space_lane``): per worker the owning job
    ``w_job`` (``jobs_pad`` = unallocated), the time it is next available
    ``w_avail`` and its assigned load ``w_load``; per replica slot (gang
    replica of worker i, then rescue replica of segment i) ``rp_*``; per
    segment slot its owning job ``seg_job`` and rescue bookkeeping; per job
    ``job_*``.  Buffers written by gated scatters carry a sentinel column,
    as in :func:`_init_state`."""
    n, J, L = cfg.n, cfg.jobs_pad, b0.shape[0]
    inf = float("inf")
    i64 = torch.int64

    def lanes(dtype, fill=0):
        return torch.full((L,), fill, dtype=dtype, device=dev)

    def per(width, dtype, fill):
        return torch.full((L, width), fill, dtype=dtype, device=dev)

    up = torch.arange(n + 1, device=dev) < n_real
    st = {
        "t_epoch": lanes(dt),
        "e": lanes(i64),
        "alive": up.expand(L, n + 1).clone(),
        "w_job": per(n + 1, i64, J),
        "w_avail": torch.where(up, 0.0, inf).to(dt).expand(L, n + 1).clone(),
        "w_load": per(n + 1, dt, 0.0),
        "g_s": per(n, i64, n),
        "rb_w": per(n + 1, i64, 0),
        "rp_live": per(2 * n + 1, torch.bool, False),
        "rp_start": per(2 * n + 1, dt, 0.0),
        "rp_end": per(2 * n + 1, dt, inf),
        "rp_cancel": per(2 * n + 1, torch.bool, False),
        "seg_job": per(n, i64, J),
        "resc_pending": per(n + 1, torch.bool, False),
        "resc_t": per(n, dt, inf),
        "resc_k": lanes(i64),
        "busy": lanes(dt),
        "saved": lanes(dt),
        "n_fail": lanes(i64),
        "n_resc": lanes(i64),
        "n_done": lanes(i64),
        "n_replans": lanes(i64),  # the space lane never replans
        "dispatched": per(J + 1, torch.bool, False),
        "recorded": per(J + 1, torch.bool, False),
        "job_left": per(J + 1, i64, 0),
        "job_b": per(J + 1, i64, 1),
        "job_fin": per(J + 1, dt, -inf),
        "starts": per(J + 1, dt, inf),
        "fins": per(J + 1, dt, inf),
        "b0": b0.to(i64),
        "row": torch.arange(L, device=dev),
    }
    if cfg.full_outputs:
        st["br"] = per(J + 1, i64, 0)
        st["ep_times"] = per(cfg.ev_pad + 1, dt, inf)
    return st


def _space_step(cfg: _RunnerCfg, st: dict, inp: dict) -> None:
    """One step of the space lane over every lane (in place): commit wins
    and retirements up to the next churn boundary, then one action -- a
    rescue, else a first-fit dispatch, else one fail/join event.

    The expressions, and the order in which each reads the state, are the
    reference's (``epoch_scan.py::_build_space_lane``): rescues serve the
    earliest-serveable pending segment (oldest first on ties) from the
    job's own free workers before regranting an unallocated one; a dispatch
    takes the queued job with the earliest feasible time (its request-th
    smallest availability among free unallocated workers, floored at its
    arrival and the epoch start; ties by queue order) onto the policy's
    workers (packed: lowest ids; balanced: least ``w_load``; fifo_gang: the
    whole alive set).  Gated writes go to the sentinel columns.
    """
    n, J, ev_pad, resc_cap = cfg.n, cfg.jobs_pad, cfg.ev_pad, cfg.resc_cap
    balanced = cfg.scheduler == "balanced"
    inf = float("inf")
    row = st["row"]
    L, dev = row.shape[0], row.device
    widx = inp["bidx"]
    speeds, n_tasks = inp["speeds"], inp["n_tasks"]
    dt = speeds.dtype

    def bscale(b):
        return n_tasks / b.to(dt) if cfg.size_dep else inp["one"]

    e = st["e"]
    t_next = inp["ev_t"][row, e]
    tn = t_next[:, None]
    rp_seg = torch.cat([st["g_s"], widx.expand(L, n)], 1)
    rp_w = torch.cat([widx.expand(L, n), st["rb_w"][:, :n]], 1)
    seg_of = rp_seg.clamp(0, n - 1)
    live = st["rp_live"][:, : 2 * n]
    rp_start = st["rp_start"][:, : 2 * n]
    rp_end = st["rp_end"][:, : 2 * n]
    rp_cancel = st["rp_cancel"][:, : 2 * n]
    alive = st["alive"][:, :n]
    w_avail = st["w_avail"][:, :n]
    w_load = st["w_load"][:, :n]
    resc_pending = st["resc_pending"][:, :n]
    occupied = st["seg_job"] < J

    # -- commit batch wins and replica retirements up to t_next
    win = torch.full((L, n + 1), inf, dtype=dt, device=dev).scatter_reduce_(
        1, rp_seg, torch.where(live, rp_end, inf), "amin"
    )[:, :n]
    newly = occupied & torch.isfinite(win) & (win <= tn)
    on_win = live & newly.gather(1, seg_of) & (rp_seg < n)
    win_r = win.gather(1, seg_of)
    # cancellation: every replica of a winning segment stops at the win
    kill_c = on_win & rp_cancel
    st["busy"] += torch.where(kill_c, win_r - rp_start, 0.0).sum(1)
    st["saved"] += torch.where(kill_c, rp_end - win_r, 0.0).sum(1)
    st["w_avail"].scatter_(1, torch.where(kill_c, rp_w, n), win_r)
    # non-cancel replicas retire individually at their own end
    retire = live & ~rp_cancel & (rp_end <= tn)
    st["busy"] += torch.where(retire, rp_end - rp_start, 0.0).sum(1)
    live &= ~(kill_c | retire)
    # non-cancel survivors of a winning segment detach: the batch is done but
    # the straggler keeps burning to its end
    g_s = st["g_s"]
    gone = ~live[:, :n] | (newly.gather(1, g_s.clamp(0, n - 1)) & (g_s < n))
    st["g_s"] = torch.where(gone, n, g_s)

    # -- job bookkeeping: wins decrement the owner's open count
    segj = st["seg_job"]
    i_new = torch.where(newly, segj.clamp(0, J - 1), J)
    st["job_left"].scatter_add_(1, i_new, torch.full_like(i_new, -1))
    st["job_fin"].scatter_reduce_(1, i_new, win, "amax")
    st["seg_job"] = torch.where(newly, J, segj)  # freed at the win
    resc_pending &= ~newly
    comp = st["dispatched"][:, :J] & (st["job_left"][:, :J] == 0) & ~st["recorded"][:, :J]
    job_fin = st["job_fin"][:, :J]
    st["fins"][:, :J] = torch.where(comp, job_fin, st["fins"][:, :J])
    st["recorded"][:, :J] |= comp
    st["n_done"] += comp.sum(1)
    w_job = st["w_job"][:, :n]
    wj = w_job.clamp(0, J - 1)
    rel = (w_job < J) & comp.gather(1, wj)
    w_avail.copy_(torch.where(rel, torch.maximum(w_avail, job_fin.gather(1, wj)), w_avail))
    w_job.masked_fill_(rel, J)

    # -- rescue: the earliest-serveable pending segment, oldest first on
    # ties, onto the job's own free workers or a free unallocated one
    pend = resc_pending
    resc_t = st["resc_t"]
    segjob = st["seg_job"].clamp(0, J - 1)
    # a segment's earliest eligible worker: the earliest free one, or the
    # earliest its own job holds (per job by a scatter-min; min is exact in
    # any order, and this is O(L n) where a segment-by-worker grid is O(L n^2))
    free_min = torch.where(alive & (w_job == J), w_avail, inf).amin(1, keepdim=True)
    own_min = torch.full((L, J + 1), inf, dtype=dt, device=dev).scatter_reduce_(
        1, w_job, torch.where(alive, w_avail, inf), "amin"
    )
    serve0 = torch.minimum(free_min, own_min.gather(1, segjob))
    serve_t = torch.where(pend, torch.maximum(resc_t, serve0), inf)
    serve_min = serve_t.amin(1)
    m1 = serve_t == serve_min[:, None]
    r_min = torch.where(m1, resc_t, inf).amin(1)
    s_star = torch.where(m1 & (resc_t == r_min[:, None]), widx, n).argmin(1)
    can_r = pend.any(1) & torch.isfinite(serve_min) & (serve_min <= t_next)
    j_star = segjob.gather(1, s_star[:, None])[:, 0]
    own = w_job == j_star[:, None]
    cand = alive & (w_avail <= serve_min[:, None]) & (own | (w_job == J))
    # space policies serve a rescue from the job's own free workers before
    # regranting an unallocated one; the gang regime has no allocations
    tier = torch.zeros_like(w_job) if cfg.scheduler == "fifo_gang" else torch.where(own, 0, 1)
    key2 = w_load if balanced else widx.to(dt).expand(L, n)
    mt = cand & (tier == torch.where(cand, tier, 2).amin(1, keepdim=True))
    mk = mt & (key2 == torch.where(mt, key2, inf).amin(1, keepdim=True))
    w_star = torch.where(mk, widx, n).argmin(1)
    rk = st["resc_k"].clamp(0, resc_cap - 1)
    jb = st["job_b"].gather(1, j_star[:, None])[:, 0].clamp(min=1)
    dur_r = inp["tau_resc"][row, rk, s_star] * bscale(jb) / speeds[w_star]
    i_w = torch.where(can_r, w_star, n)[:, None]
    i_s = torch.where(can_r, s_star, n)[:, None]
    i_slot = torch.where(can_r, n + s_star, 2 * n)[:, None]
    end_r = (serve_min + dur_r)[:, None]
    st["rb_w"].scatter_(1, i_s, w_star[:, None])
    st["rp_start"].scatter_(1, i_slot, serve_min[:, None])
    st["rp_end"].scatter_(1, i_slot, end_r)
    st["rp_live"].scatter_(1, i_slot, True)
    st["rp_cancel"].scatter_(1, i_slot, inp["cancel_tab"][j_star][:, None])
    st["resc_pending"].scatter_(1, i_s, False)
    st["w_job"].scatter_(1, i_w, j_star[:, None])
    st["w_avail"].scatter_(1, i_w, end_r)
    # speed-weighted load (duration / speed), the engine's _assign order
    st["w_load"].scatter_add_(1, i_w, (dur_r / speeds[w_star])[:, None])
    st["n_resc"] += can_r
    st["resc_k"] += can_r

    # -- dispatch: first fit over undispatched jobs by earliest feasible
    # time, ties by queue order
    n_alive = alive.sum(1)
    na1 = n_alive.clamp(min=1)[:, None]
    free_w2 = alive & (w_job == J)
    sa = torch.sort(torch.where(free_w2, w_avail, inf), 1).values
    dflt = inp["default_req"] if inp["default_req"] > 0 else n_alive[:, None]
    req = torch.where(inp["req_tab"] > 0, inp["req_tab"], dflt)
    req_eff = torch.minimum(req.clamp(min=1), na1)
    kth = sa.gather(1, (req_eff - 1).clamp(0, n - 1))
    segfree = st["seg_job"] == J
    seg_rank = torch.cumsum(segfree, 1) - 1
    n_segfree = segfree.sum(1)
    b0 = st["b0"][:, None]
    bq = torch.where(inp["b_tab"] > 0, inp["b_tab"], torch.where(b0 > 0, b0, req_eff))
    bq = torch.minimum(bq.clamp(min=1), req_eff)
    t_q = torch.maximum(inp["arrivals"], torch.maximum(kth, st["t_epoch"][:, None]))
    ok = (
        ~st["dispatched"][:, :J]
        & (torch.arange(J, device=dev) < inp["jobs_real"])
        & (n_alive > 0)[:, None]
        & (bq <= n_segfree[:, None])
    )
    t_q = torch.where(ok, t_q, inf)
    q_star = t_q.argmin(1)  # the first minimum: the lowest queue index
    qs = q_star[:, None]
    td = t_q.gather(1, qs)[:, 0]
    can_d = ~can_r & torch.isfinite(td) & (td < t_next)
    b_d = bq.gather(1, qs)[:, 0]
    req_d = req_eff.gather(1, qs)[:, 0]
    r_d = req_d // b_d
    elig_d = free_w2 & (w_avail <= td[:, None])
    keyd = torch.where(elig_d, w_load if balanced else widx.to(dt), inf)
    rank = torch.argsort(torch.argsort(keyd, dim=1, stable=True), dim=1, stable=True)
    sel_rep = can_d[:, None] & elig_d & (rank < (b_d * r_d)[:, None])
    sel_alloc = can_d[:, None] & elig_d & (rank < req_d[:, None])
    # the beta-th dispatched batch takes the beta-th free segment
    seg_by_beta = torch.full((L, n + 1), n, dtype=torch.int64, device=dev).scatter_(
        1, torch.where(segfree, seg_rank, n), widx.expand(L, n)
    )[:, :n]
    w_seg = seg_by_beta.gather(1, (rank % b_d.clamp(min=1)[:, None]).clamp(0, n - 1))
    # draw index = policy rank: the engine draws in placement order
    dur = inp["tau"][row, q_star].gather(1, rank.clamp(0, n - 1)) * bscale(b_d)[..., None] / speeds
    end = td[:, None] + dur
    st["g_s"] = torch.where(sel_rep, w_seg, st["g_s"])
    live[:, :n] |= sel_rep
    rp_start[:, :n] = torch.where(sel_rep, td[:, None], rp_start[:, :n])
    rp_end[:, :n] = torch.where(sel_rep, end, rp_end[:, :n])
    rp_cancel[:, :n] = torch.where(sel_rep, inp["cancel_tab"][q_star][:, None], rp_cancel[:, :n])
    w_job.copy_(torch.where(sel_alloc, qs, w_job))
    w_avail.copy_(torch.where(sel_rep, end, torch.where(sel_alloc, td[:, None], w_avail)))
    w_load.copy_(w_load + torch.where(sel_rep, dur / speeds, 0.0))
    st["seg_job"] = torch.where(
        can_d[:, None] & segfree & (seg_rank < b_d[:, None]), qs, st["seg_job"]
    )
    i_q = torch.where(can_d, q_star, J)[:, None]
    st["starts"].scatter_(1, i_q, td[:, None])
    st["dispatched"].scatter_(1, i_q, True)
    st["job_left"].scatter_(1, i_q, b_d[:, None])
    st["job_b"].scatter_(1, i_q, b_d[:, None])
    if cfg.full_outputs:
        st["br"].scatter_(1, i_q, (b_d << 16 | r_d)[:, None])

    # -- otherwise apply one fail/join event (sim-over gated)
    do_b = ~can_r & ~can_d
    sim_over = st["n_done"] >= inp["jobs_real"]
    t_ev = t_next
    w_raw = inp["ev_w"][row, e]
    up = inp["ev_up"][row, e]
    act = do_b & (w_raw >= 0) & torch.isfinite(t_ev) & ~sim_over
    w = w_raw.clamp(0, n - 1)
    was = alive.gather(1, w[:, None])[:, 0]
    do_fail = act & ~up & was
    do_join = act & up & ~was
    flip = do_fail | do_join
    i_flip = torch.where(flip, w, n)[:, None]
    st["alive"].scatter_(1, i_flip, up[:, None])
    kill = live & (rp_w == w[:, None]) & do_fail[:, None]
    st["busy"] += torch.where(kill, t_ev[:, None] - rp_start, 0.0).sum(1)
    live &= ~kill
    # a segment that just lost its last live replica needs a rescue: one
    # int64 segment count carries both indicators (kills in the low 32 bits,
    # survivors above them; the reference packs them at 4096 in int32)
    rp_seg3 = torch.cat([st["g_s"], widx.expand(L, n)], 1)
    seg_cnt = torch.zeros(L, n + 1, dtype=torch.int64, device=dev).scatter_add_(
        1, rp_seg3, kill.to(torch.int64) + (live.to(torch.int64) << 32)
    )[:, :n]
    lost = ((seg_cnt & 0xFFFFFFFF) > 0) & (seg_cnt < (1 << 32)) & (st["seg_job"] < J)
    resc_pending |= lost
    st["resc_t"] = torch.where(lost, t_ev[:, None], resc_t)
    st["g_s"] = torch.where(do_fail[:, None] & (widx == w[:, None]), n, st["g_s"])
    st["w_job"].scatter_(1, i_flip, J)
    st["w_avail"].scatter_(1, torch.where(do_fail, w, n)[:, None], inf)
    st["w_avail"].scatter_(1, torch.where(do_join, w, n)[:, None], t_ev[:, None])
    st["n_fail"] += do_fail
    st["t_epoch"] = torch.maximum(
        st["t_epoch"], torch.where(do_b & torch.isfinite(t_ev), t_ev.clamp(min=0.0), -inf)
    )
    if cfg.full_outputs:
        st["ep_times"].scatter_(1, torch.where(flip, e, ev_pad)[:, None], t_ev[:, None])
    st["e"] = (e + do_b).clamp(max=ev_pad - 1)


def _lane_outputs(cfg: _RunnerCfg, st: dict) -> dict:
    ns = cfg.n_slots
    # flush replicas still in flight: their full duration is committed worker
    # time, which keeps ws(cancel on) + saved == ws(cancel off)
    flush = torch.where(
        st["rp_live"][:, :ns], st["rp_end"][:, :ns] - st["rp_start"][:, :ns], 0.0
    ).sum(1)
    out = {
        "starts": st["starts"][:, : cfg.jobs_pad],
        "finishes": st["fins"][:, : cfg.jobs_pad],
        "worker_seconds": st["busy"] + flush,
        "cancelled_seconds_saved": st["saved"],
        "n_worker_failures": st["n_fail"],
        "n_replicas_rescued": st["n_resc"],
        "n_replans": st["n_replans"],
    }
    if cfg.spec is not None:
        out["n_speculative"] = st["n_spec"]
    if cfg.full_outputs:
        out["br"] = st["br"][:, : cfg.jobs_pad]
        out["epoch_times"] = st["ep_times"][:, : cfg.ev_pad]
    return out


def _run_lane_batch(cfg: _RunnerCfg, inp: dict, b0: torch.Tensor, n_real: int) -> dict:
    """Run every lane to its ``done`` chunk boundary (or the step budget).

    A lane whose ``done`` holds at a chunk boundary leaves the working batch
    with its state as it stands; the rest run on.  Lanes are independent,
    so which lanes share a batch never changes a lane's result.
    """
    global steps_run
    dt = inp["tau"].dtype
    space = cfg.scheduler is not None
    st = (_init_space_state if space else _init_state)(cfg, b0, n_real, dt, b0.device)
    step = _space_step if space else _step
    L = b0.shape[0]
    if L == 0:
        return _lane_outputs(cfg, st)
    results: dict = {}
    for chunk in range(cfg.n_chunks):
        for _ in range(_STEP_CHUNK):
            step(cfg, st, inp)
        steps_run += _STEP_CHUNK
        last = chunk == cfg.n_chunks - 1
        if space:
            done = st["n_done"] >= inp["jobs_real"]
        else:
            done = (st["q"] >= inp["jobs_real"]) & ~st["job_active"]
        leave = torch.ones_like(done) if last else done
        n_leave = int(leave.sum())
        if n_leave == 0:
            continue
        keep = (~leave).nonzero()[:, 0]
        gone = leave.nonzero()[:, 0]
        for k, v in _lane_outputs(cfg, {key: t[gone] for key, t in st.items()}).items():
            if k not in results:
                results[k] = torch.empty((L,) + v.shape[1:], dtype=v.dtype, device=v.device)
            results[k][st["row"][gone]] = v
        if n_leave == st["row"].shape[0]:
            break
        st = {key: t[keep] for key, t in st.items()}
    return results


def _stream_fold(out: dict, inp: dict) -> dict:
    """Fold the lanes' per-job starts and finishes into streaming
    accumulators on the device, in arrival order (``outputs="stream"``).

    Jobs past the real count and jobs never finished (dead cluster) are left
    out of the statistics; the latter are counted in ``n_unfinished``.  The
    count, extremes, histogram and ``fin_max`` do not depend on order and
    reduce in one pass; the three sums add job by job, left to right, as the
    reference's scan and the host fold
    (:func:`~repro_torch.cluster.stream.epoch_stream_stats`) do, so float64
    lanes equal the host fold bit for bit on either device.
    """
    from .vectorized import STREAM_HIST_BINS, STREAM_HIST_EDGES

    starts, fins = out.pop("starts"), out.pop("finishes")
    L, jobs_pad = fins.shape
    dt, dev = fins.dtype, fins.device
    jobs_real = inp["jobs_real"]
    real = torch.arange(jobs_pad, device=dev) < jobs_real
    done = torch.isfinite(fins)
    m = real & done
    resp = fins - inp["arrivals"]
    inf = float("inf")
    out["count"] = m.sum(1, dtype=torch.int32)
    out["resp_min"] = torch.where(m, resp, inf).amin(1)
    out["resp_max"] = torch.where(m, resp, -inf).amax(1)
    out["fin_max"] = torch.where(m, fins, -inf).amax(1)
    out["n_unfinished"] = (real & ~done).sum(1, dtype=torch.int32)
    edges = torch.tensor(STREAM_HIST_EDGES, dtype=dt, device=dev)
    bins = torch.searchsorted(edges, torch.where(m, resp, 0.0), right=True)
    out["hist"] = torch.zeros(L, STREAM_HIST_BINS, dtype=torch.int32, device=dev).scatter_add_(
        1, bins, m.to(torch.int32)
    )
    # max(sq, 0) pins the square as a standalone IEEE multiply, as the
    # reference's fold does
    terms = torch.stack([resp, (resp * resp).clamp(min=0.0), fins - starts], 1)
    terms = torch.where(m[:, None], terms, 0.0)
    acc = torch.zeros(L, 3, dtype=dt, device=dev)
    for j in range(jobs_real):
        acc += terms[:, :, j]
    out["resp_sum"], out["resp_sq"], out["comp_sum"] = acc.unbind(1)
    return out


# --------------------------------------------------------------------------
# per-lane draw preparation (chunk-invariant seed derivation), host numpy
# --------------------------------------------------------------------------


def _sample_churn_np(rng, churn: ChurnProcess, n_workers: int, pairs: int):
    """One lane's alternating-renewal fail/join timeline, the engine's law.

    Also returns the lane's *horizon*: the earliest time any worker's
    sampled stream runs dry (its last of ``2 * pairs`` events).  Past it the
    lane's workers stay up while the engine keeps churning; callers compare
    finish times against it and warn.  With ``mean_downtime == 0`` failures
    are permanent, every stream ends at +inf and the horizon is never
    reached.
    """
    ups = rng.exponential(1.0 / churn.fail_rate, (n_workers, pairs))
    if churn.mean_downtime > 0.0:
        downs = rng.exponential(churn.mean_downtime, (n_workers, pairs))
    else:
        downs = np.full((n_workers, pairs), np.inf)
    iv = np.stack([ups, downs], axis=-1).reshape(n_workers, 2 * pairs)
    t = np.cumsum(iv, axis=-1)  # fail at even positions, join at odd
    horizon = float(np.min(t[:, -1]))
    u = np.broadcast_to((np.arange(2 * pairs) % 2).astype(bool), t.shape).ravel()
    w = np.broadcast_to(np.arange(n_workers, dtype=np.int32)[:, None], t.shape).ravel()
    t = t.ravel()
    order = np.argsort(t, kind="stable")
    t, w, u = t[order], w[order], u[order]
    return t, np.where(np.isfinite(t), w, -1), u, horizon


def _pack_schedule(schedule: Optional[ChurnSchedule], n_lanes: int, ev_pad: int, dtype):
    """Shared explicit timeline (or the no-churn stream), inf-padded."""
    t = np.full(ev_pad, np.inf, np.float64)
    w = np.full(ev_pad, -1, np.int32)
    u = np.zeros(ev_pad, bool)
    if schedule is not None and len(schedule):
        t[: len(schedule)] = np.asarray(schedule.times, np.float64)
        w[: len(schedule)] = np.asarray(schedule.wids, np.int32)
        u[: len(schedule)] = np.asarray(schedule.ups, bool)
    tile = lambda a: np.broadcast_to(a, (n_lanes,) + a.shape)  # noqa: E731
    return tile(t.astype(dtype)), tile(w), tile(u)


def _prepare_lanes(dist, n_workers, n_pad, lane_idx, n_real, jobs_pad, ev_pad, resc_cap,
                   seed, churn, churn_schedule, pairs, dtype, spec_cap=0):
    """Per-lane inputs of both entry points, as numpy arrays: service draws,
    rescue draws, backup draws, the churn event stream and each lane's churn
    horizon.

    Lane ``i`` draws from ``default_rng(SeedSequence((seed, i)))``, a pure
    function of the global lane index, in the order tau, rescue, backup,
    churn.  Only the first ``n_real`` lanes carry results; lanes past them
    get constant durations.  Rescue draws are sampled only when churn events
    can create rescues, and backup draws (``spec_cap`` per lane) only with
    speculation on -- tau is drawn first per lane, so skipping them changes
    nothing.
    """
    n_lanes = len(lane_idx)
    seed = int(seed)
    sample_churn = churn is not None and churn.fail_rate > 0.0 and pairs > 0
    need_resc = sample_churn or (churn_schedule is not None and len(churn_schedule))
    tau = np.ones((n_lanes, jobs_pad, n_pad), dtype)
    tau_resc = np.ones((n_lanes, resc_cap, n_pad), dtype)
    tau_spec = np.ones((n_lanes, max(spec_cap, 1), n_pad), dtype)
    horizon = np.full(n_lanes, np.inf)
    if sample_churn:
        ev_t = np.full((n_lanes, ev_pad), np.inf, dtype)
        ev_w = np.full((n_lanes, ev_pad), -1, np.int32)
        ev_up = np.zeros((n_lanes, ev_pad), bool)
    for i, lane in enumerate(lane_idx[:n_real]):
        rng = np.random.default_rng(np.random.SeedSequence((seed, int(lane))))
        tau[i] = dist.sample_np(rng, (jobs_pad, n_pad))
        if need_resc:
            tau_resc[i] = dist.sample_np(rng, (resc_cap, n_pad))
        if spec_cap:
            tau_spec[i] = dist.sample_np(rng, (spec_cap, n_pad))
        if sample_churn:
            t, w, u, horizon[i] = _sample_churn_np(rng, churn, n_workers, pairs)
            k = min(len(t), ev_pad)
            ev_t[i, :k], ev_w[i, :k], ev_up[i, :k] = t[:k], w[:k], u[:k]
    if not sample_churn:
        ev_t, ev_w, ev_up = _pack_schedule(churn_schedule, n_lanes, ev_pad, dtype)
    return tau, tau_resc, tau_spec, ev_t, ev_w, ev_up, horizon


def _shapes(n_workers, n_jobs, churn, churn_schedule, pairs, speculation=None):
    """Padded worker, job, event and rescue counts, and the chunk budget."""
    n_pad = _bucket_workers(n_workers)
    jobs_pad = _pow2(n_jobs) if n_jobs < 32 else -(-n_jobs // 32) * 32
    if churn is not None and churn.fail_rate > 0.0 and pairs > 0:
        ev_real = 2 * pairs * n_workers
    elif churn_schedule is not None:
        ev_real = len(churn_schedule)
    else:
        ev_real = 0
    ev_pad = _pow2(ev_real + 1)
    # rescue dispatches are bounded by worker failures, at most half the
    # event stream under the alternating fail/join law
    resc_cap = max(8, ev_pad // 2)
    # one step per job dispatch + one per churn event + a rescue allowance,
    # plus one trailing commit; overruns leave jobs at inf exactly like the
    # engine's max_events cap
    if speculation is not None:
        # event-granular commits take one step per completion-time group (at
        # most one per batch plus straggler and rescue retirements), plus one
        # per backup launch and its (rare) 1-ulp re-arm
        mb = speculation.max_backups
        budget = jobs_pad * (n_pad + 1 + 2 * mb) + ev_pad + 2 * resc_cap + 2
    else:
        budget = jobs_pad + ev_pad + resc_cap + 2
    n_chunks = -(-budget // _STEP_CHUNK)
    return n_pad, jobs_pad, ev_pad, resc_cap, n_chunks


def _replan_inputs(cfg: _RunnerCfg, n_workers: int, device) -> dict:
    """The replanner's tables: the divisors of each alive count and the
    harmonic numbers, padded to the bucketed worker count as the reference
    pads them, and the blend weight."""
    dt = resolve_dtype(cfg.dtype)
    div_tab, (h1, h2) = divisor_table(n_workers), harmonic_tables(n_workers)
    div_pad = np.zeros((cfg.n + 1, _pow2(div_tab.shape[1])), np.int64)
    div_pad[: div_tab.shape[0], : div_tab.shape[1]] = div_tab
    hp1, hp2 = np.zeros(cfg.n + 1), np.zeros(cfg.n + 1)
    hp1[: len(h1)], hp2[: len(h2)] = h1, h2
    return {
        "div_tab": torch.tensor(div_pad, device=device),
        "h1": torch.tensor(hp1, dtype=dt, device=device),
        "h2": torch.tensor(hp2, dtype=dt, device=device),
        "blend": torch.tensor(cfg.replan.blend, dtype=dt, device=device),
    }


def _space_tabs(scheduler, workers_per_job, job_plans, n_jobs, jobs_pad, n_workers,
                cancel_default):
    """Route a scenario to the space lane and build its per-job plan tables.

    Returns ``(scheduler_name_or_None, tabs)``: ``None`` means the gang lane
    (``fifo_gang`` with no per-job plans); otherwise the space lane runs with
    ``tabs = (req_tab, b_tab, cancel_tab, default_req)``, zero meaning
    "inherit the engine-wide default" like a
    :class:`~repro_torch.cluster.scheduler.JobPlan`'s None field.
    ``job_plans`` cycles over the jobs; ``fifo_gang`` ignores worker
    requests, as the engine does.
    """
    if scheduler is None:
        scheduler = "fifo_gang"
    if not is_space(scheduler, workers_per_job, job_plans):
        return None, None
    req_tab = np.zeros(jobs_pad, np.int64)
    b_tab = np.zeros(jobs_pad, np.int64)
    cancel_tab = np.full(jobs_pad, bool(cancel_default))
    if job_plans is not None:
        plans = list(job_plans)
        for q in range(n_jobs):
            p = plans[q % len(plans)]
            if p is None:
                continue
            if p.workers is not None:
                req_tab[q] = min(int(p.workers), n_workers)
            if p.n_batches is not None:
                b_tab[q] = int(p.n_batches)
            if p.cancel_redundant is not None:
                cancel_tab[q] = bool(p.cancel_redundant)
    if scheduler == "fifo_gang":
        req_tab[:] = 0
        default_req = 0
    else:
        default_req = int(workers_per_job) if workers_per_job is not None else 0
    return scheduler, (req_tab, b_tab, cancel_tab, default_req)


def _run_lanes(dist, cfg, n_workers, lane_idx, b0, arrivals_pad, n_jobs_real, seed,
               speeds, churn, churn_schedule, pairs, n_tasks, device, space_tabs=None):
    """Draw the lanes on the host, copy them to ``device`` once, run them.

    ``space_tabs`` carries the space lane's per-job plan tables
    (:func:`_space_tabs`); the gang lane takes the replanner's tables
    instead, when it replans."""
    np_dtype = np.dtype(cfg.dtype)
    dt = resolve_dtype(cfg.dtype)
    spec_cap = cfg.jobs_pad * cfg.spec.max_backups if cfg.spec is not None else 0
    tau, tau_resc, tau_spec, ev_t, ev_w, ev_up, horizon = _prepare_lanes(
        dist, n_workers, cfg.n, lane_idx, len(lane_idx), cfg.jobs_pad, cfg.ev_pad,
        cfg.resc_cap, seed, churn, churn_schedule, pairs, np_dtype, spec_cap=spec_cap,
    )

    def put(a, dtype=None):
        return torch.tensor(a, dtype=dtype, device=device)

    inp = {
        "tau": put(tau),
        "tau_resc": put(tau_resc),
        "ev_t": put(ev_t),
        "ev_w": put(ev_w, torch.int64),
        "ev_up": put(ev_up),
        "arrivals": put(np.asarray(arrivals_pad, np_dtype)),
        "speeds": put(np.asarray(speeds, np_dtype)),
        "n_tasks": torch.tensor(float(n_tasks), dtype=dt, device=device),
        "one": torch.ones((), dtype=dt, device=device),
        "jobs_real": int(n_jobs_real),
        "bidx": torch.arange(cfg.n, device=device),
    }
    if cfg.spec is not None:
        inp["tau_spec"] = put(tau_spec)
        inp["interval"] = torch.tensor(cfg.spec.interval, dtype=dt, device=device)
    if cfg.replan is not None:
        inp.update(_replan_inputs(cfg, n_workers, device))
    if cfg.scheduler is not None:
        req_tab, b_tab, cancel_tab, default_req = space_tabs
        inp.update(req_tab=put(req_tab, torch.int64), b_tab=put(b_tab, torch.int64),
                   cancel_tab=put(cancel_tab, torch.bool), default_req=int(default_req))
    out = _run_lane_batch(cfg, inp, put(b0, torch.int64), int(n_workers))
    if cfg.stream:
        out = _stream_fold(out, inp)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["churn_horizon"] = horizon  # host-side, inf unless churn sampled
    return res


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


# float32 resolves consecutive integers only up to 2^24; past half that, a
# single ulp of an absolute timestamp already approaches one second
_F32_SAFE_TIME = float(2**23)


def _check_arrival_span(arrivals, dtype):
    """Refuse float32 lanes whose absolute arrivals exceed the float32-safe
    range: the lanes carry absolute event times in the lane dtype, and ulps
    this large silently quantize queue waits and service times."""
    if dtype != "float32":
        return  # float64 is safe; invalid dtypes get the validation error
    finite = arrivals[np.isfinite(arrivals)]
    span = float(np.abs(finite).max()) if finite.size else 0.0
    if span > _F32_SAFE_TIME:
        raise ValueError(
            f"arrival magnitude {span:.6g} s exceeds the float32-safe range "
            f"(~{_F32_SAFE_TIME:.3g} s): the scan lanes carry absolute times "
            "in the lane dtype, and float32 ulps this large silently quantize "
            'queue waits and service times.  Pass dtype="float64" or rebase '
            "arrivals near zero."
        )


def _reject_unported(sc: Scenario, where: str) -> None:
    """Refuse ``devices > 1`` by name: the port runs every lane on one device."""
    if sc.devices != 1:
        raise NotImplementedError(
            f"{where}: devices={sc.devices}: the port runs every lane on one "
            "device (ROADMAP.md §1, item 1.8)"
        )


def _validate_common(n_workers, sc):
    """Scenario validation, returning the bucket-padded speed vector."""
    sc.validate(n_workers=n_workers, backend="torch")
    speeds = np.ones(n_workers) if sc.speeds is None else np.asarray(sc.speeds, np.float64)
    pad = _bucket_workers(n_workers) - n_workers
    return np.concatenate([speeds, np.ones(pad)])


def _resolve_churn_pairs(pairs, dist, churn, n_workers, n_batches, n_tasks,
                         size_dependent, speeds, arrivals, n_jobs):
    """Resolve ``churn_pairs_per_worker`` (None = auto-size from the stream).

    The lanes sample a finite stream of fail/join pairs per worker, after
    which that worker stays up.  Auto-sizing estimates the timeline (arrival
    span plus jobs x mean batch duration at the slowest speed) and draws
    enough pairs to cover twice that, floored at 8 and capped at 1024; the
    post-run truncation check warns if even the cap fell short.  An explicit
    integer is honoured as given (it fixes the lanes' draw shapes).
    """
    if pairs is not None:
        return int(pairs)
    if churn is None or churn.fail_rate <= 0.0:
        return 8  # no sampled churn: the horizon is never consulted
    # mean service estimate from a fixed-seed host draw: it only sizes an
    # integer, so it must not perturb (or depend on) the caller's seed
    rng = np.random.default_rng(np.random.SeedSequence((0x5A11, 0)))
    mean_tau = float(np.mean(dist.sample_np(rng, (256,))))
    b = int(n_batches) if n_batches else n_workers
    scale = (float(n_tasks) / b) if size_dependent else 1.0
    slow = float(np.min(speeds)) if len(speeds) else 1.0
    span = float(arrivals[-1] - arrivals[0]) if arrivals is not None and len(arrivals) else 0.0
    t_est = span + n_jobs * mean_tau * scale / max(slow, 1e-12)
    period = 1.0 / churn.fail_rate + churn.mean_downtime
    pairs = math.ceil(2.0 * t_est / max(period, 1e-12)) + 4
    return max(8, min(int(pairs), 1024))


def _warn_churn_truncated(truncated, pairs):
    n_hit, n_reps = int(np.sum(truncated)), len(truncated)
    warnings.warn(
        f"sampled churn horizon ended before the simulated timeline in "
        f"{n_hit}/{n_reps} rep(s): past the horizon the lanes' workers stay "
        "up while the Python engine keeps churning, so results diverge from "
        f"the engine's law.  Raise churn_pairs_per_worker (resolved to "
        f"{pairs}; None auto-sizes from the stream) or pass an explicit "
        "churn_schedule, which both backends replay identically.",
        RuntimeWarning,
        stacklevel=3,
    )


def _rep_slices(total: int, rep_chunk: Optional[int]):
    if rep_chunk is None or rep_chunk >= total:
        return [(0, total)]
    if rep_chunk < 1:
        raise ValueError("rep_chunk must be >= 1")
    return [(lo, min(lo + rep_chunk, total)) for lo in range(0, total, rep_chunk)]


def simulate_epochs(
    dist: Optional[ServiceTime] = None,
    n_workers: Optional[int] = None,
    n_batches: Optional[int] = None,
    arrivals=None,
    n_reps: Optional[int] = None,
    *,
    seed: int = 0,
    cancel_redundant=UNSET,
    size_dependent=UNSET,
    n_tasks=UNSET,
    speeds=UNSET,
    churn=UNSET,
    churn_schedule=UNSET,
    churn_pairs_per_worker=UNSET,
    replan=UNSET,
    speculation=UNSET,
    scheduler=UNSET,
    workers_per_job=UNSET,
    job_plans=UNSET,
    dtype=UNSET,
    rep_chunk=UNSET,
    devices=UNSET,
    outputs=UNSET,
    scenario: Optional[Scenario] = None,
    device=None,
) -> EpochReport | EpochStreamReport:
    """Replay the engine's semantics on the epoch scan, on ``device``.

    Same signature and result as the reference's ``simulate_epochs``, plus
    ``device`` (default: the CUDA card; ``"cpu"`` runs the same lanes on the
    host).  ``n_batches=None`` means full parallelism (B = alive workers at
    dispatch), like the engine.  Each rep derives every draw from
    ``default_rng(SeedSequence((seed, rep)))``, so ``rep_chunk`` is
    bit-identical to one call.  ``churn_pairs_per_worker=None`` auto-sizes
    the sampled-churn horizon; a rep whose timeline still outruns it raises a
    ``RuntimeWarning`` and is flagged in ``EpochReport.churn_truncated``.

    ``replan=ReplanConfig(...)`` runs the windowed online replanner in the
    lanes: completed task times feed a ring of ``window`` observations, and
    every ``refit_every`` of them (past ``min_observations``) a job
    completion refits the law and re-picks B for the next dispatch.
    ``speculation=Speculation(...)`` launches reactive backup replicas: a
    batch whose youngest live replica lags past ``theta x`` the running
    median of its completed siblings earns one backup at the next heartbeat
    epoch (at most ``max_backups`` per job, one live backup per batch).  The
    two policies are mutually exclusive.  ``outputs="stream"`` folds the
    per-job records on the device and returns an :class:`EpochStreamReport`
    (O(n_reps) memory); on float64 lanes its stats equal
    ``epoch_stream_stats`` of the ``outputs="full"`` report bit for bit.

    ``scheduler`` / ``workers_per_job`` / ``job_plans`` run the space lane:
    under ``"packed"`` or ``"balanced"`` jobs run concurrently on disjoint
    worker subsets, each under its own
    :class:`~repro_torch.cluster.scheduler.JobPlan` (``job_plans`` cycles
    over the arrivals; unset fields inherit ``n_batches`` /
    ``cancel_redundant`` / ``workers_per_job``); ``fifo_gang`` with per-job
    plans runs the space lane in gang mode.  Neither adaptive policy runs
    with space knobs (``Scenario.validate`` refuses them, as the reference's).

    The scenario knobs are best passed as one ``scenario=Scenario(...)``;
    the loose keyword forms keep working behind a ``DeprecationWarning``.
    ``devices > 1`` raises :class:`NotImplementedError`.
    """
    sc = resolve_scenario(
        scenario,
        {
            "cancel_redundant": cancel_redundant,
            "size_dependent": size_dependent,
            "n_tasks": n_tasks,
            "speeds": speeds,
            "churn": churn,
            "churn_schedule": churn_schedule,
            "churn_pairs_per_worker": churn_pairs_per_worker,
            "replan": replan,
            "speculation": speculation,
            "scheduler": scheduler,
            "workers_per_job": workers_per_job,
            "job_plans": job_plans,
            "dtype": dtype,
            "rep_chunk": rep_chunk,
            "devices": devices,
            "outputs": outputs,
        },
        where="simulate_epochs",
    )
    _reject_unported(sc, "simulate_epochs")
    dist = dist if dist is not None else sc.dist
    n_workers = int(n_workers if n_workers is not None else sc.n_workers)
    n_batches = n_batches if n_batches is not None else sc.n_batches
    if dist is None or arrivals is None or n_reps is None:
        raise ValueError("simulate_epochs needs dist (or scenario.dist), arrivals, and n_reps")
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.ndim != 1 or arrivals.size == 0:
        raise ValueError("arrivals must be a non-empty 1-D array")
    if (np.diff(arrivals) < 0).any():
        raise ValueError("arrivals must be sorted (FIFO order)")
    _check_arrival_span(arrivals, sc.dtype)
    if n_batches is not None and not (1 <= int(n_batches) <= n_workers):
        raise ValueError(f"n_batches must lie in [1, {n_workers}] or be None")
    speeds = _validate_common(n_workers, sc)
    dev = resolve_device(device)
    churn, churn_schedule = sc.churn, sc.churn_schedule
    n_tasks = sc.n_tasks if sc.n_tasks is not None else n_workers
    n_jobs = arrivals.size
    pairs = _resolve_churn_pairs(
        sc.churn_pairs_per_worker, dist, churn, n_workers, n_batches, n_tasks,
        sc.size_dependent, speeds, arrivals, n_jobs,
    )
    n_pad, jobs_pad, ev_pad, resc_cap, n_chunks = _shapes(
        n_workers, n_jobs, churn, churn_schedule, pairs, speculation=sc.speculation
    )
    sched, tabs = _space_tabs(sc.scheduler_name, sc.workers_per_job, sc.job_plans, n_jobs,
                              jobs_pad, n_workers, sc.cancel_redundant)
    stream_mode = sc.outputs == "stream"
    cfg = _RunnerCfg(
        n_pad, jobs_pad, ev_pad, resc_cap, n_chunks,
        bool(sc.cancel_redundant), bool(sc.size_dependent), sc.dtype,
        full_outputs=not stream_mode, replan=sc.replan, spec=sc.speculation,
        stream=stream_mode, scheduler=sched,
    )
    arrivals_pad = np.concatenate([arrivals, np.full(jobs_pad - n_jobs, np.inf)])
    b0_val = 0 if n_batches is None else int(n_batches)
    chunks = [
        _run_lanes(
            dist, cfg, n_workers, np.arange(lo, hi), np.full(hi - lo, b0_val, np.int32),
            arrivals_pad, n_jobs, seed, speeds, churn, churn_schedule, pairs, n_tasks, dev,
            space_tabs=tabs,
        )
        for lo, hi in _rep_slices(int(n_reps), sc.rep_chunk)
    ]
    out = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
    sampled = churn is not None and churn.fail_rate > 0.0
    counters = dict(
        worker_seconds=out["worker_seconds"].astype(np.float64),
        cancelled_seconds_saved=out["cancelled_seconds_saved"].astype(np.float64),
        n_worker_failures=out["n_worker_failures"].astype(np.int32),
        n_replicas_rescued=out["n_replicas_rescued"].astype(np.int32),
        n_replans=out["n_replans"].astype(np.int32),
        n_speculative=(
            out["n_speculative"].astype(np.int32) if "n_speculative" in out else None
        ),
    )
    if stream_mode:
        from .stream import StreamStats

        n_unfinished = out["n_unfinished"]
        truncated = None
        if sampled:
            # unfinished jobs have no finish stamp: count them as outrunning
            # the horizon, exactly like the full path's inf finishes do
            truncated = (out["fin_max"].astype(np.float64) > out["churn_horizon"]) | (
                n_unfinished > 0
            )
            if truncated.any():
                _warn_churn_truncated(truncated, pairs)
        stats = StreamStats(
            count=out["count"],
            resp_sum=out["resp_sum"],
            resp_sq=out["resp_sq"],
            resp_min=out["resp_min"],
            resp_max=out["resp_max"],
            comp_sum=out["comp_sum"],
            busy_sum=out["worker_seconds"],
            saved_sum=out["cancelled_seconds_saved"],
            hist=out["hist"],
        )
        return EpochStreamReport(arrivals=arrivals, stats=stats, n_unfinished=n_unfinished,
                                 churn_truncated=truncated, **counters)
    br = out["br"][:, :n_jobs].astype(np.int32)
    finishes = out["finishes"].astype(np.float64)[:, :n_jobs]
    truncated = None
    if sampled:
        # a rep whose timeline outran its sampled horizon ran its tail
        # churn-free (unfinished jobs at inf count as outrunning it)
        truncated = finishes.max(axis=1) > out["churn_horizon"]
        if truncated.any():
            _warn_churn_truncated(truncated, pairs)
    return EpochReport(
        arrivals=arrivals,
        starts=out["starts"].astype(np.float64)[:, :n_jobs],
        finishes=finishes,
        n_batches_used=br >> 16,
        replication_used=br & 0xFFFF,
        epoch_times=out["epoch_times"].astype(np.float64),
        churn_truncated=truncated,
        **counters,
    )


def frontier_job_times_dynamic(
    dist: Optional[ServiceTime] = None,
    n_workers: Optional[int] = None,
    candidates=None,
    n_reps: Optional[int] = None,
    *,
    seed: int = 0,
    n_jobs: Optional[int] = None,
    cancel_redundant=UNSET,
    size_dependent=UNSET,
    n_tasks=UNSET,
    speeds=UNSET,
    churn=UNSET,
    churn_schedule=UNSET,
    churn_pairs_per_worker=UNSET,
    replan=UNSET,
    speculation=UNSET,
    scheduler=UNSET,
    workers_per_job=UNSET,
    job_plans=UNSET,
    dtype=UNSET,
    rep_chunk=UNSET,
    devices=UNSET,
    scenario: Optional[Scenario] = None,
    device=None,
) -> np.ndarray:
    """Per-candidate job compute times under churn, speeds and adaptive policies.

    The dynamic sibling of :func:`repro_torch.cluster.vectorized.
    frontier_job_times` and the path behind ``plan_cluster`` on dynamic
    scenarios: every candidate B runs serial job streams of ``n_jobs`` jobs
    (under churn, consecutive jobs share a timeline) across
    ``ceil(n_reps / n_jobs)`` independent streams, all of them lanes of one
    batch on ``device`` (default: the CUDA card).  Returns
    ``(len(candidates), >= n_reps)`` compute times; unfinished jobs are inf.

    Lane (candidate ci, stream s) draws from ``SeedSequence((seed, ci * S +
    s))``, so ``rep_chunk`` (at most that many streams per candidate in one
    batch) is bit-identical to one call.  ``Scenario.outputs`` is accepted
    and ignored, as in the reference.  ``replan`` and ``speculation`` run
    in every lane, each candidate B being the lane's starting plan.  Space
    knobs score the candidates on the space lane, the candidate B filling the
    plan of every job whose :class:`~repro_torch.cluster.scheduler.JobPlan`
    leaves ``n_batches`` unset.
    ``devices > 1`` raises :class:`NotImplementedError`.
    """
    sc = resolve_scenario(
        scenario,
        {
            "cancel_redundant": cancel_redundant,
            "size_dependent": size_dependent,
            "n_tasks": n_tasks,
            "speeds": speeds,
            "churn": churn,
            "churn_schedule": churn_schedule,
            "churn_pairs_per_worker": churn_pairs_per_worker,
            "replan": replan,
            "speculation": speculation,
            "scheduler": scheduler,
            "workers_per_job": workers_per_job,
            "job_plans": job_plans,
            "dtype": dtype,
            "rep_chunk": rep_chunk,
            "devices": devices,
        },
        where="frontier_job_times_dynamic",
    )
    _reject_unported(sc, "frontier_job_times_dynamic")
    dist = dist if dist is not None else sc.dist
    n_workers = int(n_workers if n_workers is not None else sc.n_workers)
    if dist is None or candidates is None or n_reps is None:
        raise ValueError(
            "frontier_job_times_dynamic needs dist (or scenario.dist), candidates, and n_reps"
        )
    bs = np.asarray(list(candidates), dtype=np.int32)
    if bs.size == 0:
        raise ValueError("need at least one candidate B")
    if (bs < 1).any() or (bs > n_workers).any():
        raise ValueError(f"candidates must lie in [1, {n_workers}], got {bs.tolist()}")
    speeds = _validate_common(n_workers, sc)
    dev = resolve_device(device)
    churn, churn_schedule = sc.churn, sc.churn_schedule
    n_tasks = sc.n_tasks if sc.n_tasks is not None else n_workers
    n_jobs = sc.jobs_per_stream if n_jobs is None else n_jobs
    n_jobs = max(1, min(int(n_jobs), int(n_reps)))
    s = math.ceil(n_reps / n_jobs)
    c = len(bs)
    # auto-size against the widest-scale candidate (smallest B): its jobs
    # run longest, so its streams are the ones that outlive short horizons
    pairs = _resolve_churn_pairs(
        sc.churn_pairs_per_worker, dist, churn, n_workers, int(bs.min()), n_tasks,
        sc.size_dependent, speeds, None, n_jobs,
    )
    n_pad, jobs_pad, ev_pad, resc_cap, n_chunks = _shapes(
        n_workers, n_jobs, churn, churn_schedule, pairs, speculation=sc.speculation
    )
    sched, tabs = _space_tabs(sc.scheduler_name, sc.workers_per_job, sc.job_plans, n_jobs,
                              jobs_pad, n_workers, sc.cancel_redundant)
    cfg = _RunnerCfg(
        n_pad, jobs_pad, ev_pad, resc_cap, n_chunks,
        bool(sc.cancel_redundant), bool(sc.size_dependent), sc.dtype,
        full_outputs=False,  # planning reads starts/finishes only
        replan=sc.replan, spec=sc.speculation, scheduler=sched,
    )
    arrivals_pad = np.concatenate([np.zeros(n_jobs), np.full(jobs_pad - n_jobs, np.inf)])
    chunks = []
    trunc = np.zeros(0, bool)
    for lo, hi in _rep_slices(s, sc.rep_chunk):
        # lane (ci, rep) has global index ci * s + rep: chunking over reps
        # keeps every lane's SeedSequence identity, hence its draws, unchanged
        lane_idx = (np.arange(c)[:, None] * s + np.arange(lo, hi)[None, :]).ravel()
        b0 = np.repeat(bs, hi - lo)
        out = _run_lanes(
            dist, cfg, n_workers, lane_idx, b0, arrivals_pad, n_jobs, seed,
            speeds, churn, churn_schedule, pairs, n_tasks, dev, space_tabs=tabs,
        )
        fin = out["finishes"].astype(np.float64)
        start = out["starts"].astype(np.float64)
        if churn is not None and churn.fail_rate > 0.0:
            trunc = np.append(trunc, fin[:, :n_jobs].max(axis=1) > out["churn_horizon"])
        # unfinished jobs (inf start and finish) score inf, not inf - inf
        with np.errstate(invalid="ignore"):
            t = np.where(np.isfinite(fin), fin - start, np.inf)
        chunks.append(t[:, :n_jobs].reshape(c, (hi - lo) * n_jobs))
    if trunc.any():
        _warn_churn_truncated(trunc, pairs)
    return np.concatenate(chunks, axis=1)
