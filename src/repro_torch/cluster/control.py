"""Online control: replanning and reactive (speculative) replication.

A numpy copy of ``repro.cluster.control`` for the port.  The replanner
takes every genuinely observed per-task service time, periodically refits a
distribution family by maximum likelihood (``fit_service_time``) and
re-picks the operating point (B, r) with the paper's closed forms;
dispatches after a refit use the new plan.

The epoch scan's in-scan replanner
(:class:`repro_torch.cluster.epoch_scan.ReplanConfig`) holds the same knobs,
and ``ReplanConfig.to_controller`` builds the equivalent instance of this
class: it is the function-level oracle of the scan's refit.  The event
engine (:class:`repro_torch.cluster.master.ClusterEngine`) feeds it live
observations, as the reference's engine feeds the reference's.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np

from ..core.planner import RedundancyPlan, RedundancyPlanner, fit_service_time
from ..core.service_time import Exponential, Pareto, ServiceTime, ShiftedExponential

__all__ = ["OnlineReplanner", "SpeculativePolicy"]


class SpeculativePolicy:
    """The reactive-replication decision rule, shared by every substrate.

    Wraps a frozen :class:`~repro_torch.cluster.scenario.Speculation` config
    with the three pure computations the engine, the epoch scan and the live
    runtime must agree on bit for bit:

    * ``median(obs)`` -- the running *lower* median of completed sibling
      batch durations (``None`` until ``min_observations`` have completed);
    * ``lagging(elapsed, median)`` -- the MapReduce backup-task trigger,
      ``elapsed > theta x median``;
    * ``next_epoch(crossing, now)`` -- the first heartbeat epoch
      ``k x interval`` strictly after both the crossing time and ``now``.
    """

    def __init__(self, cfg):
        self.cfg = cfg

    def median(self, obs: Sequence[float]) -> Optional[float]:
        """Running median of observed task times, or None below min_observations."""
        if len(obs) < self.cfg.min_observations:
            return None
        s = sorted(obs)
        return s[(len(s) - 1) // 2]

    def lagging(self, elapsed: float, median: float) -> bool:
        """Whether a task ``elapsed`` seconds in counts as a laggard."""
        return elapsed > self.cfg.theta * median

    def next_epoch(self, crossing: float, now: float) -> float:
        """First check-epoch boundary after both ``crossing`` and ``now``."""
        iv = self.cfg.interval
        k = max(math.floor(crossing / iv), math.floor(now / iv)) + 1
        return k * iv


def _inverse_min(dist: ServiceTime, c: float) -> ServiceTime:
    """Undo min-of-c censoring: the inverse of ``service_time.min_of``.

    When redundant replicas are cancelled, only each batch's fastest replica
    is observed -- a draw from the first order statistic of c i.i.d. tasks.
    For the closed families the base law is recoverable exactly:
    Exp(mu') -> Exp(mu'/c), SExp(d, mu') -> SExp(d, mu'/c),
    Pareto(s, a') -> Pareto(s, a'/c).
    """
    if c <= 1.0:
        return dist
    if isinstance(dist, Exponential):
        return Exponential(mu=dist.mu / c)
    if isinstance(dist, ShiftedExponential):
        return ShiftedExponential(delta=dist.delta, mu=dist.mu / c)
    if isinstance(dist, Pareto):
        return Pareto(sigma=dist.sigma, alpha=dist.alpha / c)
    return dist


class OnlineReplanner:
    """Sliding-window service-time refit + (B, r) replanning.

    Parameters
    ----------
    n_workers:
        Default worker budget to plan for (overridable per replan call, e.g.
        after churn changed the alive count).
    objective:
        ``'mean'`` | ``'cov'`` | ``'blend'`` -- forwarded to the planner.
    blend:
        Mean/CoV weight used when ``objective='blend'``.
    window:
        Number of most recent task-time observations kept.
    refit_every:
        Replan after this many new observations since the last refit.
    min_observations:
        Do not fit before this many samples are available (MLE stability).
    initial_plan:
        Optional starting operating point used until the first data-driven
        refit; it is not counted in ``history`` (which records replans only).
    """

    def __init__(
        self,
        n_workers: int,
        objective: str = "mean",
        window: int = 512,
        refit_every: int = 128,
        min_observations: int = 64,
        initial_plan: Optional[RedundancyPlan] = None,
        blend: float = 0.5,
    ):
        self.n_workers = int(n_workers)
        self.objective = objective
        self.blend = float(blend)
        self.window = int(window)
        self.refit_every = int(refit_every)
        self.min_observations = int(min_observations)
        self.observations: collections.deque = collections.deque(maxlen=self.window)
        self.current: Optional[RedundancyPlan] = initial_plan
        self.history: list = []
        self.last_fit: Optional[ServiceTime] = None
        self._since_refit = 0

    def observe(self, task_time: float, n_competitors: int = 1) -> None:
        """Record one observed per-task service time (completed replicas only).

        ``n_competitors`` is the number of replicas that were racing when this
        one won (1 = uncensored); ``replan`` uses it to undo the min-of-r
        censoring of cancelled runs.
        """
        if task_time > 0.0 and np.isfinite(task_time):
            self.observations.append((float(task_time), max(1, int(n_competitors))))
            self._since_refit += 1

    def observe_many(self, task_times, n_competitors: int = 1) -> None:
        """Feed a batch of task times into :meth:`observe`."""
        for t in np.asarray(task_times, dtype=np.float64).ravel():
            self.observe(float(t), n_competitors)

    def maybe_replan(self, n_workers: Optional[int] = None) -> Optional[RedundancyPlan]:
        """Refit + replan if enough new evidence accumulated; else None."""
        if len(self.observations) < self.min_observations:
            return None
        if self._since_refit < self.refit_every:
            return None
        return self.replan(n_workers)

    def replan(self, n_workers: Optional[int] = None) -> RedundancyPlan:
        """Unconditionally refit the window and re-pick (B, r)."""
        self._since_refit = 0
        n = int(n_workers) if n_workers is not None else self.n_workers
        planner = RedundancyPlanner(n)
        samples = np.array([t for t, _ in self.observations])
        counts = np.array([c for _, c in self.observations], dtype=np.float64)
        dist = fit_service_time(samples)
        dist = _inverse_min(dist, float(counts.mean()))
        self.last_fit = dist
        plan = planner.plan(dist, objective=self.objective, blend=self.blend)
        self.current = plan
        self.history.append(plan)
        return plan
