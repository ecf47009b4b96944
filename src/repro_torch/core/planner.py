"""RedundancyPlanner: the paper's §VI-§VII results as a control-plane service.

Port of ``repro.core.planner``.  Given a worker budget N and knowledge of the
task service-time behaviour (a fitted distribution or raw trace samples), the
planner returns the operating point on the diversity-parallelism spectrum:

    B  = number of distinct (non-overlapping) batches / data shards
    r  = N / B = replication factor per batch

optimizing average job time (paper Thms 3/5/8), predictability (CoV, Thms
4/7/10), or a weighted blend.

The closed-form and bootstrap paths (:meth:`RedundancyPlanner.plan`,
:meth:`~RedundancyPlanner.plan_empirical`, :meth:`~RedundancyPlanner.plan_auto`)
are numpy and bit-exact to the reference.  :meth:`~RedundancyPlanner.plan_cluster`
and :func:`plan_sweep` score the frontier by Monte-Carlo on the card through
:func:`repro_torch.cluster.vectorized.frontier_job_times`.  Dynamic and
space-sharing scenarios, the Python event engine and ``plan_slo`` come with
later slices of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from . import analysis
from .service_time import (
    Empirical,
    Exponential,
    Pareto,
    ServiceTime,
    ShiftedExponential,
)

__all__ = [
    "RedundancyPlan",
    "RedundancyPlanner",
    "fit_service_time",
    "plan_sweep",
]


@dataclasses.dataclass(frozen=True)
class RedundancyPlan:
    """A chosen (B, r) point plus the predicted frontier it was picked from."""

    n_workers: int
    n_batches: int  # B: distinct data shards
    replication: int  # r = N / B
    objective: str  # 'mean' | 'cov' | 'blend'
    predicted_mean: float
    predicted_cov: float
    # full frontier for observability dashboards
    frontier_B: tuple
    frontier_mean: tuple
    frontier_cov: tuple
    source: str  # 'closed_form:<dist>' | 'empirical_bootstrap' | 'cluster_engine:torch'

    @property
    def diversity(self) -> float:
        """0 = full parallelism (B=N), 1 = full diversity (B=1)."""
        if self.n_workers == 1:
            return 1.0
        return 1.0 - (self.n_batches - 1) / (self.n_workers - 1)


def fit_service_time(samples: Sequence[float]) -> ServiceTime:
    """Fit Exp / SExp / Pareto by maximum likelihood and pick by log-lik.

    Mirrors §VII: classify a job's tasks as exponential-tail or heavy-tail
    from its service-time records, then plan with the matching closed form.
    """
    x = np.asarray(samples, dtype=np.float64)
    x = x[x > 0]
    if x.size < 2:
        raise ValueError("need at least 2 positive samples")
    n = x.size
    xmin, xbar = float(x.min()), float(x.mean())

    fits: list[tuple[float, ServiceTime]] = []

    # Exponential(mu): MLE mu = 1/mean
    mu = 1.0 / xbar
    ll_exp = n * math.log(mu) - mu * x.sum()
    fits.append((ll_exp, Exponential(mu=mu)))

    # ShiftedExponential(delta, mu): MLE delta = min, mu = 1/(mean - min)
    if xbar > xmin:
        delta = xmin
        mu_s = 1.0 / (xbar - xmin)
        ll_sexp = n * math.log(mu_s) - mu_s * float((x - delta).sum())
        fits.append((ll_sexp, ShiftedExponential(delta=delta, mu=mu_s)))

    # Pareto(sigma, alpha): MLE sigma = min, alpha = n / sum log(x/sigma)
    logs = np.log(x / xmin)
    s_logs = float(logs.sum())
    if s_logs > 0:
        alpha = n / s_logs
        ll_par = n * math.log(alpha) + n * alpha * math.log(xmin) - (alpha + 1.0) * float(
            np.log(x).sum()
        )
        fits.append((ll_par, Pareto(sigma=xmin, alpha=alpha)))

    fits.sort(key=lambda p: p[0], reverse=True)
    return fits[0][1]


class RedundancyPlanner:
    """Plans (B, r) for a worker budget from closed forms or traces."""

    def __init__(self, n_workers: int, candidates: Iterable[int] | None = None):
        self.n_workers = int(n_workers)
        self.candidates = (
            list(candidates) if candidates is not None else analysis.feasible_B(self.n_workers)
        )

    # -- closed-form path ---------------------------------------------------

    def plan(
        self, dist: ServiceTime, objective: str = "mean", blend: float = 0.5
    ) -> RedundancyPlan:
        """Pick (B, r) from the closed-form frontier of ``dist`` (§IV-§V)."""
        if isinstance(dist, Empirical):
            return self.plan_empirical(np.asarray(dist.samples), objective, blend=blend)
        n = self.n_workers
        means = np.array([analysis.mean_T(dist, n, b) for b in self.candidates])
        covs = np.array([analysis.cov_T(dist, n, b) for b in self.candidates])
        b = self._select(means, covs, objective, blend)
        return self._mk_plan(b, means, covs, objective, f"closed_form:{type(dist).__name__}")

    # -- trace/empirical path (bootstrap over the §VI size model) -----------

    def plan_empirical(
        self,
        samples: np.ndarray,
        objective: str = "mean",
        n_mc: int = 20_000,
        seed: int = 0,
        blend: float = 0.5,
    ) -> RedundancyPlan:
        """Estimate E[T](B) and CoV(B) by resampling task times from the trace.

        This is the experiment of Figs. 12-13: for each feasible B, draw task
        service times, form batch times (N/B)*tau, take max-min.
        """
        x = np.asarray(samples, dtype=np.float64)
        rng = np.random.default_rng(seed)
        n = self.n_workers
        means, covs = [], []
        for b in self.candidates:
            r = n // b
            draws = rng.choice(x, size=(n_mc, b, r), replace=True) * (n / b)
            t = draws.min(axis=2).max(axis=1)
            means.append(float(t.mean()))
            covs.append(float(t.std() / t.mean()))
        means, covs = np.array(means), np.array(covs)
        b = self._select(means, covs, objective, blend)
        return self._mk_plan(b, means, covs, objective, "empirical_bootstrap")

    def plan_auto(self, samples: np.ndarray, objective: str = "mean") -> RedundancyPlan:
        """§VII methodology: fit the tail family, then use its closed form."""
        dist = fit_service_time(samples)
        return self.plan(dist, objective=objective)

    # -- engine path (candidates scored by Monte-Carlo on the card) ---------

    def plan_cluster(
        self,
        dist: ServiceTime | None = None,
        objective: str = "mean",
        n_reps: int = 400,
        seed: int = 0,
        blend: float = 0.5,
        backend: str = "torch",
        scenario=None,
        device=None,
    ) -> RedundancyPlan:
        """Pick (B, r) by *executing* every candidate under the engine's semantics.

        ``backend="torch"`` scores the whole candidate frontier in one
        device pass (:func:`repro_torch.cluster.vectorized.frontier_job_times`)
        on ``device`` (default: the CUDA card).  The scenario is a
        :class:`~repro_torch.cluster.scenario.Scenario` (which may also carry
        ``dist``); its static knobs (``size_dependent``, ``cancel_redundant``)
        apply.  Dynamic or space-sharing scenarios, ``rep_chunk`` and
        ``backend="python"`` raise :class:`NotImplementedError` until their
        slices of the port land.
        """
        from ..cluster.scenario import Scenario

        sc = scenario if scenario is not None else Scenario()
        dist = dist if dist is not None else sc.dist
        if dist is None:
            raise ValueError("plan_cluster needs dist (positionally or via scenario.dist)")
        if backend == "python":
            raise NotImplementedError(
                "backend='python' scores candidates on the DES engine, which the port "
                "reaches in a later slice (ROADMAP.md, queue 1, item 5)"
            )
        if backend != "torch":
            raise ValueError(f"unknown backend {backend!r} (expected 'torch')")
        sc.validate(n_workers=self.n_workers, backend="torch")
        if sc.is_dynamic or sc.is_space:
            raise NotImplementedError(
                "dynamic and space-sharing scenarios run on the epoch scan, which the "
                "port reaches in a later slice (ROADMAP.md, queue 1, item 4)"
            )
        if sc.dtype != "float32" or sc.devices != 1:
            raise ValueError(
                "Scenario.dtype/devices apply to dynamic scenarios (the epoch scan); "
                "the static frontier path supports rep_chunk only"
            )
        from ..cluster.vectorized import frontier_job_times

        rows = frontier_job_times(
            dist,
            self.n_workers,
            self.candidates,
            n_reps,
            seed=seed,
            size_dependent=sc.size_dependent,
            rep_chunk=sc.rep_chunk,
            device=device,
        )
        means, covs = _frontier_stats(rows)
        b = self._select(means, covs, objective, blend)
        return self._mk_plan(b, means, covs, objective, f"cluster_engine:{backend}")

    # -- helpers -------------------------------------------------------------

    def _select(self, means, covs, objective, blend) -> int:
        if objective == "mean":
            idx = int(np.argmin(means))
        elif objective == "cov":
            idx = int(np.argmin(covs))
        elif objective == "blend":
            # normalized blend: the administrator's middle point.  Degenerate
            # candidates (zero/infinite mean => infinite CoV) would poison the
            # normalization with inf - inf = NaN and argmin would then pick
            # them; normalize over the finite candidates only and push the
            # rest to +inf score.
            finite = np.isfinite(means) & np.isfinite(covs)
            if not finite.any():
                idx = 0  # every candidate is degenerate; nothing to rank
            else:
                mn = _norm01(means, finite)
                cn = _norm01(covs, finite)
                score = np.where(finite, blend * mn + (1 - blend) * cn, np.inf)
                idx = int(np.argmin(score))
        else:
            raise ValueError(f"unknown objective {objective!r}")
        return self.candidates[idx]

    def _mk_plan(self, b, means, covs, objective, source) -> RedundancyPlan:
        i = self.candidates.index(b)
        return RedundancyPlan(
            n_workers=self.n_workers,
            n_batches=b,
            replication=self.n_workers // b,
            objective=objective,
            predicted_mean=float(means[i]),
            predicted_cov=float(covs[i]),
            frontier_B=tuple(self.candidates),
            frontier_mean=tuple(float(m) for m in means),
            frontier_cov=tuple(float(c) for c in covs),
            source=source,
        )


def _norm01(values: np.ndarray, finite: np.ndarray) -> np.ndarray:
    """Min-max normalize the finite lanes; non-finite lanes are left at 0
    (callers mask them out of the score separately, keeping inf - inf NaNs
    out of the arithmetic entirely)."""
    out = np.zeros_like(values, dtype=np.float64)
    vf = values[finite]
    lo = float(vf.min())
    out[finite] = (vf - lo) / max(float(vf.max()) - lo, 1e-12)
    return out


def _frontier_stats(rows) -> tuple[np.ndarray, np.ndarray]:
    """Per-candidate (mean, CoV) from job-time sample rows.

    Degenerate rows -- no finite samples, or an all-zero mean -- score
    (inf, inf) so selection can rank them last instead of dividing by zero.
    """
    means, covs = [], []
    for t in rows:
        t = np.asarray(t)
        t = t[np.isfinite(t)]
        m = float(t.mean()) if t.size else math.inf
        if t.size == 0 or m <= 0.0:
            means.append(math.inf if t.size == 0 else m)
            covs.append(math.inf)
            continue
        means.append(m)
        covs.append(float(t.std() / m))
    return np.array(means), np.array(covs)


def plan_sweep(
    dists: Sequence[ServiceTime],
    budgets: Sequence[int],
    objective: str = "mean",
    *,
    n_reps: int = 400,
    seed: int = 0,
    blend: float = 0.5,
    backend: str = "torch",
    candidates: Iterable[int] | None = None,
    scenario=None,
    device=None,
) -> list:
    """Score redundancy frontiers for a (distribution x worker-budget) grid.

    Returns ``plans`` with ``plans[i][j]`` the :class:`RedundancyPlan` for
    ``dists[i]`` under ``budgets[j]``.  Each grid point scores its entire
    candidate frontier in one device pass (one launch of the cover kernel on
    CUDA), so a sweep is ``len(dists) * len(budgets)`` passes.

    Grid point (i, j) uses seed ``seed + i * len(budgets) + j``, the
    reference's derivation, so each sweep entry equals an identically-seeded
    :meth:`RedundancyPlanner.plan_cluster` call.
    """
    dists = list(dists)
    budgets = [int(n) for n in budgets]
    plans = []
    for i, dist in enumerate(dists):
        row = []
        for j, n_workers in enumerate(budgets):
            planner = RedundancyPlanner(n_workers, candidates=candidates)
            row.append(
                planner.plan_cluster(
                    dist,
                    objective,
                    n_reps=n_reps,
                    seed=seed + i * len(budgets) + j,
                    blend=blend,
                    backend=backend,
                    scenario=scenario,
                    device=device,
                )
            )
        plans.append(row)
    return plans
