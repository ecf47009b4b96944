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
:func:`repro_torch.cluster.vectorized.frontier_job_times`;
:meth:`~RedundancyPlanner.plan_slo` runs every (B, r, scheduler) candidate
through the trace-scale stream (:func:`repro_torch.cluster.stream.
simulate_stream`) and returns the same :class:`SLOPlan` as the reference.
Dynamic gang scenarios (churn, heterogeneous speeds, the in-scan replanner,
speculative backups) score on the epoch scan
(:func:`repro_torch.cluster.epoch_scan.frontier_job_times_dynamic`), and
``plan_slo`` runs them through ``simulate_epochs``; space sharing and the
Python event engine come with later slices of the port.  Both entry points
take the reference's loose scenario keywords behind its
``DeprecationWarning`` shim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from ..spans import span
from . import analysis
from .service_time import (
    Empirical,
    Exponential,
    Pareto,
    ServiceTime,
    ShiftedExponential,
)

# "not passed" marker for the loose scenario kwargs: core cannot import
# cluster.scenario's UNSET at module level (cluster imports core)
_UNSET = type("_PlannerUnset", (), {"__repr__": lambda self: "UNSET"})()

__all__ = [
    "RedundancyPlan",
    "RedundancyPlanner",
    "SLOCandidate",
    "SLOPlan",
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


@dataclasses.dataclass(frozen=True)
class SLOCandidate:
    """One evaluated point of the :meth:`RedundancyPlanner.plan_slo` grid.

    ``achieved`` holds the response quantile the candidate delivered for
    each SLO (in SLO order); ``feasible`` is whether every one of them met
    its target.  ``cost_worker_seconds`` is the per-rep mean charged
    worker-seconds over the evaluation stream -- the cost plan_slo
    minimizes among feasible candidates.
    """

    scheduler: str
    workers_per_job: int | None  # pool width (None on fifo_gang)
    n_batches: int
    replication: int
    feasible: bool
    cost_worker_seconds: float
    mean_response: float
    achieved: tuple  # response quantile per SLO, SLO order


@dataclasses.dataclass(frozen=True)
class SLOPlan:
    """The :meth:`RedundancyPlanner.plan_slo` verdict.

    ``feasible`` says whether *any* candidate met every SLO; when it did,
    ``best`` is the cheapest such candidate (worker-seconds, ties broken by
    mean response) -- when it did not, ``best`` is ``None`` and the sorted
    ``candidates`` tuple shows how close the grid came.  Infeasibility is
    an explicit verdict, never a silent fallback to the cheapest violator.
    """

    n_workers: int
    slos: tuple  # tuple[repro_torch.cluster.SLO, ...]
    classes: tuple  # workload class names, stream source order
    feasible: bool
    best: SLOCandidate | None
    candidates: tuple  # every evaluated SLOCandidate, best-first
    source: str  # 'stream' (the epoch-scan lane is not ported yet)

    def require_feasible(self) -> SLOCandidate:
        """The best candidate, or ``ValueError`` if no candidate met the SLOs."""
        if not self.feasible or self.best is None:
            raise ValueError(
                f"no (B, r, scheduler) candidate met the SLOs {self.slos!r} "
                f"on n_workers={self.n_workers} (closest: {self.candidates[0]!r})"
            )
        return self.best

    def best_for(self, job_class: str) -> SLOCandidate | None:
        """Cheapest candidate feasible for *one* class's SLOs alone.

        Filters the SLO list down to the entries naming ``job_class`` and
        re-ranks the already-evaluated grid against just those -- the
        per-class answer under space sharing, where one class's target may
        be achievable even when the joint plan is infeasible.  Returns
        ``None`` when no candidate meets the class's SLOs.
        """
        idx = [i for i, s in enumerate(self.slos) if s.job_class == job_class]
        if not idx:
            raise KeyError(f"no SLO names job_class {job_class!r}")
        ok = [
            c
            for c in self.candidates
            if all(c.achieved[i] <= self.slos[i].target_s for i in idx)
        ]
        return min(ok, key=lambda c: (c.cost_worker_seconds, c.mean_response)) if ok else None


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
        size_dependent=_UNSET,
        cancel_redundant=_UNSET,
        backend: str = "torch",
        speeds=_UNSET,
        churn=_UNSET,
        churn_schedule=_UNSET,
        replan=_UNSET,
        speculation=_UNSET,
        scheduler=_UNSET,
        workers_per_job=_UNSET,
        job_plans=_UNSET,
        jobs_per_stream=_UNSET,
        churn_pairs_per_worker=_UNSET,
        dtype=_UNSET,
        rep_chunk=_UNSET,
        devices=_UNSET,
        scenario=None,
        device=None,
    ) -> RedundancyPlan:
        """Pick (B, r) by *executing* every candidate under the engine's semantics.

        ``backend="torch"`` scores the whole candidate frontier in one
        device pass on ``device`` (default: the CUDA card): the static
        frontier (:func:`repro_torch.cluster.vectorized.frontier_job_times`)
        when the cluster is static, or the epoch scan's gang lane
        (:func:`repro_torch.cluster.epoch_scan.frontier_job_times_dynamic`)
        once ``speeds``, ``churn``, ``churn_schedule``, ``replan`` (the
        windowed online replanner running while candidates are scored) or
        ``speculation`` (reactive backups) is set -- then samples come in
        serial streams of ``jobs_per_stream`` jobs sharing one churn
        timeline.  ``rep_chunk`` bounds the reps of one pass (the rows are
        bit-identical for every chunking); ``dtype`` applies to the dynamic
        path only.

        ``scheduler`` / ``workers_per_job`` / ``job_plans`` score the
        candidates under space sharing on the epoch scan's space lane: each
        stream's jobs run concurrently on disjoint worker subsets, and jobs
        whose :class:`~repro_torch.cluster.scheduler.JobPlan` leaves
        ``n_batches`` unset take the candidate B.  ``backend="python"`` runs
        the event engine (:mod:`repro_torch.cluster.master`, host numpy, as
        the reference's) once per candidate with seed ``seed + i``, over the
        same knobs; it takes no ``device`` and refuses one.

        The scenario knobs are best passed as one ``scenario=Scenario(...)``
        (which may also carry ``dist``); the loose keyword forms keep working
        behind a :class:`DeprecationWarning`, and both forms give identical
        plans on identical seeds.
        """
        from ..cluster.scenario import resolve_scenario

        with span("plan.scenario"):
            sc = resolve_scenario(
                scenario,
                {
                    k: v
                    for k, v in {
                        "cancel_redundant": cancel_redundant,
                        "size_dependent": size_dependent,
                        "speeds": speeds,
                        "churn": churn,
                        "churn_schedule": churn_schedule,
                        "churn_pairs_per_worker": churn_pairs_per_worker,
                        "replan": replan,
                        "speculation": speculation,
                        "scheduler": scheduler,
                        "workers_per_job": workers_per_job,
                        "job_plans": job_plans,
                        "jobs_per_stream": jobs_per_stream,
                        "dtype": dtype,
                        "rep_chunk": rep_chunk,
                        "devices": devices,
                    }.items()
                    if v is not _UNSET
                },
                where="plan_cluster",
            )
            dist = dist if dist is not None else sc.dist
            if dist is None:
                raise ValueError("plan_cluster needs dist (positionally or via scenario.dist)")
            if backend not in ("torch", "python"):
                raise ValueError(f"unknown backend {backend!r} (expected 'torch' or 'python')")
            if backend == "python" and device is not None:
                raise ValueError("backend='python' runs the engine on the host and takes no device")
            sc.validate(n_workers=self.n_workers, backend=backend)
        with span("plan.frontier"):
            if backend == "python":
                from ..cluster.master import sample_job_times

                rows = [
                    sample_job_times(dist, self.n_workers, b, n_reps, seed=seed + i, scenario=sc,
                                     backend="python")
                    for i, b in enumerate(self.candidates)
                ]
            elif sc.is_dynamic or sc.is_space:
                from ..cluster.epoch_scan import frontier_job_times_dynamic

                rows = frontier_job_times_dynamic(
                    dist, self.n_workers, self.candidates, n_reps, seed=seed, scenario=sc,
                    device=device,
                )
            else:
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
        with span("plan.select"):
            means, covs = _frontier_stats(rows)
            b = self._select(means, covs, objective, blend)
            return self._mk_plan(b, means, covs, objective, f"cluster_engine:{backend}")

    # -- tail-SLO path (cheapest candidate meeting a response target) --------

    def plan_slo(
        self,
        workload,
        slo=None,
        *,
        scenario=None,
        n_jobs: int = 2000,
        n_reps: int = 4,
        seed: int = 0,
        schedulers: Sequence[str] = ("fifo_gang", "packed", "balanced"),
        pool_widths: Sequence[int] | None = None,
        slab: int | None = 1024,
        device=None,
    ) -> SLOPlan:
        """Cheapest (B, r, scheduler) meeting tail response-time SLOs.

        The paper's second core result is that mean-optimal replication is
        not tail-optimal; this is the planner surface that acts on it.  Each
        grid candidate is *executed* against a seeded Poisson arrival stream
        (:func:`repro_torch.core.traces.poisson_stream` at the SLO's
        ``arrival_rate``) on the trace-scale stream
        (:func:`repro_torch.cluster.simulate_stream`, on ``device``, default
        the CUDA card), whose scan carries pooled *and per-class* response
        histograms -- so p99/p999 feasibility per job class costs O(n_reps)
        memory however long the stream.  The quantile estimator is
        conservative by construction (bin upper edge, see
        :data:`repro_torch.cluster.STREAM_QUANTILE_RTOL`): a candidate is
        never declared feasible because of histogram resolution.

        ``workload`` is one job class or a sequence of them -- each a
        :class:`~repro_torch.core.traces.TraceJob` or a fitted
        :class:`~repro_torch.core.service_time.ServiceTime` (sampled into a
        seeded trace job); arrivals draw classes uniformly.  ``slo`` is one
        :class:`~repro_torch.cluster.SLO` or a sequence (defaults to
        ``scenario.slo``); every SLO must share one ``arrival_rate``, and a
        per-class SLO names its class via ``SLO.job_class``.

        The grid: ``fifo_gang`` sweeps this planner's B candidates on the
        whole cluster; ``packed`` / ``balanced`` additionally sweep pool
        widths (``pool_widths``, default every proper divisor of the worker
        budget) with B over each width's divisors -- the statically
        space-shared case where per-class SLOs bind.  Dynamic scenarios
        (``speeds`` / ``churn`` / ``replan`` / ``speculation``) run each B
        candidate through the epoch scan (:func:`repro_torch.cluster.
        epoch_scan.simulate_epochs`) and read exact response quantiles from
        its per-job records; they take a single job class, pooled SLOs and
        ``schedulers=("fifo_gang",)``, and the plan's ``source`` is
        ``"epoch_scan"``.

        Returns an :class:`SLOPlan`: ``best`` is the cheapest feasible
        candidate in charged worker-seconds, or ``None`` with
        ``feasible=False`` -- an explicit infeasible verdict, never a
        silent fallback.

        Example (small grid, generous target)::

            >>> from repro_torch.core import SLO, Exponential
            >>> plan = RedundancyPlanner(4).plan_slo(
            ...     [Exponential(1.0)],
            ...     SLO(quantile=0.9, target_s=30.0, arrival_rate=0.2),
            ...     n_jobs=200, n_reps=2, schedulers=("fifo_gang",), device="cpu")
            >>> plan.feasible
            True
            >>> plan.best.scheduler
            'fifo_gang'
        """
        from ..cluster.scenario import SLO, Scenario
        from .traces import TraceJob, poisson_stream

        # default to whole-job service draws: under the §VI size model
        # (size_dependent=True) a job's work scales with its source trace's
        # task count, which is meaningful for real TraceJobs but arbitrary
        # for ServiceTime workloads sampled into 4000-task stand-ins -- pass
        # an explicit scenario to opt in
        sc = scenario if scenario is not None else Scenario(size_dependent=False)
        if slo is None:
            slo = sc.slo
        if slo is None:
            raise ValueError("plan_slo needs an SLO (positionally or via scenario.slo)")
        slos = tuple(slo) if isinstance(slo, (list, tuple)) else (slo,)
        for s in slos:
            if not isinstance(s, SLO):
                raise ValueError(f"plan_slo: expected SLO entries, got {type(s)}")
        rates = {float(s.arrival_rate) for s in slos}
        if len(rates) != 1:
            raise ValueError(
                f"plan_slo: every SLO must share one arrival_rate, got {sorted(rates)}"
            )
        if isinstance(workload, (TraceJob, ServiceTime)):
            workload = [workload]
        sources = []
        for i, w in enumerate(workload):
            if isinstance(w, TraceJob):
                sources.append(w)
            elif isinstance(w, ServiceTime):
                rng = np.random.default_rng(
                    np.random.SeedSequence((int(seed), 0x51_0, i))
                )
                name = type(w).__name__.lower()
                if any(src.name == name for src in sources):
                    name = f"{name}{i}"
                sources.append(
                    TraceJob(
                        name=name,
                        family="fitted",
                        task_times=w.sample_np(rng, (4000,)),
                    )
                )
            else:
                raise ValueError(
                    f"plan_slo: workload entries must be TraceJob or "
                    f"ServiceTime, got {type(w)}"
                )
        names = tuple(src.name for src in sources)
        for s in slos:
            if s.job_class is not None and s.job_class not in names:
                raise ValueError(
                    f"plan_slo: SLO.job_class {s.job_class!r} is not a "
                    f"workload class (classes: {names})"
                )
        stream = poisson_stream(sources, rates.pop(), n_jobs, seed=seed)
        if sc.is_dynamic:
            evaluated = self._slo_epoch_candidates(
                workload, sc, slos, stream, n_reps, seed, schedulers, device
            )
            source = "epoch_scan"
        else:
            evaluated = self._slo_stream_candidates(
                sc, slos, stream, n_reps, schedulers, pool_widths, slab, device
            )
            source = "stream"
        evaluated.sort(
            key=lambda c: (not c.feasible, c.cost_worker_seconds, c.mean_response)
        )
        best = evaluated[0] if evaluated and evaluated[0].feasible else None
        return SLOPlan(
            n_workers=self.n_workers,
            slos=slos,
            classes=names,
            feasible=best is not None,
            best=best,
            candidates=tuple(evaluated),
            source=source,
        )

    def _slo_grid(self, schedulers, pool_widths):
        """(scheduler, pool_width, B) triples for the plan_slo sweep."""
        grid = []
        for sched in schedulers:
            if sched == "fifo_gang":
                grid.extend((sched, None, b) for b in self.candidates)
            elif sched in ("packed", "balanced"):
                widths = (
                    [int(w) for w in pool_widths]
                    if pool_widths is not None
                    else [w for w in analysis.feasible_B(self.n_workers) if w < self.n_workers]
                )
                for w in widths:
                    if self.n_workers % w:
                        raise ValueError(
                            f"plan_slo: pool width {w} must divide "
                            f"n_workers={self.n_workers}"
                        )
                    grid.extend((sched, w, b) for b in analysis.feasible_B(w))
            else:
                raise ValueError(f"plan_slo: unknown scheduler {sched!r}")
        return grid

    def _slo_stream_candidates(
        self, sc, slos, stream, n_reps, schedulers, pool_widths, slab, device
    ):
        """Score the static grid on the streaming kernel's class histograms."""
        from ..cluster.stream import simulate_stream

        out = []
        for sched, width, b in self._slo_grid(schedulers, pool_widths):
            sc_c = sc.replace(
                scheduler=sched, workers_per_job=width, outputs="stream",
                n_batches=None, n_workers=None,
            )
            stats = simulate_stream(
                stream, self.n_workers, b, n_reps, scenario=sc_c, slab=slab, device=device
            )
            achieved = tuple(
                stats.quantile(s.quantile, job_class=s.job_class) for s in slos
            )
            total = int(stats.count.sum())
            out.append(
                SLOCandidate(
                    scheduler=sched,
                    workers_per_job=width,
                    n_batches=b,
                    replication=(self.n_workers if width is None else width) // b,
                    feasible=all(a <= s.target_s for a, s in zip(achieved, slos)),
                    cost_worker_seconds=float(stats.busy_sum.mean()),
                    mean_response=float(stats.resp_sum.sum() / max(total, 1)),
                    achieved=achieved,
                )
            )
        return out

    def _slo_epoch_candidates(
        self, workload, sc, slos, stream, n_reps, seed, schedulers, device
    ):
        """Dynamic lane: exact response quantiles from the epoch scan."""
        from ..cluster.epoch_scan import simulate_epochs

        if len(stream.sources) != 1 or any(s.job_class is not None for s in slos):
            raise ValueError(
                "plan_slo: dynamic scenarios (speeds/churn/replan/speculation) "
                "support a single job class with pooled SLOs (the epoch scan "
                "has no per-class stream state)"
            )
        if tuple(schedulers) != ("fifo_gang",) and set(schedulers) != {
            "fifo_gang", "packed", "balanced",
        }:
            raise ValueError(
                "plan_slo: dynamic scenarios sweep B on fifo_gang only; pass "
                "schedulers=('fifo_gang',)"
            )
        dist = workload[0]
        if not isinstance(dist, ServiceTime):
            dist = Empirical(samples=tuple(np.asarray(workload[0].task_times)))
        out = []
        for b in self.candidates:
            rep = simulate_epochs(
                dist,
                self.n_workers,
                b,
                stream.arrivals,
                n_reps,
                seed=seed,
                scenario=sc.replace(n_batches=None, n_workers=None, outputs="full"),
                device=device,
            )
            resp = np.asarray(rep.finishes, np.float64) - stream.arrivals[None, :]
            resp = resp[np.isfinite(resp)]
            achieved = tuple(
                float(np.quantile(resp, s.quantile)) if resp.size else float("inf")
                for s in slos
            )
            out.append(
                SLOCandidate(
                    scheduler="fifo_gang",
                    workers_per_job=None,
                    n_batches=b,
                    replication=self.n_workers // b,
                    feasible=all(a <= s.target_s for a, s in zip(achieved, slos)),
                    cost_worker_seconds=float(
                        np.asarray(rep.worker_seconds, np.float64).mean()
                    ),
                    mean_response=float(resp.mean()) if resp.size else float("inf"),
                    achieved=achieved,
                )
            )
        return out

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
    size_dependent=_UNSET,
    cancel_redundant=_UNSET,
    backend: str = "torch",
    candidates: Iterable[int] | None = None,
    speeds=_UNSET,
    churn=_UNSET,
    churn_schedule=_UNSET,
    replan=_UNSET,
    speculation=_UNSET,
    scheduler=_UNSET,
    workers_per_job=_UNSET,
    job_plans=_UNSET,
    jobs_per_stream=_UNSET,
    churn_pairs_per_worker=_UNSET,
    dtype=_UNSET,
    rep_chunk=_UNSET,
    devices=_UNSET,
    scenario=None,
    device=None,
) -> list:
    """Score redundancy frontiers for a (distribution x worker-budget) grid.

    Returns ``plans`` with ``plans[i][j]`` the :class:`RedundancyPlan` for
    ``dists[i]`` under ``budgets[j]``.  Each grid point scores its entire
    candidate frontier in one device pass (one launch of the cover kernel on
    CUDA for a static cluster; the epoch scan's lane batch for a dynamic
    one), so a sweep is ``len(dists) * len(budgets)`` passes.

    Grid point (i, j) uses seed ``seed + i * len(budgets) + j``, the
    reference's derivation, so each sweep entry equals an identically-seeded
    :meth:`RedundancyPlanner.plan_cluster` call.  ``speeds`` takes either one
    per-worker sequence or a callable ``budget -> speeds`` (a sweep-level
    convenience re-attached per budget; it cannot live in a frozen Scenario).
    Scenario knobs are best passed as one ``scenario=Scenario(...)``; the
    loose keyword forms keep working behind one ``DeprecationWarning``.
    """
    from ..cluster.scenario import resolve_scenario

    speeds_fn = speeds if callable(speeds) else None
    if speeds_fn is not None and scenario is not None:
        raise ValueError(
            "plan_sweep: got scenario= and loose scenario kwargs (speeds); "
            "pass per-budget speeds by calling plan_sweep once per budget "
            "with scenario.replace(speeds=...)"
        )
    explicit = {
        k: v
        for k, v in {
            "size_dependent": size_dependent,
            "cancel_redundant": cancel_redundant,
            "speeds": speeds,
            "churn": churn,
            "churn_schedule": churn_schedule,
            "replan": replan,
            "speculation": speculation,
            "scheduler": scheduler,
            "workers_per_job": workers_per_job,
            "job_plans": job_plans,
            "jobs_per_stream": jobs_per_stream,
            "churn_pairs_per_worker": churn_pairs_per_worker,
            "dtype": dtype,
            "rep_chunk": rep_chunk,
            "devices": devices,
        }.items()
        if v is not _UNSET
    }
    if speeds_fn is not None:
        explicit.pop("speeds")  # re-attached per grid point below
    sc = resolve_scenario(scenario, explicit, where="plan_sweep")

    dists = list(dists)
    budgets = [int(n) for n in budgets]
    plans = []
    for i, dist in enumerate(dists):
        row = []
        for j, n_workers in enumerate(budgets):
            planner = RedundancyPlanner(n_workers, candidates=candidates)
            sc_ij = sc.replace(speeds=speeds_fn(n_workers)) if speeds_fn is not None else sc
            row.append(
                planner.plan_cluster(
                    dist,
                    objective,
                    n_reps=n_reps,
                    seed=seed + i * len(budgets) + j,
                    blend=blend,
                    backend=backend,
                    scenario=sc_ij,
                    device=device,
                )
            )
        plans.append(row)
    return plans
