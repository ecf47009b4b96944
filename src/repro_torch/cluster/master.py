"""Master: job queue, batch dispatch, earliest-cover completion, cancellation.

A numpy copy of ``repro.cluster.master`` for the port: the event-driven
engine runs on the host, as the reference's does, and gives identical
:class:`EngineReport` s on identical seeds.  Its imports are the port's own
(``core.service_time``, ``core.simulator``, ``cluster.control``,
``cluster.scenario``, ``cluster.scheduler``, ``cluster.workers``), and
:func:`sample_job_times` routes ``backend="torch"`` to the port's frontier and
epoch scan where the reference routes ``backend="jax"`` to its own.

:class:`ClusterEngine` executes (B, r) operating points instead of merely
evaluating them.  Per job the master splits the job's N tasks into B
balanced non-overlapping batches, assigns each batch to r = n_alive // B
workers (the paper's optimal scheme), and declares the job complete at the
earliest time the union of finished batch replicas covers all tasks --
``T = max_B min_r T_ij``, the §VI job time.

Beyond the closed forms, the engine expresses the dynamics the analysis
cannot: FIFO multi-job queueing (jobs gang-schedule onto the whole cluster),
cancellation of outstanding sibling replicas the moment a batch first
completes (reclaiming wasted worker-seconds), worker fail/join churn with
replica rescue, heterogeneous worker speeds, mid-stream replanning via an
:class:`~repro_torch.cluster.control.OnlineReplanner`, speculative backups,
and task-failure retries.

Scheduling is pluggable (:mod:`repro_torch.cluster.scheduler`): the default
``fifo_gang`` policy is the whole-cluster gang, while the space-sharing
policies (``packed`` first-fit, ``balanced`` least-loaded) run jobs
concurrently on disjoint worker subsets of ``workers_per_job`` workers, each
job under its *own* redundancy plan -- per-job B, r, and cancellation mode
via :class:`~repro_torch.cluster.scheduler.JobPlan`.  The epoch scan's space
lane (:mod:`repro_torch.cluster.epoch_scan`) replays these semantics on the
device and is held to this engine exactly on shared schedules.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..core.service_time import Empirical, ServiceTime
from ..core.simulator import JobTimeStats, stats_from_samples
from . import events as ev
from .control import OnlineReplanner, SpeculativePolicy
from .scenario import UNSET, Retry, Scenario, Speculation, resolve_scenario
from .scheduler import JobPlan, Scheduler, make_scheduler
from .workers import ChurnProcess, ChurnSchedule, Worker, WorkerPool, draw_batch_time

__all__ = [
    "Job",
    "JobRecord",
    "EngineReport",
    "ClusterEngine",
    "sample_job_times",
    "jobs_from_traces",
]


@dataclasses.dataclass(frozen=True)
class Job:
    """One job: N tasks whose service times follow ``dist``.

    ``plan`` optionally overrides the engine-wide worker request, batch
    count, and cancellation mode for this job alone (see
    :class:`~repro_torch.cluster.scheduler.JobPlan`) -- meaningful under a
    space-sharing scheduler, where concurrent jobs run heterogeneous plans.
    """

    job_id: int
    dist: ServiceTime
    n_tasks: int
    arrival: float = 0.0
    name: str = ""
    plan: Optional[JobPlan] = None


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """Execution outcome of one job (finish = inf if it never completed)."""

    job_id: int
    name: str
    arrival: float
    start: float
    finish: float
    n_batches: int
    replication: int

    @property
    def compute_time(self) -> float:
        """Finish minus start: time the job spent executing."""
        return self.finish - self.start

    @property
    def response_time(self) -> float:
        """Finish minus arrival: queueing delay plus compute."""
        return self.finish - self.arrival

    @property
    def queue_wait(self) -> float:
        """Start minus arrival: time spent waiting for workers."""
        return self.start - self.arrival


@dataclasses.dataclass
class EngineReport:
    """Aggregate outcome of one engine run.

    ``epoch_times`` are the applied churn-event times, i.e. the boundaries of
    the run's churn epochs (the intervals on which the alive set is constant).
    The epoch scan (:mod:`repro_torch.cluster.epoch_scan`) reports the same
    fields per Monte-Carlo rep; :meth:`accounting` is the shared,
    directly comparable summary the differential tests key on.
    """

    records: List[JobRecord]
    worker_seconds: float  # total busy time actually burned
    cancelled_seconds_saved: float  # scheduled-but-reclaimed replica time
    n_events: int
    n_worker_failures: int
    n_replicas_rescued: int
    n_replans: int
    final_n_batches: int
    epoch_times: tuple = ()  # applied churn-event times (epoch boundaries)
    n_speculative: int = 0  # reactive backup replicas launched
    n_task_failures: int = 0  # replicas whose payload raised (vs the worker dying)
    n_retries: int = 0  # failed replicas re-dispatched after backoff

    @property
    def compute_times(self) -> np.ndarray:
        """Compute time per completed job, record order."""
        return np.array([r.compute_time for r in self.records])

    @property
    def response_times(self) -> np.ndarray:
        """Response time per completed job, record order."""
        return np.array([r.response_time for r in self.records])

    @property
    def n_epochs(self) -> int:
        """Number of dispatch epochs the run went through."""
        return len(self.epoch_times) + 1

    def accounting(self) -> dict:
        """The invariant-bearing counters, keyed identically on both backends."""
        return {
            "worker_seconds": float(self.worker_seconds),
            "cancelled_seconds_saved": float(self.cancelled_seconds_saved),
            "n_worker_failures": int(self.n_worker_failures),
            "n_replicas_rescued": int(self.n_replicas_rescued),
            "n_replans": int(self.n_replans),
            "n_speculative": int(self.n_speculative),
            "n_task_failures": int(self.n_task_failures),
            "n_retries": int(self.n_retries),
        }

    def stats(self) -> JobTimeStats:
        """Summary statistics over the finite compute times."""
        t = self.compute_times
        t = t[np.isfinite(t)]
        return stats_from_samples(t) if t.size else JobTimeStats.empty()


@dataclasses.dataclass
class _JobExec:
    """Mutable per-job execution state while the job is on the cluster."""

    job: Job
    start: float
    n_batches: int
    replication: int
    # per-job cancellation mode (JobPlan override or the engine default)
    cancel: bool = False
    # wids allocated to this job under a space-sharing scheduler; None means
    # the whole cluster (fifo_gang), so joins serve the active gang's rescues
    alloc: Optional[Set[int]] = None
    done: Set[int] = dataclasses.field(default_factory=set)
    # batch -> wids with an in-flight replica of that batch
    outstanding: Dict[int, Set[int]] = dataclasses.field(default_factory=dict)
    # completed sibling batch durations, in completion order: the running
    # observations the speculative policy takes its median over
    obs: List[float] = dataclasses.field(default_factory=list)
    # speculative backups launched for this job (capped by the policy)
    spec_used: int = 0

    @property
    def batch_tasks(self) -> float:
        return self.job.n_tasks / self.n_batches

    @property
    def complete(self) -> bool:
        return len(self.done) == self.n_batches


class ClusterEngine:
    """Event-driven master-worker cluster executing redundancy plans.

    Parameters
    ----------
    n_workers:
        Initial cluster size.
    seed:
        Root seed; every stochastic stream (service draws, churn, arrivals)
        derives from it, so runs replay exactly.
    n_batches:
        Static plan: split every job into this many batches (clamped to the
        alive-worker count at dispatch).  ``None`` means full parallelism
        (B = alive workers) unless a controller supplies a plan.
    cancel_redundant:
        Cancel a batch's outstanding sibling replicas the moment its first
        replica finishes, reclaiming their remaining worker-seconds.
    size_dependent:
        §VI size model (batch time = (N/B) tau) vs §IV batch-level model.
    speeds:
        Optional per-worker speed factors (heterogeneous cluster).
    churn:
        Optional fail/join process applied independently to every worker.
    churn_schedule:
        Optional explicit fail/join timeline (:class:`ChurnSchedule`) replayed
        verbatim instead of sampling ``churn`` online -- the shared-epoch mode
        the differential tests run both backends on.  Mutually exclusive with
        ``churn``.
    controller:
        Optional :class:`OnlineReplanner`; fed observed task times, asked to
        replan after each job completes, and consulted at dispatch.
    scheduler:
        Placement policy name (``"fifo_gang"`` | ``"packed"`` |
        ``"balanced"``) or a :class:`~repro_torch.cluster.scheduler.Scheduler`
        instance.  The default keeps the legacy whole-cluster FIFO gang
        bit-compatibly; the space-sharing policies run queued jobs
        concurrently on disjoint worker subsets.
    workers_per_job:
        Engine-wide worker request per job under a space-sharing scheduler
        (``Job.plan.workers`` overrides it per job).  ``None`` means every
        job requests the whole alive set, which degenerates packed/balanced
        placement to gang-like serial execution.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        seed: int = 0,
        n_batches: Optional[int] = None,
        cancel_redundant: bool = False,
        size_dependent: bool = True,
        speeds: Optional[Sequence[float]] = None,
        churn: Optional[ChurnProcess] = None,
        churn_schedule: Optional[ChurnSchedule] = None,
        controller: Optional[OnlineReplanner] = None,
        speculation: Optional[Speculation] = None,
        speculation_times: Optional[Sequence[float]] = None,
        retry: Optional[Retry] = None,
        task_fail_script: Optional[Sequence[int]] = None,
        retry_times: Optional[Sequence[float]] = None,
        scheduler: "str | Scheduler" = "fifo_gang",
        workers_per_job: Optional[int] = None,
    ):
        # one validation path for every backend: the same Scenario.validate()
        # the epoch scan and the planner route through
        Scenario(
            speeds=speeds,
            churn=churn,
            churn_schedule=churn_schedule,
            speculation=speculation,
            retry=retry,
            scheduler=scheduler,
            workers_per_job=workers_per_job,
        ).validate(n_workers=n_workers, backend="python", controller=controller)
        if speculation_times is not None and speculation is None:
            raise ValueError(
                "speculation_times (scripted replay epochs) requires the "
                "speculation=Speculation(...) policy they were recorded under"
            )
        if retry_times is not None and retry is None:
            raise ValueError(
                "retry_times (scripted retry stamps) requires the "
                "retry=Retry(...) policy they were recorded under"
            )
        _scheduler = make_scheduler(scheduler)
        self.pool = WorkerPool(n_workers, speeds)
        self.rng = ev.RngStreams(seed)
        self.n_batches = n_batches
        self.cancel_redundant = cancel_redundant
        self.size_dependent = size_dependent
        self.churn = churn
        self.churn_schedule = churn_schedule
        self.controller = controller
        self.speculation = speculation
        self._spec = SpeculativePolicy(speculation) if speculation is not None else None
        # scripted mode (trace replay): launches happen at the recorded
        # stamps instead of the policy's self-armed heartbeat grid
        self._spec_script = tuple(speculation_times) if speculation_times is not None else None
        self._spec_seq = 0
        self._spec_armed_t = math.inf
        self._n_spec = 0
        # task-level failure semantics: which global dispatch indices raise
        # mid-payload (scripted from a trace's task_fail events), and the
        # recorded stamps at which failed replicas re-enter the rescue queue
        self.retry = retry
        self._task_fail_set = frozenset(int(i) for i in (task_fail_script or ()))
        self._retry_script = tuple(retry_times) if retry_times is not None else None
        self._dispatch_idx = 0
        self._attempts: Dict[tuple, int] = {}  # (job_id, batch) -> payload failures
        self._pending_retries: List[tuple] = []  # (release, seq, job_id, batch)
        self._retry_seq = 0
        self._retry_batches: Set[tuple] = set()  # rescue entries that are retries
        self._n_task_failures = 0
        self._n_retries = 0
        self.scheduler = _scheduler
        self.workers_per_job = None if workers_per_job is None else int(workers_per_job)

        self.events = ev.EventQueue()
        self.clock = ev.SimClock()
        self.queue: collections.deque = collections.deque()
        self.active: Dict[int, _JobExec] = {}
        self.rescue: collections.deque = collections.deque()  # (job_id, batch)
        self.records: List[JobRecord] = []

        self._worker_seconds = 0.0
        self._saved_seconds = 0.0
        # cumulative speed-weighted assigned load per worker (wall-clock
        # duration / speed, accrued at placement so the space lane can
        # replay it): the 'balanced' policy's load metric.  Dividing by speed makes
        # a slow worker accrue more load per batch than a fast one, so under
        # heterogeneous speeds the policy steers work toward fast workers
        # instead of treating equally-busy workers as equally attractive.
        self._load_w = [0.0] * n_workers
        self._n_failures = 0
        self._n_rescued = 0
        self._n_jobs_expected = 0
        self._epoch_times: List[float] = []  # applied churn events, in order
        self._ran = False

    # -- plan resolution ----------------------------------------------------

    def _choose_B(self, job: Job, n_avail: int) -> int:
        if job.plan is not None and job.plan.n_batches is not None:
            b = job.plan.n_batches
        elif self.controller is not None and self.controller.current is not None:
            b = self.controller.current.n_batches
        elif self.n_batches is not None:
            b = self.n_batches
        else:
            b = n_avail
        return max(1, min(int(b), n_avail))

    def _job_cancel(self, job: Job) -> bool:
        if job.plan is not None and job.plan.cancel_redundant is not None:
            return bool(job.plan.cancel_redundant)
        return self.cancel_redundant

    def _job_request(self, job: Job, n_alive: int) -> int:
        """Worker-subset size the job gets, clamped to the alive count
        (a job asking for more than is alive runs on what there is, exactly
        like the gang regime does)."""
        if job.plan is not None and job.plan.workers is not None:
            req = job.plan.workers
        elif self.workers_per_job is not None:
            req = self.workers_per_job
        else:
            req = n_alive
        return max(1, min(int(req), n_alive))

    def _allocated_wids(self) -> Set[int]:
        out: Set[int] = set()
        for jexec in self.active.values():
            if jexec.alloc is not None:
                out |= jexec.alloc
        return out

    # -- dispatch -----------------------------------------------------------

    def _assign(self, worker: Worker, jexec: _JobExec, batch: int) -> None:
        duration = draw_batch_time(
            jexec.job.dist,
            self.rng.get("service"),
            jexec.batch_tasks,
            worker.speed,
            self.size_dependent,
        )
        now = self.clock.now
        worker.assignment = (jexec.job.job_id, batch)
        worker.busy_since = now
        worker.scheduled_end = now + duration
        self._load_w[worker.wid] += duration / worker.speed
        jexec.outstanding.setdefault(batch, set()).add(worker.wid)
        # scripted task failures (trace replay): the k-th dispatch of the run
        # raises mid-payload instead of completing -- identified by its global
        # dispatch index, which live and replay agree on because dispatch
        # order IS decision order on both sides
        idx = self._dispatch_idx
        self._dispatch_idx += 1
        kind = ev.TASK_FAIL if idx in self._task_fail_set else ev.BATCH_DONE
        self.events.push(
            now + duration,
            kind,
            job_id=jexec.job.job_id,
            batch=batch,
            wid=worker.wid,
            epoch=worker.epoch,
        )

    def _try_dispatch(self) -> None:
        if not self.scheduler.space_sharing:
            # Whole-cluster FIFO gang scheduling: the next job starts once no
            # job is active and every alive worker is free (stragglers of the
            # previous job -- unless cancelled -- delay the next one:
            # redundancy's queueing cost, which cancellation reclaims).
            while self.queue and not self.active:
                n_alive = self.pool.n_alive()
                free = self.pool.free_workers()
                if n_alive == 0 or len(free) < n_alive:
                    return
                job = self.queue.popleft()
                b = self._choose_B(job, n_alive)
                r = n_alive // b
                jexec = _JobExec(
                    job=job,
                    start=self.clock.now,
                    n_batches=b,
                    replication=r,
                    cancel=self._job_cancel(job),
                )
                self.active[job.job_id] = jexec
                for idx, worker in enumerate(free[: b * r]):
                    self._assign(worker, jexec, idx % b)
            return
        # Space sharing: one first-fit pass over the FIFO queue -- every
        # queued job that fits on the currently free *unallocated* workers
        # starts now on its own disjoint subset (a narrow job may overtake a
        # wide head-of-line job that does not fit yet).  One pass suffices:
        # placements only consume eligible workers, so a job that did not
        # fit earlier in the pass cannot fit later in it.
        n_alive = self.pool.n_alive()
        if n_alive == 0:
            return
        allocated = self._allocated_wids()
        eligible = [w for w in self.pool.free_workers() if w.wid not in allocated]
        for job in list(self.queue):
            if not eligible:
                break  # nothing left to place
            req = self._job_request(job, n_alive)
            if len(eligible) < req:
                continue
            chosen = self.scheduler.select(req, eligible, self._load_w)
            b = self._choose_B(job, req)
            r = req // b
            jexec = _JobExec(
                job=job,
                start=self.clock.now,
                n_batches=b,
                replication=r,
                cancel=self._job_cancel(job),
                alloc={w.wid for w in chosen},
            )
            self.active[job.job_id] = jexec
            self.queue.remove(job)
            for idx, worker in enumerate(chosen[: b * r]):
                self._assign(worker, jexec, idx % b)
            taken = jexec.alloc
            eligible = [w for w in eligible if w.wid not in taken]

    def _assign_rescues(self) -> None:
        if not self.scheduler.space_sharing:
            while self.rescue:
                free = self.pool.free_workers()
                if not free:
                    return
                job_id, batch = self.rescue.popleft()
                jexec = self.active.get(job_id)
                if jexec is None or batch in jexec.done:
                    continue
                self._assign(free[0], jexec, batch)
                self._count_rescue(job_id, batch)
            return
        # Space sharing: serve the FIFO rescue queue without head-of-line
        # blocking across jobs (a blocked rescue must not starve another
        # job's rescue whose own workers are free -- that would deadlock).
        # Eligible workers are free workers still allocated to the job;
        # failing that, a free unallocated worker is *regranted* into the
        # allocation -- the churn-aware reassignment that restores a job
        # whose allocation shrank below its replica need.
        remaining = []
        allocated = self._allocated_wids()
        for job_id, batch in list(self.rescue):
            jexec = self.active.get(job_id)
            if jexec is None or batch in jexec.done:
                continue  # stale entry: the job or batch already finished
            free = self.pool.free_workers()
            own = [w for w in free if w.wid in jexec.alloc]
            if own:
                worker = self.scheduler.select(1, own, self._load_w)[0]
            else:
                outside = [w for w in free if w.wid not in allocated]
                if not outside:
                    remaining.append((job_id, batch))
                    continue
                worker = self.scheduler.select(1, outside, self._load_w)[0]
                jexec.alloc.add(worker.wid)
                allocated.add(worker.wid)
            self._assign(worker, jexec, batch)
            self._count_rescue(job_id, batch)
        self.rescue = collections.deque(remaining)

    def _count_rescue(self, job_id: int, batch: int) -> None:
        """A served rescue entry is either a retry re-dispatch (the replica's
        payload failed and its backoff expired) or a genuine churn rescue."""
        if (job_id, batch) in self._retry_batches:
            self._retry_batches.discard((job_id, batch))
            self._n_retries += 1
        else:
            self._n_rescued += 1

    # -- speculative backups (reactive replication) --------------------------

    def _spec_pick_worker(self, jexec: _JobExec):
        """The worker a backup for this job would take: lowest free wid under
        the gang regime; under space sharing the job's own free workers first,
        else a free unallocated worker *regranted* into the allocation (the
        same preference order rescues use).  Returns (worker, regrant)."""
        free = self.pool.free_workers()
        if not self.scheduler.space_sharing:
            return (free[0], False) if free else (None, False)
        own = [w for w in free if w.wid in jexec.alloc]
        if own:
            return self.scheduler.select(1, own, self._load_w)[0], False
        outside = [w for w in free if w.wid not in self._allocated_wids()]
        if outside:
            return self.scheduler.select(1, outside, self._load_w)[0], True
        return None, False

    def _next_spec_time(self) -> float:
        """Earliest heartbeat epoch at which some batch earns a backup.

        A pure function of the current state -- the epoch scan computes
        the identical formula on its replica vectors, which is what lets the
        differential tests demand exact agreement: for every active job with
        at least ``min_observations`` completed sibling durations, backup
        budget left, and a worker available to it, each unfinished batch's
        youngest in-flight replica crosses at ``start + theta x median``;
        the launch lands on the first heartbeat strictly after the crossing
        (or after now, when the crossing is already past).
        """
        cfg, pol = self.speculation, self._spec
        best = math.inf
        for job_id in sorted(self.active):
            jexec = self.active[job_id]
            if jexec.spec_used >= cfg.max_backups:
                continue
            med = pol.median(jexec.obs)
            if med is None:
                continue
            if self._spec_pick_worker(jexec)[0] is None:
                continue
            for batch, wids in jexec.outstanding.items():
                if batch in jexec.done or not wids:
                    continue
                y = max(self.pool[w].busy_since for w in wids)
                best = min(best, pol.next_epoch(y + cfg.theta * med, self.clock.now))
        return best

    def _arm_spec(self) -> None:
        """Re-arm the single outstanding SPEC_CHECK timer after a state
        change (classic DES timer pattern: a bumped seq invalidates any
        stale check already on the heap)."""
        t = self._next_spec_time()
        if t == self._spec_armed_t:
            return
        self._spec_seq += 1
        self._spec_armed_t = t
        if math.isfinite(t):
            self.events.push(t, ev.SPEC_CHECK, seq=self._spec_seq)

    def _on_spec_check(self, seq: Optional[int] = None, scripted: bool = False) -> None:
        """Launch at most ONE backup: the first lagging (job, batch) in sorted
        order.  One launch per check keeps every substrate aligned -- the
        scan applies one action per event step, and the live trace stamps each
        launch separately -- and the re-arm (next recorded stamp) picks up any
        remaining laggard at the next heartbeat epoch, identically everywhere.
        """
        cfg, pol = self.speculation, self._spec
        if not scripted:
            if seq != self._spec_seq:
                return  # stale timer: state changed since it was armed
            self._spec_armed_t = math.inf  # consumed; the loop re-arms
        now = self.clock.now
        for job_id in sorted(self.active):
            jexec = self.active[job_id]
            if jexec.spec_used >= cfg.max_backups:
                continue
            med = pol.median(jexec.obs)
            if med is None:
                continue
            for batch in sorted(jexec.outstanding):
                wids = jexec.outstanding[batch]
                if batch in jexec.done or not wids:
                    continue
                y = max(self.pool[w].busy_since for w in wids)
                if not pol.lagging(now - y, med):
                    continue
                worker, regrant = self._spec_pick_worker(jexec)
                if worker is None:
                    break
                if regrant:
                    jexec.alloc.add(worker.wid)
                self._assign(worker, jexec, batch)
                jexec.spec_used += 1
                self._n_spec += 1
                return
        if scripted:
            raise RuntimeError(
                "speculation replay diverged: the trace recorded a backup "
                f"launch at t={now} but no batch is eligible under the policy"
            )

    # -- event handlers -----------------------------------------------------

    def _release(self, worker: Worker) -> None:
        """Account busy time and mark the worker idle."""
        self._worker_seconds += self.clock.now - worker.busy_since
        worker.assignment = None
        worker.scheduled_end = math.inf

    def _on_batch_done(self, job_id: int, batch: int, wid: int, epoch: int) -> None:
        worker = self.pool[wid]
        if not worker.alive or worker.epoch != epoch or worker.assignment != (job_id, batch):
            return  # stale: the replica was cancelled or the worker failed
        jexec = self.active.get(job_id)
        if jexec is None:
            # the job already completed (earliest cover); this replica ran to
            # the end -- release the worker so the next job can gang-schedule
            self._release(worker)
            self._assign_rescues()
            self._try_dispatch()
            return
        now = self.clock.now
        duration = now - worker.busy_since
        self._release(worker)
        jexec.outstanding[batch].discard(wid)

        # a completed replica is a genuine service-time observation; with
        # cancellation only the batch winner completes, so tag it with the
        # number of replicas it raced (the replanner undoes the min-of-r bias)
        if self.controller is not None:
            tau = duration * worker.speed
            if self.size_dependent:
                tau /= jexec.batch_tasks
            censored = jexec.cancel and batch not in jexec.done
            n_rivals = len(jexec.outstanding[batch]) if censored else 0
            self.controller.observe(tau, n_competitors=1 + n_rivals)

        if batch not in jexec.done:
            jexec.done.add(batch)
            # the batch's first completion is a sibling-duration observation
            # for the speculative policy's running median
            jexec.obs.append(duration)
            if jexec.cancel:
                for sib_wid in sorted(jexec.outstanding[batch]):
                    sib = self.pool[sib_wid]
                    self._saved_seconds += sib.scheduled_end - now
                    sib.epoch += 1  # invalidate its in-flight BATCH_DONE
                    self._release(sib)
                jexec.outstanding[batch].clear()
            if jexec.complete:
                self._finish_job(jexec)
        self._assign_rescues()
        self._try_dispatch()

    def _finish_job(self, jexec: _JobExec) -> None:
        job = jexec.job
        self.records.append(
            JobRecord(
                job_id=job.job_id,
                name=job.name,
                arrival=job.arrival,
                start=jexec.start,
                finish=self.clock.now,
                n_batches=jexec.n_batches,
                replication=jexec.replication,
            )
        )
        del self.active[job.job_id]
        # drop rescues belonging to the finished job
        still_needed = [(j, b) for (j, b) in self.rescue if j != job.job_id]
        self.rescue = collections.deque(still_needed)
        self._drop_retry_state(job.job_id)
        if self.controller is not None:
            # future dispatches read controller.current
            self.controller.maybe_replan(self.pool.n_alive())

    def _drop_retry_state(self, job_id: int) -> None:
        self._pending_retries = [e for e in self._pending_retries if e[2] != job_id]
        self._retry_batches = {x for x in self._retry_batches if x[0] != job_id}

    def _on_task_fail(self, job_id: int, batch: int, wid: int, epoch: int) -> None:
        """A replica's payload raised: count the attempt, release the worker,
        and either arm a backoff retry or -- budget exhausted with no sibling
        running or pending -- abandon the job (record finish = inf)."""
        worker = self.pool[wid]
        if not worker.alive or worker.epoch != epoch or worker.assignment != (job_id, batch):
            return  # stale: the replica was cancelled or the worker failed
        self._n_task_failures += 1
        self._release(worker)
        jexec = self.active.get(job_id)
        if jexec is not None:
            jexec.outstanding[batch].discard(wid)
            if batch not in jexec.done:
                attempt = self._attempts.get((job_id, batch), 0) + 1
                self._attempts[(job_id, batch)] = attempt
                if self.retry is not None and attempt <= self.retry.max_attempts:
                    self._retry_seq += 1
                    self._pending_retries.append(
                        (self.clock.now + self.retry.backoff(attempt), self._retry_seq,
                         job_id, batch)
                    )
                elif not jexec.outstanding[batch] and not any(
                    j == job_id and b == batch for _, _, j, b in self._pending_retries
                ):
                    self._abandon_job(jexec)
        self._assign_rescues()
        self._try_dispatch()

    def _on_retry(self, scripted: bool = True) -> None:
        """Scripted retry (trace replay): the earliest-armed pending retry
        whose batch is still undone re-enters the rescue queue -- mirroring
        the live master's backoff timers, which fire in release order and
        no-op silently when the batch completed meanwhile."""
        valid = [
            e for e in self._pending_retries
            if e[2] in self.active and e[3] not in self.active[e[2]].done
        ]
        if not valid:
            raise RuntimeError(
                "retry replay diverged: the trace recorded a retry at "
                f"t={self.clock.now} but no failed replica is pending"
            )
        entry = min(valid)
        self._pending_retries.remove(entry)
        _, _, job_id, batch = entry
        self._retry_batches.add((job_id, batch))
        self.rescue.append((job_id, batch))
        self._assign_rescues()
        self._try_dispatch()

    def _abandon_job(self, jexec: _JobExec) -> None:
        """Retry budget exhausted with nothing in flight: the job can never
        cover all batches -- record it unfinished and free its state (any
        cross-batch stragglers keep running and release on completion)."""
        job = jexec.job
        self.records.append(
            JobRecord(
                job_id=job.job_id,
                name=job.name,
                arrival=job.arrival,
                start=jexec.start,
                finish=math.inf,
                n_batches=jexec.n_batches,
                replication=jexec.replication,
            )
        )
        del self.active[job.job_id]
        self.rescue = collections.deque((j, b) for (j, b) in self.rescue if j != job.job_id)
        self._drop_retry_state(job.job_id)

    def _schedule_failure(self, worker: Worker) -> None:
        if self.churn is None:
            return
        dt = self.churn.next_failure(self.rng.get("churn"))
        if math.isfinite(dt):
            when = self.clock.now + dt
            self.events.push(when, ev.WORKER_FAIL, wid=worker.wid, epoch=worker.churn_epoch)

    def _on_worker_fail(self, wid: int, epoch: int) -> None:
        worker = self.pool[wid]
        if not worker.alive or worker.churn_epoch != epoch:
            return  # stale failure (scheduled before an earlier fail/join)
        self._n_failures += 1
        self._epoch_times.append(self.clock.now)
        if worker.assignment is not None:
            job_id, batch = worker.assignment
            self._worker_seconds += self.clock.now - worker.busy_since
            jexec = self.active.get(job_id)
            if jexec is not None:
                jexec.outstanding[batch].discard(wid)
                if batch not in jexec.done and not jexec.outstanding[batch]:
                    # last replica of an unfinished batch died: rescue it
                    self.rescue.append((job_id, batch))
            worker.assignment = None
            worker.scheduled_end = math.inf
        # a failed worker leaves whatever allocation held it (space sharing):
        # the job recovers through rescue regrants, not by keeping dead wids
        for jexec in self.active.values():
            if jexec.alloc is not None:
                jexec.alloc.discard(wid)
        worker.alive = False
        worker.epoch += 1
        worker.churn_epoch += 1
        if self.churn is not None:
            down = self.churn.downtime(self.rng.get("churn"))
            if math.isfinite(down):
                self.events.push(
                    self.clock.now + down,
                    ev.WORKER_JOIN,
                    wid=wid,
                    epoch=worker.churn_epoch,
                )
        self._assign_rescues()
        self._try_dispatch()

    def _on_worker_join(self, wid: int, epoch: int) -> None:
        worker = self.pool[wid]
        if worker.alive or worker.churn_epoch != epoch:
            return
        self._epoch_times.append(self.clock.now)
        worker.alive = True
        worker.epoch += 1
        worker.churn_epoch += 1
        self._schedule_failure(worker)
        self._assign_rescues()
        self._try_dispatch()

    # -- main loop ----------------------------------------------------------

    def run(self, jobs: Sequence[Job], max_events: int = 2_000_000) -> EngineReport:
        """Execute ``jobs`` to completion and return the run report.

        Single-shot: clock, records, and churn state persist after a run, so
        reusing the engine would mix workloads -- construct a new one.
        """
        if self._ran:
            raise RuntimeError("ClusterEngine.run() is single-shot; construct a new engine")
        self._ran = True
        self._n_jobs_expected = len(jobs)
        for job in jobs:
            self.events.push(job.arrival, ev.JOB_ARRIVAL, job=job)
        for worker in self.pool:
            self._schedule_failure(worker)
        if self._spec_script is not None:
            # trace replay: launches happen at the recorded stamps; the
            # engine re-derives which batch and which worker from the policy
            for t in self._spec_script:
                self.events.push(t, ev.SPEC_CHECK, scripted=True)
        if self._retry_script is not None:
            for t in self._retry_script:
                self.events.push(t, ev.RETRY, scripted=True)
        if self.churn_schedule is not None:
            # replay the explicit timeline: the k-th event of worker w expects
            # churn_epoch k (transitions are schedule-driven only, so the
            # staleness guards see exactly the epoch they were tagged with)
            per_worker: Dict[int, int] = {}
            sched = self.churn_schedule
            for t, wid, up in zip(sched.times, sched.wids, sched.ups):
                epoch = per_worker.get(wid, 0)
                kind = ev.WORKER_JOIN if up else ev.WORKER_FAIL
                self.events.push(t, kind, wid=wid, epoch=epoch)
                per_worker[wid] = epoch + 1

        n_events = 0
        while self.events and n_events < max_events:
            if len(self.records) == self._n_jobs_expected:
                break  # only churn noise remains
            t, kind, payload = self.events.pop()
            self.clock.advance(t)
            n_events += 1
            if kind == ev.JOB_ARRIVAL:
                self.queue.append(payload["job"])
                # rescues get first pick of free capacity even at arrivals
                # (a no-op under fifo_gang: rescues pending implies no free
                # worker here); keeps the space-sharing invariant that a
                # dispatch never overtakes a serviceable rescue
                self._assign_rescues()
                self._try_dispatch()
            elif kind == ev.BATCH_DONE:
                self._on_batch_done(**payload)
            elif kind == ev.WORKER_FAIL:
                self._on_worker_fail(**payload)
            elif kind == ev.WORKER_JOIN:
                self._on_worker_join(**payload)
            elif kind == ev.SPEC_CHECK:
                self._on_spec_check(**payload)
            elif kind == ev.TASK_FAIL:
                self._on_task_fail(**payload)
            elif kind == ev.RETRY:
                self._on_retry(**payload)
            else:  # pragma: no cover - no other kinds are ever pushed
                raise RuntimeError(f"unknown event kind {kind!r}")
            if self._spec is not None and self._spec_script is None:
                self._arm_spec()

        # flush replicas still in flight: their full duration is committed
        # worker time (it will burn whether or not we simulate it), which
        # keeps the invariant  ws(cancel on) + saved == ws(cancel off)
        for worker in self.pool:
            if worker.alive and worker.assignment is not None:
                self._worker_seconds += worker.scheduled_end - worker.busy_since
                worker.assignment = None
                worker.scheduled_end = math.inf

        # jobs that never completed (cluster died / event budget exhausted)
        for jexec in list(self.active.values()):
            job = jexec.job
            self.records.append(
                JobRecord(
                    job_id=job.job_id,
                    name=job.name,
                    arrival=job.arrival,
                    start=jexec.start,
                    finish=math.inf,
                    n_batches=jexec.n_batches,
                    replication=jexec.replication,
                )
            )
        for job in self.queue:
            self.records.append(
                JobRecord(
                    job_id=job.job_id,
                    name=job.name,
                    arrival=job.arrival,
                    start=math.inf,
                    finish=math.inf,
                    n_batches=0,
                    replication=0,
                )
            )
        self.records.sort(key=lambda r: r.job_id)

        last_b = self.records[-1].n_batches if self.records else 0
        return EngineReport(
            records=self.records,
            worker_seconds=self._worker_seconds,
            cancelled_seconds_saved=self._saved_seconds,
            n_events=n_events,
            n_worker_failures=self._n_failures,
            n_replicas_rescued=self._n_rescued,
            n_replans=len(self.controller.history) if self.controller else 0,
            final_n_batches=last_b,
            epoch_times=tuple(self._epoch_times),
            n_speculative=self._n_spec,
            n_task_failures=self._n_task_failures,
            n_retries=self._n_retries,
        )


# --------------------------------------------------------------------------
# conveniences: i.i.d. sampling and trace-driven workloads
# --------------------------------------------------------------------------


def sample_job_times(
    dist: Optional[ServiceTime] = None,
    n_workers: Optional[int] = None,
    n_batches: Optional[int] = None,
    n_samples: Optional[int] = None,
    *,
    seed: int = 0,
    size_dependent=UNSET,
    cancel_redundant=UNSET,
    n_tasks=UNSET,
    backend: str = "torch",
    speeds=UNSET,
    churn=UNSET,
    churn_schedule=UNSET,
    controller: Optional[OnlineReplanner] = None,
    replan=UNSET,
    speculation=UNSET,
    scheduler=UNSET,
    workers_per_job=UNSET,
    job_plans=UNSET,
    churn_pairs_per_worker=UNSET,
    dtype=UNSET,
    rep_chunk=UNSET,
    devices=UNSET,
    scenario=None,
    device=None,
) -> np.ndarray:
    """Job compute-time samples from the engine (i.i.d. when the cluster is
    static; correlated through the shared churn timeline otherwise).

    ``backend="torch"`` (the default) draws the statistic on ``device``
    (default: the CUDA card, raising without one; ``"cpu"`` runs it on the
    host): :func:`repro_torch.cluster.vectorized.frontier_job_times` for the
    static case, or the epoch scan
    (:func:`repro_torch.cluster.epoch_scan.simulate_epochs`) once any dynamic
    knob -- ``speeds``, ``churn``, ``churn_schedule``, ``replan``,
    ``speculation`` -- or any space knob is set.  The reference's
    ``backend="jax"`` is this ``backend="torch"``.  ``backend="python"``
    asks for one event-driven engine on the host (numpy, takes no
    ``device``) with ``n_samples`` identical jobs queued at t=0: under
    whole-cluster FIFO scheduling they execute serially, the engine-side
    analogue of ``simulate_balanced``.

    ``controller`` (an :class:`OnlineReplanner`) drives the engine;
    ``replan`` (a :class:`~repro_torch.cluster.epoch_scan.ReplanConfig`)
    drives either backend.  ``dtype`` / ``rep_chunk`` / ``devices`` apply to
    the epoch scan only.

    ``scheduler`` / ``workers_per_job`` / ``job_plans`` run the stream under
    space sharing on both backends: jobs execute concurrently on disjoint
    worker subsets, each under its own
    :class:`~repro_torch.cluster.scheduler.JobPlan` (``job_plans`` cycles
    over the stream; unset fields inherit ``n_batches`` /
    ``cancel_redundant`` / ``workers_per_job``).

    Churn-horizon note: the epoch scan samples ``churn`` as a finite stream
    of ``churn_pairs_per_worker`` fail/join pairs per worker (each worker
    then stays up), while the engine samples churn for the whole run; a
    ``churn_schedule`` is replayed identically by both.

    The scenario knobs are best passed as one validated
    ``scenario=Scenario(...)`` (which may also carry ``dist`` /
    ``n_workers`` / ``n_batches``); the loose keyword forms keep working
    behind a :class:`DeprecationWarning` shim.
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
        where="sample_job_times",
    )
    dist = dist if dist is not None else sc.dist
    n_batches = n_batches if n_batches is not None else sc.n_batches
    if dist is None or (n_workers is None and sc.n_workers is None) or n_samples is None:
        raise ValueError(
            "sample_job_times needs dist, n_workers (or scenario fields), and n_samples"
        )
    n_workers = int(n_workers if n_workers is not None else sc.n_workers)
    if backend == "torch":
        if controller is not None:
            raise ValueError("backend='torch' takes replan=ReplanConfig(...), not controller")
        if sc.is_dynamic or sc.is_space:
            from .epoch_scan import simulate_epochs

            rep = simulate_epochs(
                dist,
                n_workers,
                n_batches,
                np.zeros(n_samples),
                1,
                seed=seed,
                scenario=sc,
                device=device,
            )
            return rep.compute_times[0]
        sc.validate(n_workers=n_workers, backend="torch")
        from .vectorized import frontier_job_times

        return frontier_job_times(
            dist,
            n_workers,
            [n_batches],
            n_samples,
            seed=seed,
            size_dependent=sc.size_dependent,
            n_tasks=sc.n_tasks,
            device=device,
        )[0]
    if backend != "python":
        raise ValueError(f"unknown backend {backend!r} (expected 'torch' or 'python')")
    if device is not None:
        raise ValueError("backend='python' runs the engine on the host and takes no device")
    sc.validate(n_workers=n_workers, backend="python", controller=controller)
    if controller is None and sc.replan is not None:
        controller = sc.replan.to_controller(n_workers)
    jobs = [
        Job(
            job_id=i,
            dist=dist,
            n_tasks=sc.n_tasks if sc.n_tasks is not None else n_workers,
            plan=sc.job_plan_for(i),
        )
        for i in range(n_samples)
    ]
    engine_kwargs = sc.to_engine_kwargs(n_workers)
    engine_kwargs["n_batches"] = n_batches
    engine_kwargs["controller"] = controller
    engine = ClusterEngine(n_workers, seed=seed, **engine_kwargs)
    report = engine.run(jobs)
    return report.compute_times


def jobs_from_traces(
    trace_jobs,
    n_tasks: int,
    arrival_rate: float,
    seed: int = 0,
) -> List[Job]:
    """§VII trace jobs -> a Poisson-arrival workload for the engine.

    Each :class:`~repro_torch.core.traces.TraceJob` becomes one engine job whose
    task service times resample the trace's empirical distribution.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Job] = []
    for i, tj in enumerate(trace_jobs):
        t += float(rng.exponential(1.0 / arrival_rate))
        out.append(
            Job(
                job_id=i,
                dist=Empirical(samples=tuple(float(x) for x in tj.task_times)),
                n_tasks=n_tasks,
                arrival=t,
                name=tj.name,
            )
        )
    return out
