"""Worker-side state: per-worker service draws, speeds, and churn processes.

A numpy copy of ``repro.cluster.workers``, which
:mod:`repro_torch.cluster.scenario` needs; equal seeds give identical churn
schedules and draws in both packages.

A worker executes one batch replica at a time.  Its service time for a batch
of ``s`` tasks is ``s * tau / speed`` under the paper's §VI size-dependent
model (``tau / speed`` under the §IV batch-level model), with ``tau`` drawn
from the job's :class:`~repro_torch.core.service_time.ServiceTime` distribution.
Heterogeneous clusters set per-worker ``speed`` factors; time-varying
stragglers are modeled by the fail/join churn process (a straggling worker is
a worker that leaves and later rejoins).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.service_time import ServiceTime

__all__ = [
    "Worker",
    "WorkerPool",
    "ChurnProcess",
    "ChurnSchedule",
    "sample_churn_schedule",
    "draw_batch_time",
]


@dataclasses.dataclass
class Worker:
    """Mutable execution state for one worker."""

    wid: int
    speed: float = 1.0
    alive: bool = True
    # (job_id, batch) currently executing; None when idle
    assignment: Optional[Tuple[int, int]] = None
    # epoch is bumped on cancellation/failure; in-flight BATCH_DONE events
    # carry the epoch they were scheduled under and are dropped on mismatch
    epoch: int = 0
    # churn_epoch tracks alive/dead transitions only -- WORKER_FAIL/JOIN
    # events check it, so cancelling a replica (which bumps ``epoch``) does
    # not invalidate the worker's pending failure event
    churn_epoch: int = 0
    busy_since: float = 0.0
    scheduled_end: float = math.inf

    @property
    def free(self) -> bool:
        """Alive and not currently assigned a replica."""
        return self.alive and self.assignment is None


class WorkerPool:
    """The cluster's worker set (possibly heterogeneous speeds)."""

    def __init__(self, n_workers: int, speeds: Optional[Sequence[float]] = None):
        if speeds is None:
            speeds = [1.0] * n_workers
        if len(speeds) != n_workers:
            raise ValueError("speeds must have one entry per worker")
        self.workers = [Worker(wid=i, speed=float(s)) for i, s in enumerate(speeds)]

    def __getitem__(self, wid: int) -> Worker:
        return self.workers[wid]

    def __iter__(self):
        return iter(self.workers)

    def __len__(self) -> int:
        return len(self.workers)

    def free_workers(self) -> list:
        """Workers currently free, in wid order."""
        return [w for w in self.workers if w.free]

    def n_alive(self) -> int:
        """How many workers are currently alive."""
        return sum(1 for w in self.workers if w.alive)


@dataclasses.dataclass(frozen=True)
class ChurnProcess:
    """Fail/join dynamics: exponential failure hazard + exponential downtime.

    ``fail_rate`` is the per-alive-worker failure rate; ``mean_downtime`` is
    the mean time a failed worker stays away before rejoining (0 disables
    rejoin: failures are permanent departures).
    """

    fail_rate: float = 0.0
    mean_downtime: float = 0.0

    def next_failure(self, rng: np.random.Generator) -> float:
        """Draw the time until this worker's next failure."""
        if self.fail_rate <= 0.0:
            return math.inf
        return float(rng.exponential(1.0 / self.fail_rate))

    def downtime(self, rng: np.random.Generator) -> float:
        """Draw how long a failed worker stays away before rejoining."""
        if self.mean_downtime <= 0.0:
            return math.inf
        return float(rng.exponential(self.mean_downtime))


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """An explicit, replayable fail/join timeline (the cluster's churn *epochs*).

    Where :class:`ChurnProcess` describes churn as a stochastic law that the
    engine samples while it runs, a schedule pins the realization: event k
    flips worker ``wids[k]`` down (``ups[k]`` False) or up (True) at
    ``times[k]``.  Both backends replay the same schedule -- the event engine
    pushes the events onto its heap, the jax epoch-scan ``lax.scan``s over
    them -- which is what lets the differential test harness compare churned
    runs across backends on a shared timeline.

    Per worker the events must alternate fail/join starting from alive, and
    ``times`` must be globally sorted (ties allowed).
    """

    times: tuple
    wids: tuple
    ups: tuple

    def __post_init__(self):
        if not (len(self.times) == len(self.wids) == len(self.ups)):
            raise ValueError("times/wids/ups must have equal length")
        if any(t2 < t1 for t1, t2 in zip(self.times, self.times[1:])):
            raise ValueError("schedule times must be sorted")
        state: dict = {}
        for t, w, up in zip(self.times, self.wids, self.ups):
            if t < 0 or not math.isfinite(t):
                raise ValueError(f"event times must be finite and >= 0, got {t}")
            if bool(up) == state.get(w, True):
                raise ValueError(f"worker {w}: fail/join events must alternate from alive")
            state[w] = bool(up)

    def __len__(self) -> int:
        return len(self.times)


def sample_churn_schedule(
    churn: ChurnProcess,
    n_workers: int,
    rng: np.random.Generator,
    pairs_per_worker: int = 8,
) -> ChurnSchedule:
    """One realization of ``churn``: the alternating-renewal timeline per worker.

    Each worker alternates up ~ Exp(fail_rate) and down ~ Exp(mean_downtime)
    intervals, exactly the law :class:`~repro.cluster.master.ClusterEngine`
    samples online; after ``pairs_per_worker`` fail/join pairs the worker
    stays up (the truncation both backends then share).  Zero ``fail_rate``
    yields an empty schedule; zero ``mean_downtime`` makes failures permanent
    (the join of each pair lands at infinity and is dropped).
    """
    events: list = []
    for w in range(n_workers):
        t = 0.0
        for _ in range(pairs_per_worker):
            up = churn.next_failure(rng)
            if not math.isfinite(up):
                break
            t += up
            events.append((t, w, False))
            down = churn.downtime(rng)
            if not math.isfinite(down):
                break
            t += down
            events.append((t, w, True))
    events.sort()
    return ChurnSchedule(
        times=tuple(e[0] for e in events),
        wids=tuple(e[1] for e in events),
        ups=tuple(e[2] for e in events),
    )


def draw_batch_time(
    dist: ServiceTime,
    rng: np.random.Generator,
    batch_tasks: float,
    speed: float,
    size_dependent: bool,
) -> float:
    """One replica's wall-clock time for a batch of ``batch_tasks`` tasks."""
    tau = float(np.asarray(dist.sample_np(rng, ())))
    work = tau * batch_tasks if size_dependent else tau
    return work / speed
