"""Space-sharing schedulers: pluggable job-to-worker placement policies.

A copy of ``repro.cluster.scheduler`` (pure Python).  The event engine
(:mod:`repro_torch.cluster.master`) runs these policies, and the epoch
scan's space lane (:mod:`repro_torch.cluster.epoch_scan`) replays them on
the device.

The engine's original (and still default) regime is the whole-cluster FIFO
gang: one job at a time, dispatched once every alive worker is free.  That is
the one scheduling regime in which redundancy levels *cannot* differ across
concurrent jobs -- the paper's balanced-assignment results are per job, and
the interesting trade-offs (Aktas & Soljanin, arXiv:1906.05345; the
task-assignment companion, arXiv:1808.02838) appear exactly when jobs share
the cluster under different (B, r) plans.

A :class:`Scheduler` decides which queued jobs start and on which workers.
Space-sharing policies place each job on a *disjoint* worker subset of
``workers_per_job`` workers (requested per job via :class:`JobPlan`, or
engine-wide), so jobs with heterogeneous redundancy plans run concurrently:

* ``fifo_gang``  -- the legacy whole-cluster gang (no space sharing); kept
  bit-compatible with the pre-scheduler engine on the same seeds.
* ``packed``     -- first-fit: scan the FIFO queue, place every job that
  fits on the lowest-wid free workers.  Packs the cluster tightly and lets
  later narrow jobs overtake a wide head-of-line job that does not fit yet.
* ``balanced``   -- same first-fit admission, but workers are chosen by
  least cumulative *speed-weighted* assigned load (ties by wid), spreading
  load across the pool instead of hammering the low wids.

"Least loaded" is deliberately measured as cumulative assigned duration
divided by the worker's speed (accrued when a replica is placed, not when
it finishes): the jax epoch scan replays placement decisions out of the
event loop, and an accrue-at-assignment metric is exactly reproducible
there, where accrue-at-release would depend on commit order within an
epoch.  The speed weighting makes heterogeneous clusters behave: a slow
worker accrues more load per placed replica than a fast one, so the policy
steers work toward fast workers instead of piling it on slow ones (with
homogeneous speeds the metric reduces to plain assigned wall-clock).

Per-job plans: a :class:`JobPlan` attached to a
:class:`~repro.cluster.master.Job` overrides any of (worker request, B,
cancellation mode) for that job; unset fields inherit the engine-wide
defaults.  The engine clamps requests to the alive-worker count and B to the
granted allocation, mirroring the gang engine's clamping.

Churn-aware reassignment: allocations shrink when an allocated worker fails.
A batch that lost its last replica queues a rescue; rescues are served first
from free workers still allocated to the job, and otherwise *regrant* a free
unallocated worker into the allocation -- so a job whose allocation fell
below its replica need recovers as capacity frees, without stealing busy
workers from its neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

__all__ = [
    "JobPlan",
    "Scheduler",
    "FifoGangScheduler",
    "PackedScheduler",
    "BalancedScheduler",
    "SCHEDULERS",
    "make_scheduler",
]


@dataclasses.dataclass(frozen=True)
class JobPlan:
    """Per-job overrides of the engine-wide plan (None = inherit).

    ``workers`` is the size of the disjoint worker subset the job requests
    under a space-sharing scheduler; ``n_batches`` and ``cancel_redundant``
    are the job's own redundancy level and cancellation mode -- the per-job
    heterogeneous (B, r) plans the gang regime cannot express.
    """

    workers: Optional[int] = None
    n_batches: Optional[int] = None
    cancel_redundant: Optional[bool] = None

    def __post_init__(self):
        if self.workers is not None and self.workers < 1:
            raise ValueError(f"JobPlan.workers must be >= 1, got {self.workers}")
        if self.n_batches is not None and self.n_batches < 1:
            raise ValueError(f"JobPlan.n_batches must be >= 1, got {self.n_batches}")


class Scheduler:
    """Placement policy: which free workers a job (or rescue) gets.

    ``space_sharing`` distinguishes the two dispatch regimes the engine
    implements: ``False`` runs the legacy whole-cluster FIFO gang loop,
    ``True`` runs first-fit queue scans onto disjoint per-job allocations.
    ``select`` returns ``k`` workers from ``free`` in *placement order* --
    the engine assigns batch ``i % B`` to the i-th returned worker, so the
    order is part of the policy's semantics (and is mirrored by the jax
    space lane).
    """

    name: str = "base"
    space_sharing: bool = True

    def select(self, k: int, free: Sequence, load: Sequence[float]) -> List:
        """Pick ``k`` of the ``free`` workers for the next job."""
        raise NotImplementedError


class FifoGangScheduler(Scheduler):
    """Whole-cluster FIFO gang: the legacy (default) regime."""

    name = "fifo_gang"
    space_sharing = False

    def select(self, k: int, free: Sequence, load: Sequence[float]) -> List:
        """Pick ``k`` of the ``free`` workers for the next job."""
        return list(free[:k])


class PackedScheduler(Scheduler):
    """First-fit packing onto the lowest-wid free workers."""

    name = "packed"
    space_sharing = True

    def select(self, k: int, free: Sequence, load: Sequence[float]) -> List:
        """Pick ``k`` of the ``free`` workers for the next job."""
        return list(free[:k])  # free lists are wid-ordered


class BalancedScheduler(Scheduler):
    """Least-loaded placement: least speed-weighted assigned load, ties by wid."""

    name = "balanced"
    space_sharing = True

    def select(self, k: int, free: Sequence, load: Sequence[float]) -> List:
        """Pick ``k`` of the ``free`` workers for the next job."""
        return sorted(free, key=lambda w: (load[w.wid], w.wid))[:k]


SCHEDULERS = {
    "fifo_gang": FifoGangScheduler,
    "packed": PackedScheduler,
    "balanced": BalancedScheduler,
}


def make_scheduler(spec: Union[str, Scheduler]) -> Scheduler:
    """Resolve a policy name (or pass a Scheduler instance through)."""
    if isinstance(spec, Scheduler):
        return spec
    try:
        return SCHEDULERS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler {spec!r} (expected one of {sorted(SCHEDULERS)})"
        ) from None


def is_space(scheduler, workers_per_job, job_plans) -> bool:
    """Whether any space-sharing knob is set (the shared routing predicate).

    The array backends use it to pick the space lane over the gang lane;
    keeping it here, next to the policy registry, means a future knob
    changes the routing in exactly one place.  Note
    ``fifo_gang`` *with* per-job plans still counts as space routing -- the
    gang regime then runs on the space lane so per-job B/cancellation apply.
    """
    return (
        scheduler not in (None, "fifo_gang")
        or workers_per_job is not None
        or job_plans is not None
    )
