"""Replicated data parallelism: the paper's policy as a mesh factorization.

A ``RedundancyPlan`` (B shards x r replicas over N = B*r data-parallel
groups) maps onto the mesh by splitting the data axis into
("replica", "shard").  Because every replica group consumes the *same*
shard (balanced non-overlapping assignment), psum over both axes equals
plain DP -- but the system gains:

  * fault tolerance: losing any worker of a replica group loses no data
    shard and no gradient contribution (the group's siblings carry it);
  * first-of-r semantics: a multi-controller deployment can proceed on the
    fastest member of each group (T = max_B min_r -- the paper's job time);
  * elastic replanning: on membership change, the planner re-picks (B, r)
    from the measured step-time distribution and only the mesh factorization
    changes -- data placement is counter-deterministic (see data.pipeline).

Port of ``repro.distributed.rdp``: ``make_rdp_mesh`` builds the
("replica", "shard", "model") ``DeviceMesh`` (``launch/mesh.py``); the host
part (``assignment_matrix``, ``surviving_coverage``, ``Transition``,
``ElasticController``) is numpy over the port's ``core.batching`` and
``RedundancyPlanner``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core import batching
from ..core.planner import RedundancyPlan, RedundancyPlanner
from ..core.service_time import ServiceTime
from ..launch.mesh import make_replicated_mesh

__all__ = ["ElasticController", "Transition", "assignment_matrix", "make_rdp_mesh",
           "surviving_coverage"]


def make_rdp_mesh(plan: RedundancyPlan, model_parallel: int, device_type=None):
    """Mesh ("replica", "shard", "model") realizing a replication plan."""
    return make_replicated_mesh(plan.replication, plan.n_batches, model_parallel, device_type)


def assignment_matrix(plan: RedundancyPlan) -> np.ndarray:
    """(N workers x B shards) membership of the balanced policy."""
    return batching.non_overlapping(
        n_tasks=plan.n_batches * plan.replication,
        n_batches=plan.n_batches,
        n_workers=plan.n_workers,
    )


def surviving_coverage(plan: RedundancyPlan, healthy: Sequence[bool]) -> dict:
    """After failures, which shards still have >= 1 replica?

    Returns {"covered": bool, "replicas_per_shard": [..], "lost_shards": [..]}.
    """
    healthy = np.asarray(healthy, dtype=bool)
    if healthy.shape[0] != plan.n_workers:
        raise ValueError(f"expected {plan.n_workers} health flags, got {healthy.shape[0]}")
    shard_of = np.arange(plan.n_workers) % plan.n_batches
    reps = np.zeros(plan.n_batches, dtype=np.int64)
    np.add.at(reps, shard_of[healthy], 1)
    lost = np.flatnonzero(reps == 0).tolist()
    return {
        "covered": not lost,
        "replicas_per_shard": reps.tolist(),
        "lost_shards": lost,
    }


@dataclasses.dataclass(frozen=True)
class Transition:
    old_plan: RedundancyPlan
    new_plan: RedundancyPlan
    reason: str

    @property
    def mesh_change(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        return (
            (self.old_plan.replication, self.old_plan.n_batches),
            (self.new_plan.replication, self.new_plan.n_batches),
        )


class ElasticController:
    """Replans (B, r) on membership changes using the paper's planner.

    The controller is given the fitted/assumed step service-time model; on
    worker loss it picks the best feasible plan for the surviving count.
    A step-time observer can also trigger replanning when the fitted
    distribution drifts (straggler onset).
    """

    def __init__(self, dist: ServiceTime, objective: str = "mean"):
        self.dist = dist
        self.objective = objective

    def initial_plan(self, n_workers: int) -> RedundancyPlan:
        return RedundancyPlanner(n_workers).plan(self.dist, self.objective)

    def on_membership_change(
        self, plan: RedundancyPlan, n_healthy: int, reason: str = "failure"
    ) -> Optional[Transition]:
        if n_healthy == plan.n_workers:
            return None
        new_plan = RedundancyPlanner(n_healthy).plan(self.dist, self.objective)
        return Transition(old_plan=plan, new_plan=new_plan, reason=reason)

    def on_observed_step_times(
        self, plan: RedundancyPlan, samples: np.ndarray, refit_threshold: float = 0.2
    ) -> Optional[Transition]:
        """Refit the service-time distribution from observed per-worker step
        times; replan if the optimal B moved by more than ``refit_threshold``."""
        planner = RedundancyPlanner(plan.n_workers)
        new_plan = planner.plan_auto(samples, self.objective)
        rel = abs(new_plan.n_batches - plan.n_batches) / max(plan.n_batches, 1)
        if rel > refit_threshold:
            return Transition(old_plan=plan, new_plan=new_plan, reason="drift")
        return None
