"""The cluster engine's semantics, executed (port of ``repro.cluster``).

Public surface ported so far:
  * scenario   -- the one frozen, validated spec shared by every entry point
  * scheduler  -- placement policies and per-job ``JobPlan`` overrides
  * workers    -- Worker/WorkerPool, ChurnProcess, ChurnSchedule
  * vectorized -- batched torch replay of the static engine semantics:
    whole-frontier candidate scoring (``frontier_job_times``) and FIFO
    queueing (``simulate_fifo``), the path behind ``plan_cluster`` /
    ``plan_sweep``

The epoch scan, the stream slab, the DES engine and the live runtime come
with later slices (``ROADMAP.md``).
"""
from . import scenario, scheduler, vectorized, workers
from .scenario import SLO, FaultPlan, Retry, Scenario, Speculation
from .scheduler import JobPlan, Scheduler, make_scheduler
from .vectorized import FifoReport, frontier_job_times, simulate_fifo
from .workers import ChurnProcess, ChurnSchedule, Worker, WorkerPool, sample_churn_schedule

__all__ = [
    "scenario",
    "scheduler",
    "vectorized",
    "workers",
    "FaultPlan",
    "Retry",
    "SLO",
    "Scenario",
    "Speculation",
    "JobPlan",
    "Scheduler",
    "make_scheduler",
    "FifoReport",
    "frontier_job_times",
    "simulate_fifo",
    "ChurnProcess",
    "ChurnSchedule",
    "Worker",
    "WorkerPool",
    "sample_churn_schedule",
]
