"""The cluster engine's semantics, executed (port of ``repro.cluster``).

Public surface ported so far:
  * scenario   -- the one frozen, validated spec shared by every entry point
  * scheduler  -- placement policies and per-job ``JobPlan`` overrides
  * workers    -- Worker/WorkerPool, ChurnProcess, ChurnSchedule
  * vectorized -- batched torch replay of the static engine semantics:
    whole-frontier candidate scoring (``frontier_job_times``) and FIFO
    queueing (``simulate_fifo``), the path behind ``plan_cluster`` /
    ``plan_sweep``, and the stream slab
  * stream     -- trace-scale streaming (``simulate_stream``) with on-device
    response statistics, the path behind ``plan_slo``
  * control    -- OnlineReplanner (sliding-window refit + replan) and
    SpeculativePolicy, the oracles of the epoch scan's adaptive policies
  * epoch_scan -- the epoch scan's gang lane: churn, replica rescue,
    heterogeneous speeds, FIFO gang dispatch, the in-scan replanner
    (``ReplanConfig``) and speculative backups (``simulate_epochs``, with
    ``outputs="stream"`` folding to an ``EpochStreamReport``), and
    whole-frontier scoring of dynamic scenarios
    (``frontier_job_times_dynamic``), the path behind a dynamic
    ``plan_cluster`` and ``plan_slo``

The epoch scan's space lane, the DES engine and the live runtime come with
later slices (``ROADMAP.md``).
"""
# core first: its __init__ re-exports cluster.scenario, whose workers import
# core.service_time, so entering through cluster would meet a half-built core
from .. import core  # noqa: F401
from . import control, epoch_scan, scenario, scheduler, stream, vectorized, workers
from .control import OnlineReplanner, SpeculativePolicy
from .epoch_scan import (
    EpochReport,
    EpochStreamReport,
    ReplanConfig,
    frontier_job_times_dynamic,
    simulate_epochs,
)
from .scenario import SLO, FaultPlan, Retry, Scenario, Speculation
from .scheduler import JobPlan, Scheduler, make_scheduler
from .stream import (
    StreamFullReport,
    StreamStats,
    epoch_stream_stats,
    fold_stream_stats,
    simulate_stream,
)
from .vectorized import (
    STREAM_HIST_BINS,
    STREAM_HIST_EDGES,
    STREAM_QUANTILE_RTOL,
    FifoReport,
    frontier_job_times,
    simulate_fifo,
)
from .workers import ChurnProcess, ChurnSchedule, Worker, WorkerPool, sample_churn_schedule

__all__ = [
    "control",
    "epoch_scan",
    "scenario",
    "scheduler",
    "stream",
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
    "OnlineReplanner",
    "SpeculativePolicy",
    "EpochReport",
    "EpochStreamReport",
    "ReplanConfig",
    "simulate_epochs",
    "frontier_job_times_dynamic",
    "FifoReport",
    "frontier_job_times",
    "simulate_fifo",
    "STREAM_HIST_BINS",
    "STREAM_HIST_EDGES",
    "STREAM_QUANTILE_RTOL",
    "StreamFullReport",
    "StreamStats",
    "fold_stream_stats",
    "epoch_stream_stats",
    "simulate_stream",
    "ChurnProcess",
    "ChurnSchedule",
    "Worker",
    "WorkerPool",
    "sample_churn_schedule",
]
