"""The cluster engine's semantics, executed (port of ``repro.cluster``).

Public surface ported so far:
  * scenario   -- the one frozen, validated spec shared by every entry point
  * scheduler  -- placement policies and per-job ``JobPlan`` overrides
  * workers    -- Worker/WorkerPool, ChurnProcess, ChurnSchedule
  * events     -- event heap, simulation clock, named RNG streams
  * master     -- the event-driven engine, a host numpy copy of the
    reference's: ``Job`` / ``JobRecord`` / ``EngineReport``,
    ``ClusterEngine`` (churn, rescue, cancellation, speeds, the
    ``OnlineReplanner`` controller, speculation, ``Retry``, the space
    schedulers with per-job ``JobPlan`` s), ``sample_job_times`` (by
    default the frontier and the epoch scan on the card, or
    ``backend="python"``: the engine on the host) and
    ``jobs_from_traces``; the path behind ``plan_cluster(backend="python")``
  * vectorized -- batched torch replay of the static engine semantics:
    whole-frontier candidate scoring (``frontier_job_times``) and FIFO
    queueing (``simulate_fifo``, whose space knobs delegate to the epoch
    scan's space lane), the path behind ``plan_cluster`` / ``plan_sweep``,
    and the stream slab
  * stream     -- trace-scale streaming (``simulate_stream``) with on-device
    response statistics, the path behind ``plan_slo``
  * control    -- OnlineReplanner (sliding-window refit + replan) and
    SpeculativePolicy, the engine's controllers and the oracles of the
    epoch scan's adaptive policies
  * epoch_scan -- the epoch scan: the gang lane (churn, replica rescue,
    heterogeneous speeds, FIFO gang dispatch, the in-scan replanner
    ``ReplanConfig`` and speculative backups) and the space lane
    (``packed`` / ``balanced`` / per-job plans on disjoint worker subsets,
    rescue regrants), in ``simulate_epochs`` (with ``outputs="stream"``
    folding to an ``EpochStreamReport``) and whole-frontier scoring of
    dynamic or space-shared scenarios (``frontier_job_times_dynamic``), the
    path behind a dynamic ``plan_cluster`` and ``plan_slo``

The live runtime (:mod:`repro_torch.cluster.runtime`: an asyncio master,
socket workers with a ``torch`` payload on their device, fault injection, a
write-ahead journal and crash recovery, traces replayed through
``ClusterEngine``) is not imported here, as the reference's is not;
``import repro_torch.cluster.runtime`` explicitly.
"""
# core first: its __init__ re-exports cluster.scenario, whose workers import
# core.service_time, so entering through cluster would meet a half-built core
from .. import core  # noqa: F401
from . import (
    control,
    epoch_scan,
    events,
    master,
    scenario,
    scheduler,
    stream,
    vectorized,
    workers,
)
from .control import OnlineReplanner, SpeculativePolicy
from .epoch_scan import (
    EpochReport,
    EpochStreamReport,
    ReplanConfig,
    frontier_job_times_dynamic,
    simulate_epochs,
)
from .master import (
    ClusterEngine,
    EngineReport,
    Job,
    JobRecord,
    jobs_from_traces,
    sample_job_times,
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
    "events",
    "master",
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
    "ClusterEngine",
    "EngineReport",
    "Job",
    "JobRecord",
    "jobs_from_traces",
    "sample_job_times",
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
