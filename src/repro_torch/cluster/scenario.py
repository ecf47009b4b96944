"""Scenario: one frozen, validated spec for every backend of the system.

A copy of ``repro.cluster.scenario`` for the port.  ``Scenario.validate``
accepts ``backend="torch"`` wherever the reference accepts ``"jax"``, and
``Scenario.from_json`` reads the JSON of a reference ``Scenario`` byte for
byte (``to_json`` writes it back identically) -- that JSON, with the
distribution inside it, is the state the two packages hand each other.

Decoding a ``replan`` field raises :class:`NotImplementedError`: its
``ReplanConfig`` belongs to the epoch scan, which the port has not reached.
The reference's loose-keyword compatibility shim has no counterpart: the
port's entry points take ``scenario=`` only.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

from .scheduler import SCHEDULERS, JobPlan, Scheduler
from .workers import ChurnProcess, ChurnSchedule

__all__ = [
    "FaultPlan",
    "Retry",
    "SLO",
    "Scenario",
    "Speculation",
]

# backends that run the batched array lanes: the reference's jax and the port
_ARRAY_BACKENDS = ("jax", "torch")


@dataclasses.dataclass(frozen=True)
class Speculation:
    """Reactive (speculative) replication policy: MapReduce backup tasks.

    Per-task progress is observed at *heartbeat epochs* -- the time grid
    ``k * interval`` in simulation, the workers' progress heartbeats in the
    live runtime.  A batch whose youngest in-flight replica has been running
    longer than ``theta x`` the running median of its completed siblings'
    durations gets a backup replica launched on a free worker at the first
    heartbeat epoch strictly after the crossing.  The backup races its
    sibling under the usual earliest-cover rule (and is reclaimed by
    ``cancel_redundant`` like any other redundant replica).

    ``min_observations`` completed sibling batches are required before the
    median is trusted; ``max_backups`` caps speculative launches per job.
    Launches are opportunistic: a laggard with no free worker available is
    reconsidered at the first heartbeat after one frees up.
    """

    interval: float = 0.25
    theta: float = 1.5
    min_observations: int = 1
    max_backups: int = 1

    def __post_init__(self):
        if not (self.interval > 0.0):
            raise ValueError(f"Speculation.interval: must be > 0, got {self.interval}")
        if not (self.theta > 0.0):
            raise ValueError(f"Speculation.theta: must be > 0, got {self.theta}")
        if self.min_observations < 1:
            raise ValueError(
                f"Speculation.min_observations: must be >= 1, got {self.min_observations}"
            )
        if self.max_backups < 1:
            raise ValueError(f"Speculation.max_backups: must be >= 1, got {self.max_backups}")


@dataclasses.dataclass(frozen=True)
class Retry:
    """Task-level failure semantics: retry a failed replica with backoff.

    A worker whose payload raises sends a ``fail`` frame (live runtime) /
    fires a ``TASK_FAIL`` event (engine replay).  The master releases the
    worker, counts the attempt, and -- while the batch's attempt count is
    ``<= max_attempts`` -- re-queues the replica after a capped exponential
    backoff (``min(backoff_s * 2**(k-1), max_backoff_s)`` for attempt ``k``),
    serving it through the rescue queue.  Once the budget is exhausted and no
    sibling replica is still running or pending, the job is *abandoned*: a
    ``job_fail`` event is stamped and its record finishes at ``inf``.

    Supported by the Python engine (trace replay) and the live runtime;
    rejected on ``backend="jax"``.
    """

    max_attempts: int = 2
    backoff_s: float = 0.05
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"Retry.max_attempts: must be >= 1, got {self.max_attempts}")
        if not (self.backoff_s >= 0.0):
            raise ValueError(f"Retry.backoff_s: must be >= 0, got {self.backoff_s}")
        if not (self.max_backoff_s >= self.backoff_s):
            raise ValueError(
                f"Retry.max_backoff_s: must be >= backoff_s, got {self.max_backoff_s}"
            )

    def backoff(self, attempt: int) -> float:
        """Delay before re-queueing attempt ``attempt`` (1-based)."""
        return min(self.backoff_s * (2.0 ** max(attempt - 1, 0)), self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class SLO:
    """A tail response-time objective: ``P[response <= target_s] >= quantile``.

    The paper's second core result is that the replication level minimizing
    *mean* compute time is not the one minimizing tail response -- an SLO
    makes that trade-off an explicit planning input instead of a blend
    weight.  ``quantile`` is the tail level (0.99 for p99, 0.999 for p999),
    ``target_s`` the response-time bound it must meet, and ``arrival_rate``
    the offered load (jobs/second, Poisson) the target must hold under.
    ``job_class`` restricts the objective to one workload class (a source
    trace-job name under :class:`~repro.core.traces.TraceStream` streaming);
    ``None`` applies it to the pooled response distribution.

    Consumed by :meth:`repro.core.planner.RedundancyPlanner.plan_slo`, which
    sweeps (B, r, scheduler) candidates and returns the cheapest feasible
    one in worker-seconds (or an explicit infeasible verdict).

    Example (validates on construction)::

        >>> SLO(quantile=0.99, target_s=30.0, arrival_rate=0.5)
        SLO(quantile=0.99, target_s=30.0, arrival_rate=0.5, job_class=None)
    """

    quantile: float = 0.99
    target_s: float = 1.0
    arrival_rate: float = 1.0
    job_class: Optional[str] = None

    def __post_init__(self):
        if not (0.0 < self.quantile < 1.0):
            raise ValueError(
                f"SLO.quantile: must lie in (0, 1), got {self.quantile}"
            )
        if not (self.target_s > 0.0):
            raise ValueError(f"SLO.target_s: must be > 0, got {self.target_s}")
        if not (self.arrival_rate > 0.0):
            raise ValueError(
                f"SLO.arrival_rate: must be > 0, got {self.arrival_rate}"
            )


def _freeze_rows(name: str, rows, width: int) -> Tuple[tuple, ...]:
    out = []
    for row in rows:
        row = tuple(row)
        if len(row) != width:
            raise ValueError(f"FaultPlan.{name}: entries must have {width} fields, got {row!r}")
        out.append(row)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic chaos schedule for the live runtime.

    Every fault decision is made master-side by one seeded injector
    (:class:`repro.cluster.runtime.chaos.FaultInjector`) and stamped on the
    binary trace grid as an informational ``chaos`` event, so a faulted run
    stays bit-exactly replayable and crash-recovery can restore which faults
    were already delivered.

    * ``kills`` -- ``(wid, at_s)``: the master tears down the worker's
      connection at elapsed time ``at_s`` (the worker observes EOF and
      exits; the master detects the torn connection exactly as it would a
      real crash).
    * ``slowdowns`` -- ``(wid, at_s, factor)``: tasks dispatched to ``wid``
      at or after ``at_s`` run ``factor``x slower (the task frame carries
      the factor; compounding entries multiply).
    * ``hb_stalls`` -- ``(wid, at_s, duration_s)``: the master drops the
      worker's inbound heartbeats in the window, provoking missed-heartbeat
      detection without killing anything.
    * ``payload_errors`` -- ``(job, batch, n_raises)``: the first
      ``n_raises`` dispatches of that replica raise mid-payload (exercising
      the ``fail``-frame path and :class:`Retry`).
    * ``drop_p`` / ``dup_p`` / ``delay_p`` -- per-frame wire-fault
      probabilities (drop, duplicate, or delay by ``delay_s``), decided by a
      counter-seeded hash so each frame's fate is a pure function of
      ``(seed, direction, frame index)``.

    Live runtime only; rejected on ``backend="python"`` / ``"jax"`` (the
    engine sees the *consequences* -- churn, task failures -- via the trace).
    """

    seed: int = 0
    kills: Tuple[Tuple[int, float], ...] = ()
    slowdowns: Tuple[Tuple[int, float, float], ...] = ()
    hb_stalls: Tuple[Tuple[int, float, float], ...] = ()
    payload_errors: Tuple[Tuple[int, int, int], ...] = ()
    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.02

    def __post_init__(self):
        # coerce nested lists (e.g. from from_dict) so the dataclass stays
        # hashable, then validate shape and ranges once, here
        object.__setattr__(self, "kills", _freeze_rows("kills", self.kills, 2))
        object.__setattr__(self, "slowdowns", _freeze_rows("slowdowns", self.slowdowns, 3))
        object.__setattr__(self, "hb_stalls", _freeze_rows("hb_stalls", self.hb_stalls, 3))
        object.__setattr__(
            self, "payload_errors", _freeze_rows("payload_errors", self.payload_errors, 3)
        )
        for wid, at in self.kills:
            if int(wid) < 0 or not (at >= 0.0):
                raise ValueError(f"FaultPlan.kills: bad entry {(wid, at)!r}")
        for wid, at, factor in self.slowdowns:
            if int(wid) < 0 or not (at >= 0.0) or not (factor > 0.0):
                raise ValueError(f"FaultPlan.slowdowns: bad entry {(wid, at, factor)!r}")
        for wid, at, dur in self.hb_stalls:
            if int(wid) < 0 or not (at >= 0.0) or not (dur > 0.0):
                raise ValueError(f"FaultPlan.hb_stalls: bad entry {(wid, at, dur)!r}")
        for job, batch, k in self.payload_errors:
            if int(job) < 0 or int(batch) < 0 or int(k) < 1:
                raise ValueError(f"FaultPlan.payload_errors: bad entry {(job, batch, k)!r}")
        for name in ("drop_p", "dup_p", "delay_p"):
            p = getattr(self, name)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"FaultPlan.{name}: must lie in [0, 1], got {p}")
        if self.drop_p + self.dup_p + self.delay_p > 1.0:
            raise ValueError("FaultPlan: drop_p + dup_p + delay_p must be <= 1")
        if not (self.delay_s >= 0.0):
            raise ValueError(f"FaultPlan.delay_s: must be >= 0, got {self.delay_s}")

    @property
    def max_wid(self) -> int:
        """Highest worker id any scheduled fault names (-1 when none do)."""
        wids = [int(w) for w, *_ in (*self.kills, *self.slowdowns, *self.hb_stalls)]
        return max(wids) if wids else -1


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything that defines a straggler-mitigation scenario, in one object.

    Workload shape (``dist``, ``n_workers``, ``n_batches``, ``n_tasks``),
    engine semantics (``cancel_redundant``, ``size_dependent``), dynamics
    (``speeds``, ``churn`` | ``churn_schedule``, ``replan``), space sharing
    (``scheduler``, ``workers_per_job``, ``job_plans``), and the jax scale
    knobs (``dtype``, ``rep_chunk``, ``devices``).  Fields left ``None``
    inherit each entry point's call-level arguments (e.g. ``plan_cluster``
    sweeps candidate B's, so it ignores ``n_batches``; ``sample_job_times``
    takes ``n_batches`` positionally and falls back to the scenario's).

    Frozen and hashable, so a Scenario can key caches and ride inside jit
    bucketing the way :class:`~repro.cluster.epoch_scan.ReplanConfig` does.

    Example (the routing predicates pick the execution lane)::

        >>> sc = Scenario(scheduler="packed", workers_per_job=4)
        >>> sc.is_space
        True
        >>> sc.is_dynamic
        False
        >>> sc.replace(speeds=(1.0, 0.5)).is_dynamic
        True
    """

    dist: Optional[object] = None  # ServiceTime; kept loose to avoid core import cycle
    n_workers: Optional[int] = None
    n_batches: Optional[int] = None
    n_tasks: Optional[int] = None
    cancel_redundant: bool = False
    size_dependent: bool = True
    speeds: Optional[Tuple[float, ...]] = None
    churn: Optional[ChurnProcess] = None
    churn_schedule: Optional[ChurnSchedule] = None
    # sampled-churn horizon (fail/join pairs per worker) on the jax lanes;
    # None auto-sizes it from the stream length (epoch_scan warns loudly if
    # the simulated timeline still outruns it)
    churn_pairs_per_worker: Optional[int] = None
    replan: Optional[object] = None  # ReplanConfig of the epoch scan (not ported yet)
    speculation: Optional[Speculation] = None
    # task-level failure semantics (payload exception -> backoff retry ->
    # abandon); Python engine (replay) + live runtime
    retry: Optional[Retry] = None
    # deterministic chaos schedule; live runtime only
    faults: Optional[FaultPlan] = None
    # tail response-time objective; consumed by RedundancyPlanner.plan_slo
    slo: Optional[SLO] = None
    scheduler: Union[str, Scheduler] = "fifo_gang"
    workers_per_job: Optional[int] = None
    job_plans: Optional[Tuple[Optional[JobPlan], ...]] = None
    jobs_per_stream: int = 16
    dtype: str = "float32"
    rep_chunk: Optional[int] = None
    devices: int = 1
    # "full" returns per-job starts/finishes (the classic reports); "stream"
    # carries running aggregates (count, moment sums, min/max, a log-spaced
    # response histogram) in the scan instead, so trace-scale runs never
    # materialize (reps x jobs) outputs.  jax backends only; "full" paths
    # stay bit-identical when this is left at the default.
    outputs: str = "full"

    def __post_init__(self):
        # freeze the sequence-valued fields so the dataclass stays hashable
        if self.speeds is not None and not isinstance(self.speeds, tuple):
            object.__setattr__(self, "speeds", tuple(float(s) for s in self.speeds))
        if self.job_plans is not None and not isinstance(self.job_plans, tuple):
            object.__setattr__(self, "job_plans", tuple(self.job_plans))

    # -- routing predicates --------------------------------------------------

    @property
    def scheduler_name(self) -> str:
        """The scheduler's registry name, whether set by name or instance."""
        return self.scheduler if isinstance(self.scheduler, str) else self.scheduler.name

    @property
    def is_space(self) -> bool:
        """Whether any space-sharing knob routes this scenario off the
        legacy single-gang lane (shared predicate with
        :func:`repro.cluster.scheduler.is_space`).
        """
        from .scheduler import is_space

        return is_space(self.scheduler_name, self.workers_per_job, self.job_plans)

    @property
    def is_dynamic(self) -> bool:
        """Whether the scenario needs the dynamic (epoch-scan) semantics."""
        return (
            self.speeds is not None
            or self.churn is not None
            or self.churn_schedule is not None
            or self.replan is not None
            or self.speculation is not None
        )

    # -- the single validation path ------------------------------------------

    def validate(
        self,
        n_workers: Optional[int] = None,
        *,
        backend: Optional[str] = None,
        controller=None,
    ) -> "Scenario":
        """Check every cross-field constraint once, for every backend.

        ``n_workers`` is the call-level worker budget (e.g. the planner's);
        it must agree with ``self.n_workers`` when both are set.  ``backend``
        tightens the check to what that backend supports -- error messages
        name the offending field *and* the backends that accept it.
        ``controller`` is the Python engine's live
        :class:`~repro.cluster.control.OnlineReplanner`, which shares
        ``replan``'s exclusion rules.  Returns ``self`` so call sites can
        chain.  Environment-dependent checks (jax x64 enabled, visible
        device count) stay with the jax modules -- they are properties of
        the process, not of the scenario.
        """
        if self.n_workers is not None and n_workers is not None:
            if int(self.n_workers) != int(n_workers):
                raise ValueError(
                    f"Scenario.n_workers={self.n_workers} does not match the "
                    f"call-level worker budget {n_workers}"
                )
        n = self.n_workers if n_workers is None else n_workers
        if n is not None and int(n) < 1:
            raise ValueError(f"Scenario.n_workers: must be >= 1, got {n}")
        if self.n_batches is not None:
            if self.n_batches < 1 or (n is not None and self.n_batches > n):
                hi = n if n is not None else "n_workers"
                raise ValueError(
                    f"Scenario.n_batches: must lie in [1, {hi}] or be None, "
                    f"got {self.n_batches}"
                )
        if self.n_tasks is not None and self.n_tasks < 1:
            raise ValueError(f"Scenario.n_tasks: must be >= 1, got {self.n_tasks}")
        if self.speeds is not None:
            if n is not None and len(self.speeds) != n:
                raise ValueError(
                    "Scenario.speeds: speeds must have one entry per worker "
                    f"(got {len(self.speeds)} for {n} workers)"
                )
            if any(not (s > 0) for s in self.speeds):
                raise ValueError("Scenario.speeds: speeds must be positive")
        if self.churn is not None and self.churn_schedule is not None:
            raise ValueError(
                "Scenario.churn/churn_schedule: pass either churn (sampled "
                "online) or churn_schedule, not both"
            )
        if self.churn_schedule is not None and len(self.churn_schedule) and n is not None:
            if min(self.churn_schedule.wids) < 0 or max(self.churn_schedule.wids) >= n:
                raise ValueError(f"Scenario.churn_schedule: worker ids must lie in [0, {n})")
        if self.churn_pairs_per_worker is not None and self.churn_pairs_per_worker < 1:
            raise ValueError(
                "Scenario.churn_pairs_per_worker: must be >= 1 (or None to "
                f"auto-size from the stream), got {self.churn_pairs_per_worker}"
            )
        if self.jobs_per_stream < 1:
            raise ValueError(f"Scenario.jobs_per_stream: must be >= 1, got {self.jobs_per_stream}")
        if self.replan is not None and controller is not None:
            raise ValueError(
                "Scenario.replan: pass either controller (Python engine) or "
                "replan (both backends), not both"
            )
        if self.replan is not None:
            if self.replan.objective not in ("mean", "cov", "blend"):
                raise ValueError(f"Scenario.replan: unknown objective {self.replan.objective!r}")
            if backend in _ARRAY_BACKENDS and n is not None and self.replan.window < n:
                raise ValueError(
                    "Scenario.replan: replan.window must be >= n_workers on "
                    "backend='jax' (ring push bound); the Python engine has no "
                    "such floor"
                )
        if self.speculation is not None:
            if not isinstance(self.speculation, Speculation):
                raise ValueError(
                    f"Scenario.speculation: expected a Speculation, got {type(self.speculation)}"
                )
            if self.replan is not None or controller is not None:
                raise ValueError(
                    "Scenario.speculation: speculative backups and online "
                    "replanning are mutually exclusive adaptive policies -- "
                    "pass one of speculation / replan (controller)"
                )
            if backend in _ARRAY_BACKENDS and self.is_space:
                raise ValueError(
                    "Scenario.speculation: speculative backups under "
                    "space-sharing schedulers / per-job plans run on "
                    "backend='python' only (the jax lane implements the gang "
                    "regime)"
                )
        if self.retry is not None:
            if not isinstance(self.retry, Retry):
                raise ValueError(f"Scenario.retry: expected a Retry, got {type(self.retry)}")
            if backend in _ARRAY_BACKENDS:
                raise ValueError(
                    "Scenario.retry: task-failure retry runs on the Python "
                    "engine (trace replay) and the live runtime only; the jax "
                    "lanes have no task-failure notion"
                )
        if self.faults is not None:
            if not isinstance(self.faults, FaultPlan):
                raise ValueError(f"Scenario.faults: expected a FaultPlan, got {type(self.faults)}")
            if backend in ("python", *_ARRAY_BACKENDS):
                raise ValueError(
                    "Scenario.faults: chaos fault injection drives the live "
                    "runtime only (backend='live'); simulations see its "
                    "consequences through the recorded trace"
                )
            if n is not None and self.faults.max_wid >= int(n):
                raise ValueError(
                    f"Scenario.faults: worker ids must lie in [0, {n}), "
                    f"got {self.faults.max_wid}"
                )
        if self.slo is not None and not isinstance(self.slo, SLO):
            # SLO value constraints live in SLO.__post_init__; job_class is
            # resolved against the workload by plan_slo (unknown names raise
            # there, where the class list exists)
            raise ValueError(f"Scenario.slo: expected an SLO, got {type(self.slo)}")
        if not isinstance(self.scheduler, Scheduler) and self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"Scenario.scheduler: unknown scheduler {self.scheduler!r} "
                f"(expected one of {sorted(SCHEDULERS)})"
            )
        if self.is_space and (self.replan is not None or controller is not None):
            raise ValueError(
                "Scenario.replan: replan/controller is not supported with "
                "space-sharing schedulers / per-job plans on any backend "
                "(the online replanner picks one cluster-wide B)"
            )
        if self.workers_per_job is not None:
            hi = n if n is not None else "n_workers"
            if self.workers_per_job < 1 or (n is not None and self.workers_per_job > n):
                raise ValueError(
                    f"Scenario.workers_per_job: must lie in [1, {hi}], "
                    f"got {self.workers_per_job}"
                )
        if self.job_plans is not None:
            if not len(self.job_plans):
                raise ValueError(
                    "Scenario.job_plans: must be a non-empty sequence "
                    "(it cycles over jobs)"
                )
            for p in self.job_plans:
                if p is not None and not isinstance(p, JobPlan):
                    raise ValueError(
                        f"Scenario.job_plans: entries must be JobPlan or None, "
                        f"got {type(p)}"
                    )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"Scenario.dtype: dtype must be 'float32' or 'float64', got {self.dtype!r}"
            )
        if self.rep_chunk is not None and self.rep_chunk < 1:
            raise ValueError(f"Scenario.rep_chunk: rep_chunk must be >= 1, got {self.rep_chunk}")
        if self.outputs not in ("full", "stream"):
            raise ValueError(
                f"Scenario.outputs: must be 'full' or 'stream', got {self.outputs!r}"
            )
        if self.devices < 1:
            raise ValueError(f"Scenario.devices: devices must be >= 1, got {self.devices}")
        if backend in ("python", "live"):
            if self.dtype != "float32":
                raise ValueError(
                    "Scenario.dtype: float64 lanes are a jax epoch-scan knob "
                    "(backend='jax' on dynamic scenarios); the Python engine "
                    "computes in float64 natively"
                )
            if self.devices != 1:
                raise ValueError(
                    "Scenario.devices: device sharding is a jax epoch-scan knob "
                    "(backend='jax' on dynamic scenarios); the Python engine is "
                    "single-process"
                )
            if self.outputs != "full":
                raise ValueError(
                    "Scenario.outputs: streaming aggregation is a jax knob "
                    "(simulate_epochs / simulate_stream); the Python engine "
                    "returns full per-job records"
                )
        return self

    def replace(self, **changes) -> "Scenario":
        """A modified copy: ``sc.replace(cancel_redundant=True)`` -- the
        ergonomic way to derive scenario variants from a base spec.
        """
        return dataclasses.replace(self, **changes)

    # -- serialization (Scenario v2 JSON) ------------------------------------
    #
    # Schema: a flat object of the dataclass fields plus ``"version": 2``.
    # Nested configs serialize as tagged objects -- ``dist`` as
    # ``{"kind": "<ServiceTime subclass>", ...fields}``; ``churn`` /
    # ``churn_schedule`` / ``replan`` / ``speculation`` as their dataclass
    # fields; ``job_plans`` as a list of JobPlan objects or nulls;
    # ``scheduler`` as its registry name.  Floats ride through ``json`` via
    # ``repr`` shortest-round-trip, so ``from_json(to_json())`` is *exact*,
    # not approximate -- the property the trace-embeds rely on.

    def to_dict(self) -> dict:
        """JSON-ready flat dict of the fields plus ``"version": 2``."""
        out = {"version": 2}
        for f in dataclasses.fields(self):
            out[f.name] = _encode_field(f.name, getattr(self, f.name))
        return out

    def to_json(self, *, indent: Optional[int] = None) -> str:
        """Serialize to JSON; ``Scenario.from_json`` round-trips exactly."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        """Decode :meth:`to_dict` output; unknown fields or versions raise."""
        d = dict(d)
        version = d.pop("version", None)
        if version != 2:
            raise ValueError(f"Scenario.from_dict: unsupported schema version {version!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Scenario.from_dict: unknown fields {sorted(unknown)}")
        return cls(**{k: _decode_field(k, v) for k, v in d.items()})

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        """Decode a :meth:`to_json` string."""
        return cls.from_dict(json.loads(s))


def _dist_registry() -> dict:
    from ..core.service_time import DISTRIBUTIONS

    return DISTRIBUTIONS


def _encode_field(name: str, v):
    if v is None:
        return None
    if name == "dist":
        kind = type(v).__name__
        if kind not in _dist_registry():
            raise ValueError(
                f"Scenario.dist: cannot serialize {kind} (expected one of "
                f"{sorted(_dist_registry())})"
            )
        out = {"kind": kind}
        out.update(
            {k: (list(x) if isinstance(x, tuple) else x) for k, x in dataclasses.asdict(v).items()}
        )
        return out
    if name in ("churn", "churn_schedule", "replan", "speculation", "retry", "faults", "slo"):
        return {k: (list(x) if isinstance(x, tuple) else x) for k, x in dataclasses.asdict(v).items()}
    if name == "scheduler":
        if isinstance(v, Scheduler):
            if v.name not in SCHEDULERS:
                raise ValueError(
                    f"Scenario.scheduler: cannot serialize unregistered scheduler {v.name!r}"
                )
            return v.name
        return v
    if name == "job_plans":
        return [None if p is None else dataclasses.asdict(p) for p in v]
    if name == "speeds":
        return list(v)
    return v


def _decode_field(name: str, v):
    if v is None:
        return None
    if name == "dist":
        d = dict(v)
        kind = d.pop("kind", None)
        reg = _dist_registry()
        if kind not in reg:
            raise ValueError(f"Scenario.dist: unknown distribution kind {kind!r}")
        from ..core.service_time import from_spec

        return from_spec(kind, d)
    if name == "churn":
        return ChurnProcess(**v)
    if name == "churn_schedule":
        return ChurnSchedule(
            times=tuple(v["times"]), wids=tuple(v["wids"]), ups=tuple(v["ups"])
        )
    if name == "replan":
        raise NotImplementedError(
            "Scenario.replan: ReplanConfig belongs to the epoch scan, which the "
            "port reaches in a later slice (ROADMAP.md, queue 1, item 4)"
        )
    if name == "speculation":
        return Speculation(**v)
    if name == "retry":
        return Retry(**v)
    if name == "faults":
        return FaultPlan(**v)
    if name == "slo":
        return SLO(**v)
    if name == "job_plans":
        return tuple(None if p is None else JobPlan(**p) for p in v)
    if name == "speeds":
        return tuple(v)
    return v
