"""Trace recording and the digital-twin replay through the DES engine.

A copy of ``repro.cluster.runtime.trace`` for the port: the event
vocabulary and the grid are the reference's, so a trace or journal written by
either package reads in the other, and :func:`replay_trace` runs the port's
:class:`~repro_torch.cluster.master.ClusterEngine`.

The runtime master stamps every state transition on a binary time grid of
``TICK = 2**-20`` seconds (~0.95 us).  Grid timestamps are exact binary
fractions, so every difference and sum the accounting takes -- elapsed busy
time, reclaimed replica time, scheduled ends -- is *exact* in float64, which
is what lets :func:`replay_trace` push the recorded schedule through
:class:`~repro_torch.cluster.master.ClusterEngine` and demand bit-for-bit equality
with the live accounting rather than a tolerance.

Stamps are also strictly increasing across recorded events (ties bump to the
next grid point): the engine's event heap breaks time ties by insertion
order, so distinct stamps guarantee the replay pops events in exactly the
order the live master processed them.

Event vocabulary (``ev`` field):

=========  =============================================================
scenario   first event: the originating Scenario (t, n_workers,
           scenario = ``Scenario.to_dict()``) -- a trace file alone is
           replayable
join       worker registered (t, wid)
submit     job entered the queue (t, job, n_tasks, plan, costs, payload,
           skew -- enough to resume the job from a journal)
job_start  job activated on the cluster (t, job, n_batches, replication,
           cancel) -- stamped just before its gang's dispatches
dispatch   replica placed on a worker (t, wid, job, batch, planned,
           rescue, spec, retry -- ``spec=True`` marks a speculative
           backup, ``retry=True`` a re-dispatch after a payload failure)
finish     replica's finish processed (t, wid, job, batch)
cancel     outstanding sibling reclaimed (t, wid, job, batch, sched_end)
fail       worker declared dead (t, wid, cause:
           eof|heartbeat|lease|crash -- ``crash`` marks workers lost
           with the master, stamped by ``RuntimeMaster.recover``)
task_fail  replica's payload raised (t, wid, job, batch, attempt, error)
retry      a failed replica's backoff expired; it re-enters the rescue
           queue (t, job, batch, attempt)
job_fail   job abandoned -- retry budget exhausted with nothing in
           flight (t, job, start, n_batches, replication)
flush      replica still in flight at run end (t, wid, job, batch, sched_end)
job_done   job completed (t, job, start, n_batches, replication)
chaos      informational: a fault the injector delivered (t, kind, ...);
           replay ignores it, recovery uses it to restore which faults
           already fired
recover    master rebuilt from the journal (t, n_active, n_queued)
=========  =============================================================

``replay_trace`` rebuilds the identical workload -- jobs at their recorded
arrival stamps, worker failures as an explicit
:class:`~repro_torch.cluster.workers.ChurnSchedule` at their detection stamps, and
every replica duration scripted from the trace (elapsed time for finished
replicas; the recorded scheduled end for cancelled/failed/flushed ones) --
and runs the event engine on it.  The engine re-*derives* every decision
(gang dispatch order, rescue targets, sibling cancellation), so agreement is
a real differential check of the two implementations, not a tautology.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TICK",
    "TraceRecorder",
    "read_journal",
    "replay_trace",
    "trace_accounting",
]

_GRID = 1 << 20
TICK = 1.0 / _GRID  # the master's time quantum: one grid unit, ~0.95 us


def quantize(seconds: float) -> float:
    """Round a duration up onto the grid (durations stay strictly positive)."""
    return max(1, math.ceil(seconds * _GRID)) / _GRID


class TraceRecorder:
    """Event log + the master's monotone, grid-quantized clock.

    ``stamp()`` reads the process monotonic clock relative to the recorder's
    birth, quantizes it to the grid, and enforces strict increase -- two
    events can never share a timestamp, so replay order is total.

    ``journal`` names an append-only JSONL write-ahead log: every recorded
    event is written and ``fsync``'d *at the decision point*, before the
    decision's effects go on the wire, so a master crash never loses an
    acknowledged state transition.  ``resume_events`` (recovery) seeds the
    recorder with a previously journaled prefix: the clock continues from
    the last journaled stamp (strict increase holds across the crash) and
    the journal file is appended to, not truncated -- after recovery the one
    file holds the crash *and* the recovery as a single replayable trace.
    """

    def __init__(self, journal: Optional[str] = None, resume_events=None):
        self._events: List[dict] = list(resume_events) if resume_events else []
        last = self._events[-1]["t"] if self._events else 0.0
        self._last_g = int(round(last * _GRID))
        self._t0 = time.monotonic() - last
        self.frozen = False
        self.journal_path = journal
        self._journal = None
        if journal is not None:
            self._journal = open(journal, "ab" if resume_events else "wb")

    def elapsed(self) -> float:
        """Raw (unquantized) seconds since the recorder was born."""
        return time.monotonic() - self._t0

    def stamp(self) -> float:
        """Quantized, strictly increasing timestamp for the next event."""
        g = int(self.elapsed() * _GRID)
        self._last_g = max(g, self._last_g + 1)
        return self._last_g / _GRID

    def record(self, ev: str, t: float, **fields) -> None:
        """Append one event, write-ahead journaling it when enabled."""
        if self.frozen:
            raise RuntimeError("trace is frozen; the run already finalized")
        event = {"ev": ev, "t": t, **fields}
        self._events.append(event)
        if self._journal is not None:
            self._journal.write(json.dumps(event).encode("utf-8") + b"\n")
            self._journal.flush()
            os.fsync(self._journal.fileno())

    def close_journal(self) -> None:
        """Close the write-ahead journal file, if one is open."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    @property
    def events(self) -> Tuple[dict, ...]:
        """Everything recorded so far, in stamp order."""
        return tuple(self._events)


def read_journal(path: str) -> List[dict]:
    """Load a JSONL trace journal, tolerating a torn final line.

    A crash can interrupt the write of the last record; the fsync discipline
    guarantees every *complete* line was a decision whose effects may have
    reached the wire, so those are kept and a trailing partial line (no
    terminating newline / invalid JSON) is discarded.
    """
    events: List[dict] = []
    with open(path, "rb") as f:
        data = f.read()
    for i, line in enumerate(data.split(b"\n")):
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == data.count(b"\n"):  # torn final line (crash mid-write)
                break
            raise
    return events


# --------------------------------------------------------------------------
# accounting fold: the runtime's counters derived purely from the trace
# --------------------------------------------------------------------------


def trace_accounting(events) -> dict:
    """Fold a trace into the engine's invariant-bearing counters.

    Returns the same key set as
    :meth:`~repro_torch.cluster.master.EngineReport.accounting` (the live runtime
    has no online replanner, so ``n_replans`` is 0).  This is a *pure*
    function of the event log -- the differential tests check it against
    both the live master's own counters and the engine replay's.
    """
    ws = 0.0
    saved = 0.0
    n_failures = 0
    n_rescued = 0
    n_spec = 0
    n_task_failures = 0
    n_retries = 0
    busy: Dict[int, dict] = {}  # wid -> its open dispatch event
    for e in events:
        kind = e["ev"]
        if kind == "dispatch":
            busy[e["wid"]] = e
            if e.get("retry"):
                n_retries += 1
            elif e["rescue"]:
                n_rescued += 1
            if e.get("spec"):
                n_spec += 1
        elif kind == "finish":
            d = busy.pop(e["wid"])
            ws += e["t"] - d["t"]
        elif kind == "cancel":
            d = busy.pop(e["wid"])
            ws += e["t"] - d["t"]
            saved += e["sched_end"] - e["t"]
        elif kind == "fail":
            n_failures += 1
            d = busy.pop(e["wid"], None)
            if d is not None:
                ws += e["t"] - d["t"]
        elif kind == "task_fail":
            n_task_failures += 1
            d = busy.pop(e["wid"])
            ws += e["t"] - d["t"]
        elif kind == "flush":
            d = busy.pop(e["wid"])
            ws += e["sched_end"] - d["t"]
    return {
        "worker_seconds": ws,
        "cancelled_seconds_saved": saved,
        "n_worker_failures": n_failures,
        "n_replicas_rescued": n_rescued,
        "n_replans": 0,
        "n_speculative": n_spec,
        "n_task_failures": n_task_failures,
        "n_retries": n_retries,
    }


# --------------------------------------------------------------------------
# the digital twin: replay the recorded schedule through ClusterEngine
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _ScriptedService:
    """A ServiceTime stand-in that pops recorded replica durations in order.

    The engine draws exactly one service time per replica it dispatches, in
    dispatch order; with ``size_dependent=False`` and homogeneous unit
    speeds the draw *is* the wall-clock duration.  Exhausting the script --
    or leaving part of it unconsumed -- means the engine made a different
    dispatch sequence than the live master: a genuine divergence, reported
    loudly instead of silently misaligning durations.
    """

    durations: Tuple[float, ...]
    cursor: int = 0

    def sample_np(self, rng, shape):
        if shape not in ((), None):  # pragma: no cover - engine always draws scalars
            raise ValueError(f"scripted service draws scalars, got shape {shape}")
        if self.cursor >= len(self.durations):
            raise RuntimeError(
                "trace replay diverged: the engine dispatched more replicas "
                f"than the trace recorded ({len(self.durations)})"
            )
        d = self.durations[self.cursor]
        self.cursor += 1
        return d


def _scripted_durations(events) -> Tuple[Tuple[float, ...], Tuple[int, ...]]:
    """Per-dispatch scripted durations (in dispatch order) + which global
    dispatch indices failed their payload.

    finished   -> elapsed (finish stamp - dispatch stamp): the engine's
                  BATCH_DONE then lands exactly on the recorded finish stamp;
    cancelled  -> recorded effective scheduled end - dispatch stamp: the
                  engine's ``scheduled_end`` (and so its saved-seconds)
                  matches the live accounting, and the event pops strictly
                  after the winner's, where the epoch guard drops it;
    task_fail  -> elapsed at the recorded failure stamp: the engine's
                  TASK_FAIL event lands exactly there, charging the same
                  busy time the live master did;
    failed     -> pushed past the failure stamp so the fail event wins the
                  race (worker-seconds charge only reads ``busy_since``);
    flushed    -> the recorded scheduled end (full planned duration), the
                  engine's end-of-run committed-time charge.
    """
    durations: List[float] = []
    fail_idx: List[int] = []
    slot: Dict[int, int] = {}  # wid -> index into durations of its open dispatch
    start: Dict[int, float] = {}
    for e in events:
        kind = e["ev"]
        if kind == "dispatch":
            slot[e["wid"]] = len(durations)
            start[e["wid"]] = e["t"]
            durations.append(e["planned"])  # placeholder until the outcome is known
        elif kind == "finish":
            durations[slot.pop(e["wid"])] = e["t"] - start.pop(e["wid"])
        elif kind in ("cancel", "flush"):
            durations[slot.pop(e["wid"])] = e["sched_end"] - start.pop(e["wid"])
        elif kind == "task_fail":
            k = slot.pop(e["wid"])
            fail_idx.append(k)
            durations[k] = e["t"] - start.pop(e["wid"])
        elif kind == "fail":
            k = slot.pop(e["wid"], None)
            if k is not None:
                t0 = start.pop(e["wid"])
                durations[k] = max(durations[k], e["t"] - t0 + TICK)
    if slot:  # pragma: no cover - the master always closes open dispatches
        raise RuntimeError(f"trace ended with open dispatches on workers {sorted(slot)}")
    return tuple(durations), tuple(fail_idx)


def replay_trace(events, n_workers: Optional[int] = None, scenario=None):
    """Replay a recorded runtime trace through the discrete-event engine.

    Builds the identical workload the live master saw -- same arrival
    stamps, same worker-failure timeline, same per-replica durations -- and
    returns the engine's :class:`~repro_torch.cluster.master.EngineReport`.  The
    engine independently re-derives dispatch, rescue, and cancellation
    decisions; if runtime and engine implement the same semantics, the
    report's accounting and job records equal the live ones bit for bit.

    ``scenario`` / ``n_workers`` default to the trace's embedded
    ``scenario`` event (the master records its originating
    :class:`~repro_torch.cluster.scenario.Scenario` and worker budget as the
    first event), so ``replay_trace(events)`` works on a bare trace file;
    per-job :class:`~repro_torch.cluster.scheduler.JobPlan` overrides ride in the
    trace's ``submit`` events.

    Speculative launches replay *scripted*: each live launch stamp becomes
    a ``speculation_times`` epoch, and the engine re-derives the target
    batch and worker under the same policy -- a divergence raises instead
    of silently misaligning the schedule.  Task failures replay the same
    way: each ``task_fail`` event marks its global dispatch index as a
    scripted payload failure, each ``retry`` stamp re-queues the pending
    replica, and the engine re-derives attempts, backoff bookkeeping, and
    abandonment under the same :class:`~repro_torch.cluster.scenario.Retry`
    policy.  ``chaos`` / ``recover`` events are informational: the faults'
    *consequences* (churn, task failures, the crash's worker losses) are
    already first-class events, so a chaos-and-crash run replays through
    the same engine path as a clean one.
    """
    from ..master import ClusterEngine, Job
    from ..scenario import Scenario
    from ..scheduler import JobPlan
    from ..workers import ChurnSchedule

    embedded = next((e for e in events if e["ev"] == "scenario"), None)
    sc = scenario
    if sc is None and embedded is not None:
        sc = Scenario.from_dict(embedded["scenario"])
    if sc is None:
        sc = Scenario()
    if n_workers is None:
        if embedded is None:
            raise ValueError(
                "replay_trace: n_workers is required when the trace has no "
                "embedded scenario event"
            )
        n_workers = int(embedded["n_workers"])
    durations, task_fail_idx = _scripted_durations(events)
    dist = _ScriptedService(durations)

    jobs = []
    churn_times: List[float] = []
    churn_wids: List[int] = []
    churn_ups: List[bool] = []
    down: set = set()
    for e in events:
        if e["ev"] == "submit":
            plan = e.get("plan")
            jobs.append(
                Job(
                    job_id=e["job"],
                    dist=dist,
                    n_tasks=e["n_tasks"],
                    arrival=e["t"],
                    name=e.get("name", ""),
                    plan=JobPlan(**plan) if plan else None,
                )
            )
        elif e["ev"] == "fail":
            churn_times.append(e["t"])
            churn_wids.append(e["wid"])
            churn_ups.append(False)
            down.add(e["wid"])
        elif e["ev"] == "join" and e["wid"] in down:
            # a re-join: the master retired the wid's stale registration and
            # granted it to a fresh connection -- an up-transition on the
            # engine's shared churn timeline (first-time joins at startup
            # precede any fail and stay outside the schedule)
            churn_times.append(e["t"])
            churn_wids.append(e["wid"])
            churn_ups.append(True)
            down.discard(e["wid"])

    schedule = None
    if churn_times:
        schedule = ChurnSchedule(
            times=tuple(churn_times),
            wids=tuple(churn_wids),
            ups=tuple(churn_ups),
        )
    spec_times = tuple(
        e["t"] for e in events if e["ev"] == "dispatch" and e.get("spec")
    )
    if spec_times and sc.speculation is None:
        raise ValueError(
            "replay_trace: the trace stamps speculative launches but the "
            "scenario carries no Speculation policy"
        )
    retry_times = tuple(e["t"] for e in events if e["ev"] == "retry")
    if retry_times and sc.retry is None:
        raise ValueError(
            "replay_trace: the trace stamps retries but the scenario "
            "carries no Retry policy"
        )
    engine = ClusterEngine(
        n_workers,
        seed=0,  # the scripted service ignores the rng; nothing else draws
        n_batches=sc.n_batches,
        cancel_redundant=sc.cancel_redundant,
        size_dependent=False,  # scripted draws are wall-clock durations
        churn_schedule=schedule,
        speculation=sc.speculation,
        # scripted replay: launch exactly at the live stamps, never self-arm
        speculation_times=spec_times if sc.speculation is not None else None,
        retry=sc.retry,
        task_fail_script=task_fail_idx or None,
        retry_times=retry_times if sc.retry is not None else None,
    )
    report = engine.run(jobs)
    if dist.cursor != len(dist.durations):
        raise RuntimeError(
            "trace replay diverged: the engine dispatched "
            f"{dist.cursor} replicas, the trace recorded {len(dist.durations)}"
        )
    return report
