"""Asyncio master: leases, heartbeats, failure detection, replica dispatch.

A copy of ``repro.cluster.runtime.master`` for the port, decision for
decision, on the port's engine types.  One deliberate difference: a master
that has crashed records nothing more.  Since Python 3.12.1,
``Server.wait_closed()`` waits for the open connections, so the reference's
:meth:`RuntimeMaster.crash` lets each connection handler see EOF and journal
a ``fail ... cause="eof"`` before the journal closes; the recovered master
then finds no worker alive and never stamps the ``crash`` seam.  Here
:meth:`RuntimeMaster._fail` is a no-op once ``crash()`` has begun, so the
journal ends where the crash struck and :meth:`RuntimeMaster.recover` stamps
``cause="crash"`` for every worker that was alive.

:class:`RuntimeMaster` is the live counterpart of the discrete-event
:class:`~repro_torch.cluster.master.ClusterEngine`, and is written decision-for-
decision against it so the engine can replay its traces exactly:

* whole-cluster FIFO gang dispatch -- the next job starts only when no job
  is active and every alive worker is free; batch ``i % B`` goes to the
  i-th free worker in wid order, B resolved with the engine's precedence
  (``Job.plan.n_batches`` > scenario ``n_batches`` > alive count, clamped);
* cancel-on-earliest-cover -- when a batch's first replica finishes, its
  outstanding siblings (in wid order) are cancelled; the reclaimed time is
  ``scheduled_end - now`` against the replica's planned duration;
* rescue -- a worker dying with a batch's last replica queues the batch for
  re-dispatch to the lowest-wid free worker;
* failure detection -- a torn connection (EOF), a missed-heartbeat window,
  or a blown task lease all declare the worker dead at one stamped instant.

Every state transition is stamped once, on the strictly-increasing binary
grid of :class:`~repro_torch.cluster.runtime.trace.TraceRecorder`, and appended to
the trace that :func:`~repro_torch.cluster.runtime.trace.replay_trace` feeds back
through the engine.  Handlers mutate state without awaiting (sends are
buffered synchronously), so each recorded event is atomic and the recorded
order *is* the decision order.

:class:`Runtime` is the one-call facade: spawn workers (threads or real
subprocesses), run a workload under a
:class:`~repro_torch.cluster.scenario.Scenario`, return a :class:`LiveReport`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..._device import resolve_device
from ..control import SpeculativePolicy
from ..master import JobRecord
from ..scenario import UNSET, Scenario, resolve_scenario
from ..scheduler import JobPlan
from .chaos import WIRE_DELAY, WIRE_DROP, WIRE_DUP, WIRE_PASS, FaultInjector
from .protocol import read_msg, send_nowait
from .trace import TICK, TraceRecorder, quantize, read_journal, trace_accounting
from .worker import spawn_worker_subprocess, spawn_worker_thread

__all__ = ["LiveJob", "LiveReport", "Runtime", "RuntimeMaster"]


@dataclasses.dataclass(frozen=True)
class LiveJob:
    """One live job: real task payloads instead of a service-time law.

    ``costs[i]`` is task i's nominal cost (seconds of sleep / compute);
    batch ``b`` of B executes tasks ``costs[b::B]``.  ``plan`` carries the
    same per-job :class:`~repro_torch.cluster.scheduler.JobPlan` overrides the
    engine honours under the gang regime (``n_batches``,
    ``cancel_redundant``).  ``arrival`` is an offset in seconds from the
    run's start at which the job is submitted.
    """

    job_id: int
    costs: Tuple[float, ...]
    payload: str = "sleep"
    arrival: float = 0.0
    name: str = ""
    plan: Optional[JobPlan] = None
    # worker wid scales its real execution by (1 + wid * skew): cheap
    # stand-in for machines whose true speeds the master does not know --
    # the straggler spread that makes cancellation reclaim real time
    skew: float = 0.0

    @property
    def n_tasks(self) -> int:
        """How many tasks this job carries."""
        return len(self.costs)

    def batch_costs(self, batch: int, n_batches: int) -> Tuple[float, ...]:
        """Costs of the tasks landing in ``batch`` under a round-robin split into B."""
        return tuple(self.costs[batch::n_batches])


@dataclasses.dataclass
class LiveReport:
    """Outcome of one live run: the engine-report surface plus the trace."""

    records: List[JobRecord]
    worker_seconds: float
    cancelled_seconds_saved: float
    n_worker_failures: int
    n_replicas_rescued: int
    trace: tuple
    completion_order: Tuple[int, ...]
    n_speculative: int = 0
    n_task_failures: int = 0
    n_retries: int = 0
    # (job, batch, wid, traceback text) for every stamped task_fail -- the
    # evidence a raising payload surfaces to the caller; live-only detail,
    # deliberately outside accounting()
    task_errors: Tuple[Tuple[int, int, int, str], ...] = ()

    def accounting(self) -> dict:
        """Same key set as :meth:`~repro_torch.cluster.master.EngineReport.accounting`."""
        return {
            "worker_seconds": float(self.worker_seconds),
            "cancelled_seconds_saved": float(self.cancelled_seconds_saved),
            "n_worker_failures": int(self.n_worker_failures),
            "n_replicas_rescued": int(self.n_replicas_rescued),
            "n_replans": 0,
            "n_speculative": int(self.n_speculative),
            "n_task_failures": int(self.n_task_failures),
            "n_retries": int(self.n_retries),
        }


@dataclasses.dataclass
class _LiveWorker:
    wid: int
    # None for the disconnected stubs a recovered master rebuilds from the
    # journal: the slot exists (its wid, epoch, and accounting history are
    # live) but nothing can be sent until a fresh worker re-joins it
    writer: Optional[asyncio.StreamWriter]
    pid: int
    alive: bool = True
    assignment: Optional[Tuple[int, int]] = None  # (job_id, batch)
    # the assignment's dispatch carries an injected payload raise (FaultPlan)
    raise_pending: bool = False
    epoch: int = 0
    busy_since: float = 0.0
    scheduled_end: float = math.inf
    last_hb: float = 0.0  # raw monotonic, detection only
    lease_deadline: float = math.inf  # raw monotonic, detection only
    # latest heartbeat-reported progress fraction for the CURRENT assignment
    # (None until the worker proves it is actually executing the replica)
    progress: Optional[float] = None

    @property
    def free(self) -> bool:
        # a recovered stub (writer None) is not dispatchable until it re-joins
        return self.alive and self.assignment is None and self.writer is not None


@dataclasses.dataclass
class _LiveExec:
    job: LiveJob
    start: float
    n_batches: int
    replication: int
    cancel: bool
    done: Set[int] = dataclasses.field(default_factory=set)
    outstanding: Dict[int, Set[int]] = dataclasses.field(default_factory=dict)
    # completed sibling durations (the speculative policy's running median)
    # and the per-job backup budget consumed, mirroring the engine's _JobExec
    obs: List[float] = dataclasses.field(default_factory=list)
    spec_used: int = 0

    @property
    def complete(self) -> bool:
        return len(self.done) == self.n_batches


def _validate_runtime_scenario(sc: Scenario, n_workers: int) -> Scenario:
    """The runtime's slice of the one validation path.

    Shares :meth:`Scenario.validate` (live-backend rules, which admit
    ``retry`` and ``faults``), then rejects the simulation-only knobs: the
    live gang has real speeds and real churn, and space sharing / online
    replanning are not implemented yet.
    """
    sc.validate(n_workers=n_workers, backend="live")
    if sc.is_space:
        raise ValueError(
            "Scenario.scheduler/workers_per_job/job_plans: the live runtime "
            "runs the whole-cluster FIFO gang only (per-job plans ride on "
            "LiveJob.plan); space-sharing schedulers are simulation-only"
        )
    for knob in ("speeds", "churn", "churn_schedule", "replan"):
        if getattr(sc, knob) is not None:
            raise ValueError(
                f"Scenario.{knob}: simulation-only -- the live runtime "
                "measures real worker speeds and real failures"
            )
    return sc


class RuntimeMaster:
    """The asyncio master service.  See the module docstring for semantics.

    Lifecycle: ``await start()`` (returns the bound port), spawn workers at
    it, ``await wait_for_workers()``, ``await run(jobs)``, ``await close()``.

    With ``journal=`` every trace event is additionally appended (fsynced)
    to a JSONL write-ahead journal; after a crash,
    :meth:`RuntimeMaster.recover` rebuilds an equivalent master from that
    file and :meth:`resume` finishes the run with re-joined workers.
    """

    def __init__(
        self,
        n_workers: int,
        scenario: Optional[Scenario] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_s: float = 0.05,
        heartbeat_timeout_s: float = 0.5,
        lease_factor: float = 8.0,
        lease_floor_s: float = 2.0,
        journal: Optional[str] = None,
        n_batches=UNSET,
        cancel_redundant=UNSET,
        speculation=UNSET,
        _resume_events: Optional[list] = None,
    ):
        sc = resolve_scenario(
            scenario,
            {
                "n_batches": n_batches,
                "cancel_redundant": cancel_redundant,
                "speculation": speculation,
            },
            where="RuntimeMaster",
        )
        self.scenario = _validate_runtime_scenario(sc, n_workers)
        self.n_workers = int(n_workers)
        self.host = host
        self._port_req = int(port)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.lease_factor = float(lease_factor)
        self.lease_floor_s = float(lease_floor_s)

        self.recorder = TraceRecorder(journal=journal, resume_events=_resume_events)
        if _resume_events is None:
            # first trace event: the originating scenario + worker budget, so
            # a trace file alone is replayable (replay_trace re-reads it when
            # the caller passes neither n_workers nor scenario)
            self.recorder.record(
                "scenario",
                self.recorder.stamp(),
                n_workers=self.n_workers,
                scenario=self.scenario.to_dict(),
            )
        self.workers: List[_LiveWorker] = []
        self.queue: List[LiveJob] = []
        self.active: Dict[int, _LiveExec] = {}
        self.rescue: List[Tuple[int, int]] = []
        self.records: List[JobRecord] = []
        self.completion_order: List[int] = []
        self._arrival_stamp: Dict[int, float] = {}

        self._ws = 0.0
        self._saved = 0.0
        self._n_failures = 0
        self._n_rescued = 0
        self._n_spec = 0
        self._n_task_failures = 0
        self._n_retries = 0
        self.task_errors: List[Tuple[int, int, int, str]] = []
        self._spec_policy = (
            SpeculativePolicy(self.scenario.speculation)
            if self.scenario.speculation is not None
            else None
        )
        # retry machinery (mirrors ClusterEngine): attempts per (job, batch),
        # armed backoff entries (release, seq, job, batch, attempt), and the
        # batches whose next rescue-dispatch is a retry (for counting)
        self._attempts: Dict[Tuple[int, int], int] = {}
        self._pending_retries: List[Tuple[float, int, int, int, int]] = []
        self._retry_seq = 0
        self._retry_batches: Set[Tuple[int, int]] = set()
        self._chaos = FaultInjector(self.scenario.faults) if self.scenario.faults else None
        self._n_jobs_expected = 0
        self._finalized = False
        self._crashed = False
        self._server: Optional[asyncio.base_events.Server] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._spec_task: Optional[asyncio.Task] = None
        self._chaos_task: Optional[asyncio.Task] = None
        self._all_joined = asyncio.Event()
        self._done = asyncio.Event()
        self._ran = False
        self._recovered = _resume_events is not None
        if _resume_events is not None:
            self._rebuild(_resume_events)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> int:
        """Bind the socket, arm the background loops, return the bound port."""
        self._server = await asyncio.start_server(self._handle_conn, self.host, self._port_req)
        self.port = self._server.sockets[0].getsockname()[1]
        self._watchdog_task = asyncio.ensure_future(self._watchdog())
        if self._spec_policy is not None:
            self._spec_task = asyncio.ensure_future(self._spec_loop())
        if self._chaos is not None:
            self._chaos_task = asyncio.ensure_future(self._chaos_loop())
        return self.port

    async def wait_for_workers(self, timeout_s: float = 30.0) -> None:
        """Block until every expected worker has joined."""
        await asyncio.wait_for(self._all_joined.wait(), timeout_s)

    async def run(self, jobs: Sequence[LiveJob], timeout_s: float = 120.0) -> LiveReport:
        """Submit ``jobs`` at their arrival offsets and run to completion."""
        if self._ran:
            raise RuntimeError("RuntimeMaster.run() is single-shot; construct a new master")
        if self._recovered:
            raise RuntimeError("a recovered master resumes its journaled jobs: call resume()")
        self._ran = True
        self._n_jobs_expected = len(jobs)
        if not jobs:
            self._finalize(self.recorder.stamp())
        for job in sorted(jobs, key=lambda j: (j.arrival, j.job_id)):
            delay = job.arrival - self.recorder.elapsed()
            if delay > 0:
                await asyncio.sleep(delay)
            self._on_submit(job)
        await asyncio.wait_for(self._done.wait(), timeout_s)
        return self._report()

    async def resume(self, timeout_s: float = 120.0) -> LiveReport:
        """Finish a recovered run: re-arm the backoff timers that were in
        flight at the crash and wait for the journaled jobs to complete.
        Call after ``start()`` (workers re-join the recovered wids and pick
        up the rescue backlog the crash left behind).
        """
        if not self._recovered:
            raise RuntimeError("resume() only applies to RuntimeMaster.recover() masters")
        if self._ran:
            raise RuntimeError("RuntimeMaster.resume() is single-shot")
        self._ran = True
        loop = asyncio.get_running_loop()
        for entry in list(self._pending_retries):
            loop.call_later(max(0.0, entry[0] - self.recorder.elapsed()), self._fire_retry, entry)
        if not self._finalized and len(self.records) == self._n_jobs_expected:
            self._finalize(self.recorder.stamp())
        await asyncio.wait_for(self._done.wait(), timeout_s)
        return self._report()

    def _report(self) -> LiveReport:
        return LiveReport(
            records=sorted(self.records, key=lambda r: r.job_id),
            worker_seconds=self._ws,
            cancelled_seconds_saved=self._saved,
            n_worker_failures=self._n_failures,
            n_replicas_rescued=self._n_rescued,
            trace=self.recorder.events,
            completion_order=tuple(self.completion_order),
            n_speculative=self._n_spec,
            n_task_failures=self._n_task_failures,
            n_retries=self._n_retries,
            task_errors=tuple(self.task_errors),
        )

    async def close(self) -> None:
        """Orderly shutdown: cancel loops, wave workers off, close the journal."""
        for t in (self._watchdog_task, self._spec_task, self._chaos_task):
            if t is not None:
                t.cancel()
        for w in self.workers:
            if w.writer is None:
                continue
            try:
                send_nowait(w.writer, {"type": "shutdown"})
            except (ConnectionError, RuntimeError):
                pass
            w.writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.recorder.close_journal()

    async def crash(self) -> None:
        """Die abruptly, as a real master crash would: no shutdown frames, no
        finalize, no flush accounting -- just torn sockets and a journal that
        ends mid-run.  The chaos harness's stand-in for ``kill -9`` on the
        master process; :meth:`recover` rebuilds from the journal.  Nothing
        is recorded from here on, not even the EOFs of the torn sockets.
        """
        self._crashed = True
        self._pending_retries.clear()  # armed timers no-op via membership check
        for t in (self._watchdog_task, self._spec_task, self._chaos_task):
            if t is not None:
                t.cancel()
        for w in self.workers:
            if w.writer is not None:
                w.writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.recorder.close_journal()

    # -- connection handling -------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        msg = await read_msg(reader)
        if msg is None or msg.get("type") != "register":
            writer.close()
            return
        worker = self._grant_registration(writer, int(msg.get("pid", -1)))
        if worker is None:
            writer.close()
            return
        while True:
            msg = await read_msg(reader)
            if worker.writer is not writer:
                # this connection's registration was retired by a re-join:
                # whatever the stale socket still delivers (late heartbeats,
                # its eventual EOF) must not touch the fresh registration
                writer.close()
                return
            if msg is None:
                self._fail(worker, "eof")
                return
            if self._chaos is not None and not (self._finalized or self._crashed):
                if msg["type"] == "hb":
                    # a stalled window swallows heartbeats wholesale (before
                    # the wire layer -- the stall models the worker not
                    # sending, not the network losing frames)
                    win = self._chaos.stalled_window(worker.wid, self.recorder.elapsed())
                    if win is not None:
                        if self._chaos.stall_needs_stamp(win):
                            self.recorder.record(
                                "chaos",
                                self.recorder.stamp(),
                                kind="hb_stall",
                                wid=worker.wid,
                                window=win,
                            )
                        continue
                verdict = self._chaos.wire("in")
                if verdict != WIRE_PASS:
                    self.recorder.record(
                        "chaos",
                        self.recorder.stamp(),
                        kind=verdict,
                        dir="in",
                        wid=worker.wid,
                        msg=msg["type"],
                    )
                    if verdict == WIRE_DROP:
                        continue
                    if verdict == WIRE_DELAY:
                        asyncio.get_running_loop().call_later(
                            self._chaos.plan.delay_s, self._process_frame, worker, writer, msg
                        )
                        continue
                    self._process_frame(worker, writer, msg)  # dup: extra copy
            self._process_frame(worker, writer, msg)

    def _process_frame(self, worker: _LiveWorker, writer, msg: dict) -> None:
        """Apply one inbound frame.  Separated from the read loop so the
        chaos layer can duplicate or delay delivery; the ``writer`` identity
        guard keeps delayed frames from a retired connection away from a
        re-joined registration."""
        if self._crashed or worker.writer is not writer:
            return
        kind = msg["type"]
        if kind == "hb":
            if not worker.alive:
                return
            worker.last_hb = time.monotonic()
            if (
                worker.assignment is not None
                and msg.get("job") == worker.assignment[0]
                and msg.get("batch") == worker.assignment[1]
                and msg.get("epoch") == worker.epoch
            ):
                worker.progress = float(msg.get("frac", 0.0))
        elif kind == "finish":
            self._on_finish(worker, msg)
        elif kind == "fail":
            self._on_task_fail(worker, msg)

    def _grant_registration(self, writer, pid: int) -> Optional[_LiveWorker]:
        """Admit a registering connection: fresh wid, re-joined slot, or None.

        Below the worker budget, registrations fill fresh wids exactly as
        before.  At budget, a new connection may *re-join*: if some worker
        is dead, its stale registration is retired (socket closed at failure
        time, epoch already bumped so in-flight messages stay stale) and its
        wid granted to the newcomer, which becomes dispatchable immediately
        -- pending rescues first, then the gang, like any capacity gain.
        The re-join is stamped as a ``join`` event, which
        :func:`~repro_torch.cluster.runtime.trace.replay_trace` feeds to the
        engine as an up-transition on the shared churn timeline, so the
        digital twin replays the recovery exactly.  Registrations after the
        run finalized (or with every wid alive) are refused.
        """
        if self._finalized:
            return None
        if len(self.workers) < self.n_workers:
            worker = _LiveWorker(
                wid=len(self.workers),
                writer=writer,
                pid=pid,
                last_hb=time.monotonic(),
            )
            self.workers.append(worker)
            self.recorder.record("join", self.recorder.stamp(), wid=worker.wid, pid=worker.pid)
            send_nowait(writer, self._welcome(worker.wid))
            if len(self.workers) == self.n_workers:
                self._all_joined.set()
            return worker
        worker = next((w for w in self.workers if not w.alive), None)
        if worker is None:
            return None
        worker.writer = writer
        worker.pid = pid
        worker.alive = True
        worker.assignment = None
        worker.scheduled_end = math.inf
        worker.lease_deadline = math.inf
        worker.progress = None
        worker.last_hb = time.monotonic()
        now = self.recorder.stamp()
        self.recorder.record("join", now, wid=worker.wid, pid=worker.pid)
        send_nowait(writer, self._welcome(worker.wid))
        if all(w.alive and w.writer is not None for w in self.workers):
            self._all_joined.set()  # a recovered master's full complement re-joined
        self._assign_rescues(now)
        self._try_dispatch(now)
        return worker

    def _welcome(self, wid: int) -> dict:
        return {
            "type": "welcome",
            "wid": wid,
            "heartbeat_s": self.heartbeat_s,
            # seed the worker-side heartbeat jitter deterministically per plan
            "hb_seed": self.scenario.faults.seed if self.scenario.faults is not None else 0,
        }

    async def _watchdog(self) -> None:
        """Missed-heartbeat and blown-lease detection."""
        period = max(self.heartbeat_timeout_s / 4.0, 0.01)
        while True:
            await asyncio.sleep(period)
            now_m = time.monotonic()
            for w in self.workers:
                if not w.alive:
                    continue
                if now_m - w.last_hb > self.heartbeat_timeout_s:
                    self._fail(w, "heartbeat")
                elif w.assignment is not None and now_m > w.lease_deadline:
                    self._fail(w, "lease")

    async def _chaos_loop(self) -> None:
        """Deliver the FaultPlan's scheduled kills: tear the victim's
        connection (the read loop then fails it with cause ``eof``, exactly
        like a real worker death).  Each delivery is stamped as a ``chaos``
        event so recovery never re-kills."""
        while True:
            await asyncio.sleep(0.01)
            if self._finalized or self._crashed:
                continue
            for wid in self._chaos.due_kills(self.recorder.elapsed()):
                w = self.workers[wid] if wid < len(self.workers) else None
                if w is None:
                    continue  # not yet joined; retry next tick
                if not w.alive or w.writer is None:
                    self._chaos.mark_killed(wid)  # already dead: kill is a no-op
                    continue
                self._deliver_kill(w)

    def _deliver_kill(self, w: _LiveWorker) -> None:
        """Kill ``w`` as the FaultPlan does: mark the kill delivered, stamp
        it, and tear the connection."""
        self._chaos.mark_killed(w.wid)
        self.recorder.record("chaos", self.recorder.stamp(), kind="kill", wid=w.wid)
        w.writer.close()

    # -- speculative backups (reactive replication, engine-aligned) ----------

    async def _spec_loop(self) -> None:
        """Heartbeat-epoch timer for the speculative policy: every interval,
        look for a laggard and back at most one up (one stamped launch per
        firing, the engine's rule)."""
        interval = self.scenario.speculation.interval
        while True:
            await asyncio.sleep(interval)
            if not self._finalized:
                self._spec_check()

    def _spec_check(self) -> None:
        """Launch at most ONE backup: the first lagging (job, batch) in
        sorted order, on the lowest-wid free worker -- decision-for-decision
        the engine's ``_on_spec_check``, evaluated at one grid stamp so
        :func:`~repro_torch.cluster.runtime.trace.replay_trace` can feed the stamp
        to the engine as a scripted ``speculation_times`` epoch and re-derive
        the identical launch.

        On top of the engine's policy the live master demands *partial
        progress*: every outstanding replica of the laggard must have
        heartbeat-reported progress on its current assignment.  A replica
        that never reported is the failure detector's problem, not the
        speculator's.  The gate only suppresses a launch (no stamp, so the
        replay never checks it); it can never redirect one, which is what
        keeps the scripted replay exact.
        """
        cfg, pol = self.scenario.speculation, self._spec_policy
        now = self.recorder.stamp()
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
                y = max(self.workers[w].busy_since for w in wids)
                if not pol.lagging(now - y, med):
                    continue
                if any(self.workers[w].progress is None for w in wids):
                    return  # laggard found but unproven: no launch this epoch
                free = self._free_workers()
                if not free:
                    return
                jexec.spec_used += 1
                self._n_spec += 1
                self._assign(free[0], jexec, batch, now, rescue=False, spec=True)
                return

    # -- plan resolution (the engine's precedence, verbatim) -----------------

    def _choose_B(self, job: LiveJob, n_avail: int) -> int:
        if job.plan is not None and job.plan.n_batches is not None:
            b = job.plan.n_batches
        elif self.scenario.n_batches is not None:
            b = self.scenario.n_batches
        else:
            b = n_avail
        return max(1, min(int(b), n_avail))

    def _job_cancel(self, job: LiveJob) -> bool:
        if job.plan is not None and job.plan.cancel_redundant is not None:
            return bool(job.plan.cancel_redundant)
        return self.scenario.cancel_redundant

    # -- event handlers (one stamp each, mirroring the engine) ---------------

    def _on_submit(self, job: LiveJob) -> None:
        now = self.recorder.stamp()
        plan = None
        if job.plan is not None:
            plan = {
                "workers": job.plan.workers,
                "n_batches": job.plan.n_batches,
                "cancel_redundant": job.plan.cancel_redundant,
            }
        self.recorder.record(
            "submit",
            now,
            job=job.job_id,
            n_tasks=job.n_tasks,
            plan=plan,
            name=job.name,
            # the full job definition rides on the journal so recover() can
            # re-dispatch work the crash left queued or in flight
            costs=list(job.costs),
            payload=job.payload,
            skew=job.skew,
        )
        self._arrival_stamp[job.job_id] = now
        self.queue.append(job)
        self._assign_rescues(now)
        self._try_dispatch(now)

    def _on_finish(self, worker: _LiveWorker, msg: dict) -> None:
        job_id, batch = int(msg["job"]), int(msg["batch"])
        if (
            self._finalized
            or not worker.alive
            or int(msg["epoch"]) != worker.epoch
            or worker.assignment != (job_id, batch)
        ):
            return  # stale: cancelled, superseded, or the run already ended
        now = self.recorder.stamp()
        self.recorder.record("finish", now, wid=worker.wid, job=job_id, batch=batch)
        self._release(worker, now)
        jexec = self.active.get(job_id)
        if jexec is None:
            # the job already covered; this straggler ran to completion
            self._assign_rescues(now)
            self._try_dispatch(now)
            return
        jexec.outstanding[batch].discard(worker.wid)
        if batch not in jexec.done:
            jexec.done.add(batch)
            # the batch's first completion is a sibling-duration observation
            # for the speculative policy's running median (engine-identical:
            # grid-stamped finish minus grid-stamped dispatch)
            jexec.obs.append(now - worker.busy_since)
            if jexec.cancel:
                for sib_wid in sorted(jexec.outstanding[batch]):
                    self._cancel_replica(self.workers[sib_wid], now)
                jexec.outstanding[batch].clear()
            if jexec.complete:
                self._finish_job(jexec, now)
        if not self._finalized:
            self._assign_rescues(now)
            self._try_dispatch(now)

    def _fail(self, worker: _LiveWorker, cause: str) -> None:
        # a crashed master records nothing more: the EOFs its own torn
        # sockets raise while crash() waits for the server to close are not
        # worker failures (recover() stamps those workers cause="crash")
        if self._finalized or self._crashed or not worker.alive:
            return
        now = self.recorder.stamp()
        self.recorder.record("fail", now, wid=worker.wid, cause=cause)
        self._n_failures += 1
        if worker.assignment is not None:
            job_id, batch = worker.assignment
            if worker.raise_pending:
                # the injected raise died with its worker before it ran out:
                # the plan's next dispatch of this batch carries it (journaled,
                # so a recovered master gives it back too)
                worker.raise_pending = False
                self._chaos.rearm_raise(job_id, batch)
                self.recorder.record("chaos", now, kind="rearm", job=job_id, batch=batch,
                                     wid=worker.wid)
            self._ws += now - worker.busy_since
            jexec = self.active.get(job_id)
            if jexec is not None:
                jexec.outstanding[batch].discard(worker.wid)
                if batch not in jexec.done and not jexec.outstanding[batch]:
                    self.rescue.append((job_id, batch))
            worker.assignment = None
            worker.scheduled_end = math.inf
        worker.alive = False
        worker.epoch += 1
        if worker.writer is not None:  # recovery's crash-fail has no socket
            worker.writer.close()
        self._assign_rescues(now)
        self._try_dispatch(now)

    # -- task failure, retry, abandonment (mirroring the engine) -------------

    def _on_task_fail(self, worker: _LiveWorker, msg: dict) -> None:
        """A ``fail`` frame: the payload raised on the worker.  The replica is
        released (its worker-seconds are real and spent); if the batch is
        still wanted, the retry budget arms a backoff timer, and when the
        budget is exhausted with nothing else in flight the job is abandoned
        (recorded with ``finish=inf``), the engine's rule exactly."""
        job_id, batch = int(msg["job"]), int(msg["batch"])
        if (
            self._finalized
            or not worker.alive
            or int(msg["epoch"]) != worker.epoch
            or worker.assignment != (job_id, batch)
        ):
            return
        now = self.recorder.stamp()
        self._n_task_failures += 1
        err = str(msg.get("error", ""))[:2000]
        self.task_errors.append((job_id, batch, worker.wid, err))
        self._release(worker, now)
        jexec = self.active.get(job_id)
        attempt = 0
        if jexec is not None and batch not in jexec.done:
            attempt = self._attempts.get((job_id, batch), 0) + 1
            self._attempts[(job_id, batch)] = attempt
        self.recorder.record(
            "task_fail", now, wid=worker.wid, job=job_id, batch=batch, attempt=attempt, error=err
        )
        if jexec is not None:
            jexec.outstanding[batch].discard(worker.wid)
            if batch not in jexec.done:
                retry = self.scenario.retry
                if retry is not None and attempt <= retry.max_attempts:
                    self._retry_seq += 1
                    entry = (now + retry.backoff(attempt), self._retry_seq, job_id, batch, attempt)
                    self._pending_retries.append(entry)
                    asyncio.get_running_loop().call_later(
                        max(0.0, entry[0] - self.recorder.elapsed()), self._fire_retry, entry
                    )
                elif not jexec.outstanding[batch] and not any(
                    j == job_id and b == batch for _, _, j, b, _ in self._pending_retries
                ):
                    self._abandon_job(jexec, now)
        if not self._finalized:
            self._assign_rescues(now)
            self._try_dispatch(now)

    def _fire_retry(self, entry: Tuple[float, int, int, int, int]) -> None:
        """Backoff timer fired: release the batch into the rescue queue and
        stamp a ``retry`` event (the stamp is what the engine's scripted
        ``retry_times`` consumes on replay).  Timers fire in (release, seq)
        order, matching the engine's min-heap pop of pending retries."""
        if entry not in self._pending_retries:
            return  # consumed by recovery rebuild, finalize, or job teardown
        self._pending_retries.remove(entry)
        if self._finalized or self._crashed:
            return
        _release_t, _seq, job_id, batch, attempt = entry
        jexec = self.active.get(job_id)
        if jexec is None or batch in jexec.done:
            return
        now = self.recorder.stamp()
        self.recorder.record("retry", now, job=job_id, batch=batch, attempt=attempt)
        self._retry_batches.add((job_id, batch))
        self.rescue.append((job_id, batch))
        self._assign_rescues(now)
        self._try_dispatch(now)

    def _abandon_job(self, jexec: _LiveExec, now: float) -> None:
        """Retry budget exhausted with no replica left in flight: the job
        fails permanently.  Recorded with ``finish=inf`` so makespan summaries
        are poisoned rather than silently truncated."""
        job = jexec.job
        self.records.append(
            JobRecord(
                job_id=job.job_id,
                name=job.name,
                arrival=self._arrival_stamp[job.job_id],
                start=jexec.start,
                finish=math.inf,
                n_batches=jexec.n_batches,
                replication=jexec.replication,
            )
        )
        self.completion_order.append(job.job_id)
        self.recorder.record(
            "job_fail",
            now,
            job=job.job_id,
            start=jexec.start,
            n_batches=jexec.n_batches,
            replication=jexec.replication,
        )
        del self.active[job.job_id]
        self._drop_retry_state(job.job_id)
        if len(self.records) == self._n_jobs_expected:
            self._finalize(now)

    def _drop_retry_state(self, job_id: int) -> None:
        self.rescue = [(j, b) for (j, b) in self.rescue if j != job_id]
        self._pending_retries = [e for e in self._pending_retries if e[2] != job_id]
        self._retry_batches = {(j, b) for (j, b) in self._retry_batches if j != job_id}

    # -- dispatch (the engine's gang loop, verbatim) -------------------------

    def _free_workers(self) -> List[_LiveWorker]:
        return [w for w in self.workers if w.free]  # wid order by construction

    def _try_dispatch(self, now: float) -> None:
        while self.queue and not self.active:
            n_alive = sum(1 for w in self.workers if w.alive)
            free = self._free_workers()
            if n_alive == 0 or len(free) < n_alive:
                return
            job = self.queue.pop(0)
            b = self._choose_B(job, n_alive)
            r = n_alive // b
            jexec = _LiveExec(
                job=job,
                start=now,
                n_batches=b,
                replication=r,
                cancel=self._job_cancel(job),
            )
            self.active[job.job_id] = jexec
            # journaled before its dispatches so recover() can rebuild the
            # execution (B, r, cancel are derived from the *crashed* master's
            # alive count, which the recovered one must honour); replay and
            # the accounting fold ignore it
            self.recorder.record(
                "job_start",
                now,
                job=job.job_id,
                n_batches=b,
                replication=r,
                cancel=jexec.cancel,
            )
            for idx, worker in enumerate(free[: b * r]):
                self._assign(worker, jexec, idx % b, now, rescue=False)

    def _assign_rescues(self, now: float) -> None:
        while self.rescue:
            free = self._free_workers()
            if not free:
                return
            job_id, batch = self.rescue.pop(0)
            jexec = self.active.get(job_id)
            if jexec is None or batch in jexec.done:
                continue
            retry = (job_id, batch) in self._retry_batches
            self._retry_batches.discard((job_id, batch))
            self._assign(free[0], jexec, batch, now, rescue=True, retry=retry)
            if retry:
                self._n_retries += 1
            else:
                self._n_rescued += 1

    def _assign(
        self,
        worker: _LiveWorker,
        jexec: _LiveExec,
        batch: int,
        now: float,
        *,
        rescue: bool,
        spec: bool = False,
        retry: bool = False,
    ) -> None:
        costs = jexec.job.batch_costs(batch, jexec.n_batches)
        # per-replica expectation: the master schedules with the worker's
        # speed factor (it would measure one on a real cluster), so a batch's
        # replicas get distinct scheduled ends -- the slack that cancellation
        # reclaims and that lease deadlines must respect
        planned = quantize(sum(costs) * (1.0 + worker.wid * jexec.job.skew))
        worker.assignment = (jexec.job.job_id, batch)
        worker.busy_since = now
        worker.scheduled_end = now + planned
        worker.progress = None
        worker.lease_deadline = time.monotonic() + max(
            self.lease_floor_s, planned * self.lease_factor
        )
        jexec.outstanding.setdefault(batch, set()).add(worker.wid)
        self.recorder.record(
            "dispatch",
            now,
            wid=worker.wid,
            job=jexec.job.job_id,
            batch=batch,
            planned=planned,
            rescue=rescue,
            spec=spec,
            retry=retry,
        )
        frame = {
            "type": "task",
            "job": jexec.job.job_id,
            "batch": batch,
            "epoch": worker.epoch,
            "payload": jexec.job.payload,
            "costs": list(costs),
            "skew": jexec.job.skew,
            "lease_s": max(self.lease_floor_s, planned * self.lease_factor),
        }
        if self._chaos is not None:
            # dispatch-time chaos rides on the frame itself: the slowdown only
            # stretches real execution (the trace's finish stamp captures it),
            # while an injected raise is journaled so recovery keeps the
            # delivered-raises count
            factor = self._chaos.slow_factor(worker.wid, now)
            if factor != 1.0:
                frame["chaos_factor"] = factor
            worker.raise_pending = self._chaos.payload_raise(jexec.job.job_id, batch)
            if worker.raise_pending:
                frame["chaos_raise"] = True
                self.recorder.record(
                    "chaos", now, kind="raise", job=jexec.job.job_id, batch=batch,
                    wid=worker.wid,
                )
        self._send(worker, frame)

    def _send(self, worker: _LiveWorker, frame: dict) -> None:
        """Outbound frames pass the wire-chaos layer (task/cancel only --
        registration traffic stays reliable, or nothing could ever join)."""
        if worker.writer is None:
            return
        if self._chaos is not None and not (self._finalized or self._crashed):
            verdict = self._chaos.wire("out")
            if verdict != WIRE_PASS:
                self.recorder.record(
                    "chaos",
                    self.recorder.stamp(),
                    kind=verdict,
                    dir="out",
                    wid=worker.wid,
                    msg=frame["type"],
                )
                if verdict == WIRE_DROP:
                    return
                if verdict == WIRE_DELAY:
                    asyncio.get_running_loop().call_later(
                        self._chaos.plan.delay_s,
                        self._deliver_later,
                        worker,
                        frame,
                        worker.epoch,
                    )
                    return
                self._send_raw(worker, frame)  # dup: extra copy
        self._send_raw(worker, frame)

    def _send_raw(self, worker: _LiveWorker, frame: dict) -> None:
        if worker.writer is None:
            return
        try:
            send_nowait(worker.writer, frame)
        except (ConnectionError, RuntimeError, OSError):
            pass  # torn transport: failure detection owns this worker now

    def _deliver_later(self, worker: _LiveWorker, frame: dict, epoch: int) -> None:
        # a delayed frame is dropped if its addressee's registration moved on
        # (failed, cancelled, re-joined): the dispatch it carried is stale
        if self._crashed or not worker.alive or worker.epoch != epoch:
            return
        self._send_raw(worker, frame)

    # -- accounting transitions ----------------------------------------------

    def _release(self, worker: _LiveWorker, now: float) -> None:
        self._ws += now - worker.busy_since
        worker.assignment = None
        worker.scheduled_end = math.inf
        worker.lease_deadline = math.inf
        worker.progress = None

    def _cancel_replica(self, sib: _LiveWorker, now: float) -> None:
        job_id, batch = sib.assignment
        # the effective scheduled end is pushed at least one tick past 'now'
        # so reclaimed time stays positive and the replay's event for this
        # replica pops strictly after the winner's (where it is stale)
        sched_end = max(sib.scheduled_end, now + TICK)
        self._saved += sched_end - now
        self.recorder.record(
            "cancel", now, wid=sib.wid, job=job_id, batch=batch, sched_end=sched_end
        )
        self._send(sib, {"type": "cancel", "job": job_id, "batch": batch, "epoch": sib.epoch})
        sib.epoch += 1  # the in-flight finish (if any) is now stale
        self._release(sib, now)

    def _finish_job(self, jexec: _LiveExec, now: float) -> None:
        job = jexec.job
        self.records.append(
            JobRecord(
                job_id=job.job_id,
                name=job.name,
                # the recorded submit stamp, not the requested offset: this is
                # the arrival the engine replay sees, so records match exactly
                arrival=self._arrival_stamp[job.job_id],
                start=jexec.start,
                finish=now,
                n_batches=jexec.n_batches,
                replication=jexec.replication,
            )
        )
        self.completion_order.append(job.job_id)
        self.recorder.record(
            "job_done",
            now,
            job=job.job_id,
            start=jexec.start,
            n_batches=jexec.n_batches,
            replication=jexec.replication,
        )
        del self.active[job.job_id]
        self._drop_retry_state(job.job_id)
        if len(self.records) == self._n_jobs_expected:
            self._finalize(now)

    def _finalize(self, now: float) -> None:
        """End of run: charge still-in-flight replicas their full planned
        duration (the engine's flush rule) and freeze the trace -- nothing
        that happens on the sockets after this instant is part of the run."""
        for worker in self.workers:
            if worker.alive and worker.assignment is not None:
                job_id, batch = worker.assignment
                self._ws += worker.scheduled_end - worker.busy_since
                self.recorder.record(
                    "flush",
                    now,
                    wid=worker.wid,
                    job=job_id,
                    batch=batch,
                    sched_end=worker.scheduled_end,
                )
                self._send_raw(
                    worker,
                    {"type": "cancel", "job": job_id, "batch": batch, "epoch": worker.epoch},
                )
                worker.epoch += 1
                worker.assignment = None
                worker.scheduled_end = math.inf
        self._finalized = True
        self._pending_retries.clear()  # armed timers no-op via membership check
        self.recorder.frozen = True
        self._done.set()

    # -- crash recovery ------------------------------------------------------

    @classmethod
    def recover(
        cls,
        journal_path: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_s: float = 0.05,
        heartbeat_timeout_s: float = 0.5,
        lease_factor: float = 8.0,
        lease_floor_s: float = 2.0,
    ) -> "RuntimeMaster":
        """Rebuild a master from a write-ahead journal left by a crash.

        The journal's scenario header supplies the configuration; folding the
        remaining events re-derives queued and in-flight jobs, leases,
        attempts, armed backoffs, and every accounting counter.  Workers that
        were alive at the crash are stamped as failed with cause ``crash``
        (their sockets died with the old master), which routes their batches
        through the ordinary rescue path; a ``recover`` event marks the seam.
        The rebuilt master appends to the *same* journal, so the finished
        file replays crash + recovery through the DES twin as one exact
        trace.  Continue with ``start()``, re-spawn workers, ``resume()``.
        """
        events = read_journal(journal_path)
        if not events or events[0].get("ev") != "scenario":
            raise ValueError(f"{journal_path}: not a runtime journal (no scenario header)")
        head = events[0]
        return cls(
            int(head["n_workers"]),
            Scenario.from_dict(head["scenario"]),
            host=host,
            port=port,
            heartbeat_s=heartbeat_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            lease_factor=lease_factor,
            lease_floor_s=lease_floor_s,
            journal=journal_path,
            _resume_events=events,
        )

    def _rebuild(self, events: Sequence[dict]) -> None:
        """Replay the journaled decisions over this master's (empty) state --
        each branch mirrors the live handler that recorded the event, minus
        sockets and counters (the counters come from the trace fold, the
        sockets from workers re-joining after ``start()``)."""
        jobs: Dict[int, LiveJob] = {}
        chaos_events: List[dict] = []
        for e in events:
            kind, t = e["ev"], e.get("t", 0.0)
            if kind == "join":
                if e["wid"] == len(self.workers):
                    self.workers.append(
                        _LiveWorker(wid=int(e["wid"]), writer=None, pid=int(e.get("pid", -1)))
                    )
                else:  # re-join of a failed wid
                    w = self.workers[e["wid"]]
                    w.alive = True
                    w.assignment = None
                    w.scheduled_end = math.inf
                    w.progress = None
            elif kind == "fail":
                w = self.workers[e["wid"]]
                if w.assignment is not None:
                    job_id, batch = w.assignment
                    jexec = self.active.get(job_id)
                    if jexec is not None:
                        jexec.outstanding[batch].discard(w.wid)
                        if batch not in jexec.done and not jexec.outstanding[batch]:
                            self.rescue.append((job_id, batch))
                    w.assignment = None
                    w.scheduled_end = math.inf
                w.alive = False
                w.epoch += 1
            elif kind == "submit":
                job = LiveJob(
                    job_id=int(e["job"]),
                    costs=tuple(e["costs"]),
                    payload=e["payload"],
                    arrival=t,
                    name=e.get("name", ""),
                    plan=JobPlan(**e["plan"]) if e.get("plan") else None,
                    skew=float(e.get("skew", 0.0)),
                )
                jobs[job.job_id] = job
                self._arrival_stamp[job.job_id] = t
                self.queue.append(job)
            elif kind == "job_start":
                self.queue = [j for j in self.queue if j.job_id != e["job"]]
                self.active[e["job"]] = _LiveExec(
                    job=jobs[e["job"]],
                    start=t,
                    n_batches=int(e["n_batches"]),
                    replication=int(e["replication"]),
                    cancel=bool(e["cancel"]),
                )
            elif kind == "dispatch":
                w = self.workers[e["wid"]]
                w.assignment = (int(e["job"]), int(e["batch"]))
                w.raise_pending = False
                w.busy_since = t
                w.scheduled_end = t + float(e["planned"])
                jexec = self.active[e["job"]]
                jexec.outstanding.setdefault(int(e["batch"]), set()).add(w.wid)
                if e.get("spec"):
                    jexec.spec_used += 1
                if e.get("retry"):
                    self._retry_batches.discard((int(e["job"]), int(e["batch"])))
                if e.get("rescue"):
                    # _assign_rescues consumes (and silently drops stale)
                    # entries from the head until it dispatches this one
                    while self.rescue:
                        if self.rescue.pop(0) == (int(e["job"]), int(e["batch"])):
                            break
            elif kind == "finish":
                w = self.workers[e["wid"]]
                since = w.busy_since
                w.assignment = None
                w.scheduled_end = math.inf
                jexec = self.active.get(e["job"])
                if jexec is not None:
                    batch = int(e["batch"])
                    jexec.outstanding[batch].discard(w.wid)
                    if batch not in jexec.done:
                        jexec.done.add(batch)
                        jexec.obs.append(t - since)
                        if jexec.cancel:
                            jexec.outstanding[batch].clear()
            elif kind == "cancel":
                w = self.workers[e["wid"]]
                w.epoch += 1
                w.assignment = None
                w.scheduled_end = math.inf
            elif kind == "task_fail":
                w = self.workers[e["wid"]]
                w.assignment = None
                w.scheduled_end = math.inf
                job_id, batch = int(e["job"]), int(e["batch"])
                self.task_errors.append((job_id, batch, w.wid, e.get("error", "")))
                jexec = self.active.get(job_id)
                if jexec is not None:
                    jexec.outstanding[batch].discard(w.wid)
                    if batch not in jexec.done:
                        attempt = self._attempts.get((job_id, batch), 0) + 1
                        self._attempts[(job_id, batch)] = attempt
                        retry = self.scenario.retry
                        if retry is not None and attempt <= retry.max_attempts:
                            self._retry_seq += 1
                            self._pending_retries.append(
                                (t + retry.backoff(attempt), self._retry_seq, job_id, batch,
                                 attempt)
                            )
            elif kind == "retry":
                job_id, batch = int(e["job"]), int(e["batch"])
                entry = min(p for p in self._pending_retries if p[2:4] == (job_id, batch))
                self._pending_retries.remove(entry)
                self._retry_batches.add((job_id, batch))
                self.rescue.append((job_id, batch))
            elif kind in ("job_done", "job_fail"):
                jexec = self.active.pop(e["job"])
                self.records.append(
                    JobRecord(
                        job_id=int(e["job"]),
                        name=jexec.job.name,
                        arrival=self._arrival_stamp[e["job"]],
                        start=float(e["start"]),
                        finish=t if kind == "job_done" else math.inf,
                        n_batches=int(e["n_batches"]),
                        replication=int(e["replication"]),
                    )
                )
                self.completion_order.append(int(e["job"]))
                self._drop_retry_state(int(e["job"]))
            elif kind == "flush":
                w = self.workers[e["wid"]]
                w.epoch += 1
                w.assignment = None
                w.scheduled_end = math.inf
            elif kind == "chaos":
                chaos_events.append(e)
                if e.get("kind") == "raise" and "wid" in e:
                    # the dispatch just journaled carries it: a crash-fail of
                    # its worker below gives it back
                    self.workers[e["wid"]].raise_pending = True
        self._n_jobs_expected = sum(1 for e in events if e["ev"] == "submit")
        if self._chaos is not None:
            self._chaos.restore(chaos_events)
        acct = trace_accounting(events)
        self._ws = acct["worker_seconds"]
        self._saved = acct["cancelled_seconds_saved"]
        self._n_failures = acct["n_worker_failures"]
        self._n_rescued = acct["n_replicas_rescued"]
        self._n_spec = acct["n_speculative"]
        self._n_task_failures = acct["n_task_failures"]
        self._n_retries = acct["n_retries"]
        if len(self.records) >= self._n_jobs_expected:
            return  # the journaled run had already completed; nothing to heal
        # every worker alive at the crash lost its socket with the old
        # master: declare each failed (cause "crash") so in-flight batches
        # take the ordinary rescue path, then mark the seam
        for w in self.workers:
            if w.alive:
                self._fail(w, "crash")
        self.recorder.record(
            "recover",
            self.recorder.stamp(),
            n_active=len(self.active),
            n_queued=len(self.queue),
            n_pending_retries=len(self._pending_retries),
        )


class Runtime:
    """One-call facade: spawn workers, execute a workload, return the report.

    ``spawn="thread"`` runs each worker in-process on its own thread and
    event loop (cheap, deterministic teardown); ``spawn="subprocess"`` forks
    real ``python -m repro_torch.cluster.runtime`` processes, which chaos
    tests can SIGKILL mid-task.  Either way the master talks to them over
    real localhost sockets -- the protocol path is identical.

    ``device`` is where the workers run a ``torch`` payload: the CUDA card
    unless the caller names one; without a card, constructing a ``Runtime``
    raises unless ``device="cpu"``.  The master itself runs no payload.
    """

    def __init__(
        self,
        n_workers: int,
        scenario: Optional[Scenario] = None,
        *,
        spawn: str = "thread",
        heartbeat_s: float = 0.05,
        heartbeat_timeout_s: float = 0.5,
        host: str = "127.0.0.1",
        journal: Optional[str] = None,
        n_batches=UNSET,
        cancel_redundant=UNSET,
        speculation=UNSET,
        device=None,
    ):
        if spawn not in ("thread", "subprocess"):
            raise ValueError(f"spawn must be 'thread' or 'subprocess', got {spawn!r}")
        self.n_workers = int(n_workers)
        self.scenario = resolve_scenario(
            scenario,
            {
                "n_batches": n_batches,
                "cancel_redundant": cancel_redundant,
                "speculation": speculation,
            },
            where="Runtime",
        )
        self.spawn = spawn
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.host = host
        self.journal = journal
        self.device = resolve_device(device)

    def run(self, jobs: Sequence[LiveJob], timeout_s: float = 120.0) -> LiveReport:
        """Synchronous wrapper around :meth:`run_async`."""
        return asyncio.run(self.run_async(jobs, timeout_s=timeout_s))

    async def run_async(self, jobs: Sequence[LiveJob], timeout_s: float = 120.0) -> LiveReport:
        """Start a master, spawn/await the workers, run ``jobs``, tear down."""
        master = RuntimeMaster(
            self.n_workers,
            self.scenario,
            host=self.host,
            heartbeat_s=self.heartbeat_s,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            journal=self.journal,
        )
        port = await master.start()
        spawner = spawn_worker_thread if self.spawn == "thread" else spawn_worker_subprocess
        handles = [spawner(self.host, port, self.device) for _ in range(self.n_workers)]
        try:
            await master.wait_for_workers()
            report = await master.run(jobs, timeout_s=timeout_s)
        finally:
            await master.close()
            for h in handles:
                if hasattr(h, "join"):
                    h.join(timeout=5.0)
                else:
                    try:
                        h.wait(timeout=5.0)
                    except Exception:
                        h.kill()
        # sanity: the master's own counters must agree with the trace fold
        acct = trace_accounting(report.trace)
        if acct != report.accounting():  # pragma: no cover - internal invariant
            raise RuntimeError(f"trace fold disagrees with live counters: {acct}")
        return report
