"""Live execution runtime: the DES engine's semantics against real processes.

A port of ``repro.cluster.runtime`` (protocol, chaos, trace, worker, master)
on the port's engine, scenario and scheduler.  Wire frames, trace events and
journals are the reference's, byte for byte and name for name, so a trace
written by either package replays through the other's engine, and either
master serves either package's workers.  Two differences: workers run a
fourth payload, ``torch`` (the ``numpy`` matmul chain on the worker's
device; every worker entry point takes ``device=``, the CUDA card unless
``"cpu"`` is named), and a crashed master journals nothing after its crash
(see :mod:`.master`), so recovery stamps the ``crash`` seam.

Everything else in :mod:`repro_torch.cluster` *simulates* a redundancy plan; this
subpackage *executes* one.  An asyncio master (:mod:`.master`) serves real
worker processes (:mod:`.worker`) over a length-prefixed JSON protocol on
localhost sockets (:mod:`.protocol`): worker registration, task leases with
deadlines, heartbeat tracking with missed-heartbeat failure detection, and
replica dispatch under the engine's exact FIFO-gang semantics --
``RedundancyPlan``/:class:`~repro_torch.cluster.scheduler.JobPlan` redundancy
levels, cancel-on-earliest-cover, and rescue re-dispatch when a worker dies
holding a batch's last replica.

The master records every state transition as a trace event
(:mod:`.trace`: ``join``/``submit``/``dispatch``/``finish``/``cancel``/
``fail``/``flush``/``job_done`` with timestamps and worker ids), stamped on
a binary time grid so all accounting arithmetic is exact, and
:func:`~repro_torch.cluster.runtime.trace.replay_trace` replays the identical
event schedule through the discrete-event :class:`~repro_torch.cluster.master.
ClusterEngine` -- the engine is the runtime's digital twin, and the
differential tests assert worker-seconds, saved-seconds, rescues, and
per-job completion records match *bit for bit*.

Scenario semantics come from the same frozen
:class:`~repro_torch.cluster.scenario.Scenario` the simulation entry points take:
``Runtime(n_workers, scenario=Scenario(n_batches=2, cancel_redundant=True))``
executes what ``sample_job_times(scenario=...)`` predicts.

Failure is a first-class input.  A serializable
:class:`~repro_torch.cluster.scenario.FaultPlan` on the scenario drives a
deterministic fault injector (:mod:`.chaos`): scheduled worker kills,
slowdowns, heartbeat stalls, injected payload exceptions, and seeded wire
drop/dup/delay -- every delivered fault stamped on the trace grid so the
twin replays the faulted run exactly.  A
:class:`~repro_torch.cluster.scenario.Retry` policy turns payload failures
(``fail`` frames carrying tracebacks) into capped-exponential-backoff
retries, then abandonment.  With ``journal=``, the recorder doubles as an
fsync'd JSONL write-ahead log and :meth:`RuntimeMaster.recover` rebuilds a
crashed master from it -- queued and in-flight jobs, leases, retry timers,
accounting -- resuming with re-joined workers; crash plus recovery replay
as one exact trace (``tests/test_chaos.py``).

This subpackage is *not* imported by ``repro_torch.cluster.__init__`` -- simulation
users never pay for the service stack; ``import repro_torch.cluster.runtime``
explicitly.
"""

from .chaos import FaultInjector
from .master import LiveJob, LiveReport, Runtime, RuntimeMaster
from .trace import TICK, TraceRecorder, read_journal, replay_trace, trace_accounting
from .worker import spawn_worker_subprocess, spawn_worker_thread, worker_loop

__all__ = [
    "FaultInjector",
    "LiveJob",
    "LiveReport",
    "Runtime",
    "RuntimeMaster",
    "TICK",
    "TraceRecorder",
    "read_journal",
    "replay_trace",
    "trace_accounting",
    "spawn_worker_subprocess",
    "spawn_worker_thread",
    "worker_loop",
]
