"""Worker process: executes real task payloads, streams heartbeats, honors
cancellation.

A copy of ``repro.cluster.runtime.worker`` for the port, with one payload
more and a device.  A worker owns one socket to the master and runs one batch
replica at a time.  Four payload kinds cover the behaviours the runtime tests
need:

* ``sleep``  -- ``asyncio.sleep`` for the batch's total cost: a perfectly
  cancellable stand-in for I/O-bound work.
* ``numpy``  -- real matmul work in small chunks with an ``await`` between
  chunks, so cancellation lands at chunk boundaries: CPU-bound but
  cooperative.  It stays host numpy whatever the worker's device.
* ``torch``  -- the ``numpy`` chain (``a = tanh(a @ a.T / 96)`` on a seeded
  96 x 96 float64 matrix) on the worker's device, one synchronise a step, so
  the deadline measures the device's time and a cancel leaves no queued
  work.
* ``block``  -- ``time.sleep`` on the event loop thread: a *misbehaving*
  task that starves the heartbeat coroutine, which is exactly how the
  master's missed-heartbeat failure detection gets exercised.

Every worker resolves its device when it starts, before it registers
(:func:`~repro_torch._device.resolve_device`: the CUDA card unless the
caller names one, raising without a card).  On a card it makes its CUDA
context and runs one payload step there, so the first ``torch`` task pays no
set-up inside its lease, and a card it cannot reach fails the worker at start
rather than as a ``fail`` frame the retry policy would absorb.

Workers run either in-process (one thread per worker, each with its own
event loop -- cheap, coverage-friendly) via :func:`spawn_worker_thread`, or
as real subprocesses via :func:`spawn_worker_subprocess` (``python -m
repro_torch.cluster.runtime HOST PORT --device D``) when a test needs to
SIGKILL one mid-task.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import ctypes
import os
import random
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from ..._device import resolve_device
from .protocol import read_msg, send_msg

__all__ = ["run_payload", "spawn_worker_subprocess", "spawn_worker_thread", "worker_loop"]


class PayloadError(RuntimeError):
    """A task payload failed (organically or chaos-injected)."""


def _payload_matrix() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((96, 96))


def _torch_step(a: torch.Tensor) -> torch.Tensor:
    """One step of the ``torch`` payload, ended by a synchronise (``.item()``
    on one element): when it returns, the device has done the step's work."""
    a = torch.tanh(a @ a.T / 96.0)
    a[0, 0].item()
    return a


def _warm_device(device: torch.device) -> None:
    """Make the device's context and run one ``torch`` payload step on it.

    On a CUDA card this creates the context and this thread's matmul handle,
    so the first task pays neither inside its lease; a card the worker cannot
    reach raises here, at start.
    """
    _torch_step(torch.from_numpy(_payload_matrix()).to(device))


async def run_payload(payload: str, costs, factor: float = 1.0, device=None) -> int:
    """Execute one batch replica's work; raises CancelledError if cancelled.

    ``factor`` scales the real execution time (the per-worker speed skew the
    master dispatches but does not model -- its straggling replicas are what
    cancel-on-earliest-cover reclaims).  ``device`` is where a ``torch``
    payload runs (resolved as every entry point does).  Returns the matmul
    steps a ``numpy`` or ``torch`` payload ran, else 0.
    """
    steps = 0
    if payload == "sleep":
        await asyncio.sleep(float(sum(costs)) * factor)
    elif payload == "numpy":
        # ~cost seconds of matmul per task, chunked so cancellation can land
        a = _payload_matrix()
        for c in costs:
            deadline = time.monotonic() + float(c) * factor
            while time.monotonic() < deadline:
                a = np.tanh(a @ a.T / 96.0)
                steps += 1
                await asyncio.sleep(0)
    elif payload == "torch":
        # the numpy chain on the device; each step ends in a synchronise, so
        # a cancel (which lands at the await) leaves no work queued
        a = torch.from_numpy(_payload_matrix()).to(resolve_device(device))
        for c in costs:
            deadline = time.monotonic() + float(c) * factor
            while time.monotonic() < deadline:
                a = _torch_step(a)
                steps += 1
                await asyncio.sleep(0)
    elif payload == "block":
        # deliberately hostile: blocks the loop, starving heartbeats
        time.sleep(float(sum(costs)) * factor)
    elif payload == "raise":
        # a broken task: burns ~30% of its nominal cost, then explodes --
        # the organic path into the fail-frame / retry machinery
        await asyncio.sleep(float(sum(costs)) * factor * 0.3)
        raise PayloadError("payload exploded (kind='raise')")
    else:
        raise ValueError(f"unknown payload kind {payload!r}")
    return steps


async def _heartbeat(
    writer, wid: int, interval_s: float, state: dict, jitter_seed: int = 0
) -> None:
    """Heartbeats double as progress reports: while a replica is running,
    each beat carries its (job, batch, epoch) and the fraction of the
    nominal cost elapsed -- the partial-progress evidence the master's
    speculative policy requires before it backs a laggard up.

    Each sleep is jittered +-10% (seeded per worker) so a fleet of workers
    reconnecting together -- e.g. right after master recovery -- does not
    heartbeat in lockstep and thundering-herd the master's read loops."""
    rng = random.Random((int(jitter_seed) << 20) ^ int(wid))
    try:
        while True:
            await asyncio.sleep(interval_s * (0.9 + 0.2 * rng.random()))
            msg = {"type": "hb", "wid": wid}
            cur = state.get("current")
            if cur is not None:
                total = state["total"]
                elapsed = time.monotonic() - state["t0"]
                frac = 1.0 if total <= 0.0 else min(elapsed / total, 1.0)
                msg.update(job=cur["job"], batch=cur["batch"], epoch=cur["epoch"], frac=frac)
            await send_msg(writer, msg)
    except (ConnectionError, RuntimeError):
        return  # the master tore the socket down; the read loop will exit too


async def worker_loop(host: str, port: int, device=None) -> None:
    """Resolve and warm the device, connect, register, then serve
    task/cancel messages until shutdown."""
    dev = resolve_device(device)
    _warm_device(dev)
    reader, writer = await asyncio.open_connection(host, port)
    await send_msg(writer, {"type": "register", "pid": os.getpid()})
    welcome = await read_msg(reader)
    if welcome is None or welcome.get("type") != "welcome":
        writer.close()
        return
    wid = int(welcome["wid"])
    state: dict = {"current": None, "t0": 0.0, "total": 0.0}
    hb = asyncio.ensure_future(
        _heartbeat(
            writer,
            wid,
            float(welcome["heartbeat_s"]),
            state,
            int(welcome.get("hb_seed", 0)),
        )
    )
    current: dict | None = None
    task: asyncio.Task | None = None

    def _task_factor(msg: dict) -> float:
        # per-worker skew the master dispatches plus any chaos-injected
        # slowdown riding on the task frame
        return (1.0 + wid * float(msg.get("skew", 0.0))) * float(msg.get("chaos_factor", 1.0))

    async def execute(msg: dict) -> None:
        try:
            factor = _task_factor(msg)
            if msg.get("chaos_raise"):
                # injected mid-payload failure: burn part of the nominal cost,
                # then die exactly like a broken payload would
                await asyncio.sleep(float(sum(msg["costs"])) * factor * 0.5)
                raise PayloadError("chaos: injected payload failure")
            await run_payload(msg["payload"], msg["costs"], factor, dev)
            await send_msg(
                writer,
                {
                    "type": "finish",
                    "wid": wid,
                    "job": msg["job"],
                    "batch": msg["batch"],
                    "epoch": msg["epoch"],
                },
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            # a broken payload is a first-class outcome, not something to
            # swallow: report it with the traceback so the master can retry
            # (or abandon) and the failure surfaces in LiveReport
            try:
                await send_msg(
                    writer,
                    {
                        "type": "fail",
                        "wid": wid,
                        "job": msg["job"],
                        "batch": msg["batch"],
                        "epoch": msg["epoch"],
                        "error": traceback.format_exc(limit=20),
                    },
                )
            except Exception:
                return  # torn socket: nothing to report to; the lease reaps it
        finally:
            if state.get("current") is msg:
                state["current"] = None

    try:
        while True:
            msg = await read_msg(reader)
            if msg is None or msg["type"] == "shutdown":
                break
            if msg["type"] == "task":
                if (
                    task is not None
                    and not task.done()
                    and current is not None
                    and (current["job"], current["batch"], current["epoch"])
                    == (msg["job"], msg["batch"], msg["epoch"])
                ):
                    continue  # duplicated dispatch frame (chaos): already running
                current = msg
                state["current"] = msg
                state["t0"] = time.monotonic()
                state["total"] = float(sum(msg["costs"])) * _task_factor(msg)
                task = asyncio.ensure_future(execute(msg))
            elif msg["type"] == "cancel":
                if (
                    task is not None
                    and current is not None
                    and (current["job"], current["batch"], current["epoch"])
                    == (msg["job"], msg["batch"], msg["epoch"])
                ):
                    task.cancel()
                    state["current"] = None
    finally:
        hb.cancel()
        if task is not None:
            task.cancel()
        writer.close()


def spawn_worker_thread(host: str, port: int, device=None) -> threading.Thread:
    """One in-process worker on its own thread + event loop.

    A separate loop per worker matters: a ``block`` payload then stalls only
    its own worker (exactly like a wedged remote process) instead of the
    master's loop.  ``device`` is resolved here, so a call without a card
    and without ``device="cpu"`` raises in the caller.
    """
    dev = resolve_device(device)
    t = threading.Thread(
        target=lambda: asyncio.run(worker_loop(host, port, dev)),
        name=f"repro-worker-{port}",
        daemon=True,
    )
    t.start()
    return t


# children spawned by this process, reaped at interpreter exit if the normal
# shutdown path never ran (the cross-platform fallback behind PDEATHSIG)
_children: list = []
_atexit_registered = False

PR_SET_PDEATHSIG = 1  # linux/prctl.h


def _pdeathsig_preexec() -> None:  # pragma: no cover - runs in the child
    # die with the parent: if the master process is SIGKILLed (no atexit
    # runs there), the kernel delivers SIGKILL to this child.  prctl clears
    # the deathsig across setuid execve, not across fork/exec here.
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except OSError:
        pass  # non-glibc platform: the atexit fallback still covers clean exits


def _kill_orphans() -> None:
    for proc in _children:
        if proc.poll() is None:
            try:
                proc.kill()
            except OSError:  # pragma: no cover - already gone
                pass


def spawn_worker_subprocess(host: str, port: int, device=None) -> subprocess.Popen:
    """A real worker process -- killable mid-task with ``proc.kill()``.

    The child runs ``python -m repro_torch.cluster.runtime HOST PORT
    --device D``, with ``device`` resolved here (so a call without a card and
    without ``device="cpu"`` raises in the caller).  Each child on a CUDA
    card makes its own context.

    Child lifetime is tied to the spawning process: on Linux the child sets
    ``PR_SET_PDEATHSIG`` so the kernel SIGKILLs it the instant its parent
    dies (even via SIGKILL), and an ``atexit`` hook kills any survivors on
    ordinary interpreter exit -- chaos runs that crash the master must not
    leak worker processes.

    Note worker ids are assigned in *registration* order, which need not be
    spawn order: to kill a specific wid, look up its registered pid on the
    master (``master.workers[wid].pid``) rather than indexing the Popens.
    """
    global _atexit_registered
    dev = resolve_device(device)
    env = os.environ.copy()
    # make repro_torch importable in the child even when it is not installed
    # (e.g. pytest's `pythonpath` ini only patches the parent's sys.path)
    here = os.path.abspath(__file__)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(here))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    preexec = _pdeathsig_preexec if sys.platform.startswith("linux") else None
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.cluster.runtime", host, str(port),
         "--device", str(dev)],
        env=env,
        preexec_fn=preexec,
    )
    _children.append(proc)
    if not _atexit_registered:
        atexit.register(_kill_orphans)
        _atexit_registered = True
    return proc


def main(argv) -> None:
    """CLI entry point: ``python -m repro_torch.cluster.runtime HOST PORT [--device D]``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.runtime",
        description="Run one live-runtime worker against the master at HOST:PORT.",
    )
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument(
        "--device", default=None,
        help="where the torch payload runs (default: the CUDA card; 'cpu' to run without one)",
    )
    args = ap.parse_args(argv[1:])
    asyncio.run(worker_loop(args.host, args.port, args.device))


if __name__ == "__main__":  # pragma: no cover - exercised as a subprocess
    main(sys.argv)
