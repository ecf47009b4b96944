"""Discrete-event core: event heap, simulation clock, named RNG streams.

A numpy copy of ``repro.cluster.events`` for the port's event engine
(:mod:`repro_torch.cluster.master`).  Every state change (a job arriving, a
batch replica finishing, a worker failing or rejoining) is an event on one
time-ordered heap.  Determinism is load-bearing -- the planner scores
candidate plans by running the engine, and tests replay runs bit for bit
against the reference's engine -- so heap ties are broken by insertion order
(``itertools.count``) and all randomness flows through :class:`RngStreams`,
whose per-stream seeds are the reference's (``zlib.crc32`` of the name as the
``SeedSequence`` spawn key).
"""
from __future__ import annotations

import heapq
import itertools
import zlib

import numpy as np

__all__ = [
    "JOB_ARRIVAL",
    "BATCH_DONE",
    "WORKER_FAIL",
    "WORKER_JOIN",
    "SPEC_CHECK",
    "TASK_FAIL",
    "RETRY",
    "EventQueue",
    "SimClock",
    "RngStreams",
]

# event kinds
JOB_ARRIVAL = "job_arrival"
BATCH_DONE = "batch_done"
WORKER_FAIL = "worker_fail"
WORKER_JOIN = "worker_join"
SPEC_CHECK = "spec_check"  # speculative-backup heartbeat check (reactive replication)
TASK_FAIL = "task_fail"  # a replica's payload raised (vs WORKER_FAIL: the worker died)
RETRY = "retry"  # a failed replica's backoff expired; re-queue it through rescue


class EventQueue:
    """Min-heap of (time, seq, kind, payload); seq makes ordering total."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, **payload) -> None:
        """Schedule an event; FIFO-stable among equal timestamps."""
        heapq.heappush(self._heap, (float(time), next(self._seq), kind, payload))

    def pop(self) -> tuple:
        """Remove and return the earliest ``(time, kind, payload)``."""
        time, _, kind, payload = heapq.heappop(self._heap)
        return time, kind, payload

    def peek_time(self) -> float:
        """Timestamp of the earliest pending event."""
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class SimClock:
    """Monotone simulation clock (guards against out-of-order processing)."""

    def __init__(self):
        self.now = 0.0

    def advance(self, t: float) -> None:
        """Move simulated time forward to ``t`` (never backwards)."""
        if t < self.now - 1e-9:
            raise RuntimeError(f"clock moved backwards: {self.now} -> {t}")
        self.now = max(self.now, float(t))


class RngStreams:
    """Named independent generators derived from a single root seed.

    Each name maps to its own ``np.random.Generator`` (via a SeedSequence
    spawn key hashed from the name), so e.g. service-time draws are not
    perturbed by whether churn is enabled -- a property the cancellation
    on/off comparison tests rely on.
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._streams: dict = {}

    def get(self, name: str) -> np.random.Generator:
        """The named substream, created on first use (order-independent)."""
        if name not in self._streams:
            key = zlib.crc32(name.encode("utf-8"))
            ss = np.random.SeedSequence(entropy=self.seed, spawn_key=(key,))
            self._streams[name] = np.random.default_rng(ss)
        return self._streams[name]
