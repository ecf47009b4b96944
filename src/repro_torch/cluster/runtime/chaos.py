"""Deterministic fault injection for the live runtime.

A copy of ``repro.cluster.runtime.chaos`` for the port, on the port's
:class:`~repro_torch.cluster.scenario.FaultPlan`: the same plan delivers the
same wire verdicts, in the same order, in both packages.

One :class:`FaultInjector` per master, configured by a serializable
:class:`~repro_torch.cluster.scenario.FaultPlan` on the Scenario.  Every fault
decision is made *master-side* -- kills tear the worker's connection,
slowdowns and payload errors ride as flags in the task frame, heartbeat
stalls drop inbound ``hb`` frames, wire faults act on the master's
send/receive boundary -- so each delivered fault can be stamped on the
binary trace grid as an informational ``chaos`` event.  That buys two
properties the chaos tests lean on:

* **replayability** -- the faulted run's trace replays through the DES
  engine bit-exactly, because every consequence of a fault (a torn
  connection, a payload exception, a blown lease) is an ordinary
  first-class trace event;
* **crash-safety** -- the delivered-fault state is rebuilt from the
  journaled ``chaos`` events on :meth:`RuntimeMaster.recover`, so a
  scheduled kill fires at most once per run even across a master crash.

Wire-fault decisions are a pure function of ``(seed, direction, frame
index)`` via a crc32 hash -- no RNG state to persist, and independent of
Python's per-process hash salt.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Set, Tuple

from ..scenario import FaultPlan

__all__ = ["FaultInjector", "WIRE_PASS", "WIRE_DROP", "WIRE_DUP", "WIRE_DELAY"]

WIRE_PASS = "pass"
WIRE_DROP = "drop"
WIRE_DUP = "dup"
WIRE_DELAY = "delay"


def _uniform(seed: int, direction: str, k: int) -> float:
    """Deterministic U[0,1) for the k-th frame in a direction."""
    h = zlib.crc32(f"{seed}:{direction}:{k}".encode("ascii"))
    return h / 4294967296.0


class FaultInjector:
    """Tracks which faults of a :class:`FaultPlan` have been delivered."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._killed: Set[int] = set()  # wids whose scheduled kill fired
        self._raises: Dict[Tuple[int, int], int] = {}  # (job, batch) -> raises delivered
        self._stalls_stamped: Set[int] = set()  # hb_stall entries already stamped
        self._counts = {"in": 0, "out": 0}

    # -- wire faults ---------------------------------------------------------

    def wire(self, direction: str) -> str:
        """Fate of the next frame in ``direction`` ('in' master<-worker,
        'out' master->worker): pass | drop | dup | delay.
        """
        k = self._counts[direction]
        self._counts[direction] = k + 1
        p = self.plan
        if p.drop_p == 0.0 and p.dup_p == 0.0 and p.delay_p == 0.0:
            return WIRE_PASS
        u = _uniform(p.seed, direction, k)
        if u < p.drop_p:
            return WIRE_DROP
        if u < p.drop_p + p.dup_p:
            return WIRE_DUP
        if u < p.drop_p + p.dup_p + p.delay_p:
            return WIRE_DELAY
        return WIRE_PASS

    # -- scheduled faults ----------------------------------------------------

    def due_kills(self, elapsed: float) -> List[int]:
        """Wids whose scheduled kill time has passed and not yet fired.
        Callers mark delivery with :meth:`mark_killed`.
        """
        return [
            int(wid)
            for wid, at in self.plan.kills
            if at <= elapsed and int(wid) not in self._killed
        ]

    def mark_killed(self, wid: int) -> None:
        """Note that the scheduled kill for ``wid`` has been delivered."""
        self._killed.add(int(wid))

    def slow_factor(self, wid: int, elapsed: float) -> float:
        """Compound slowdown factor for tasks dispatched to ``wid`` now."""
        f = 1.0
        for w, at, factor in self.plan.slowdowns:
            if int(w) == int(wid) and at <= elapsed:
                f *= float(factor)
        return f

    def stalled_window(self, wid: int, elapsed: float) -> "int | None":
        """Index of the hb_stall entry covering ``wid`` now, else None."""
        for i, (w, at, dur) in enumerate(self.plan.hb_stalls):
            if int(w) == int(wid) and at <= elapsed < at + dur:
                return i
        return None

    def stall_needs_stamp(self, window: int) -> bool:
        """Stamp each stall window once (at first dropped heartbeat), not per
        frame -- the journal records the fault, not every suppressed hb.
        """
        if window in self._stalls_stamped:
            return False
        self._stalls_stamped.add(window)
        return True

    def payload_raise(self, job: int, batch: int) -> bool:
        """Whether this dispatch of (job, batch) should raise mid-payload.
        Counts deliveries, so the first ``n_raises`` dispatches fail and
        later ones run clean (a delivery lost with its worker is given back:
        :meth:`rearm_raise`).
        """
        for j, b, n in self.plan.payload_errors:
            if int(j) == int(job) and int(b) == int(batch):
                done = self._raises.get((job, batch), 0)
                if done < int(n):
                    self._raises[(job, batch)] = done + 1
                    return True
        return False

    def rearm_raise(self, job: int, batch: int) -> None:
        """Give back a raise delivered to a worker that died before the
        payload raised (the master failed the worker with it in flight): the plan
        asks for ``n_raises`` payload failures of (job, batch), and a raise
        lost with its worker is none, so the next dispatch carries it.  The
        master journals each give-back as a ``chaos`` event of kind
        ``rearm``, which :meth:`restore` counts back.  The port's own; the
        reference's injector spends a raise on delivery, so there whether it
        happens depends on which of the raise and a scheduled kill of its
        worker lands first."""
        key = (int(job), int(batch))
        if self._raises.get(key, 0) > 0:
            self._raises[key] -= 1

    # -- crash recovery ------------------------------------------------------

    def restore(self, chaos_events: Iterable[dict]) -> None:
        """Rebuild delivered-fault state from journaled ``chaos`` events so a
        recovered master does not re-deliver scheduled faults, and does
        re-deliver a raise given back (``rearm``) before the crash.
        """
        for e in chaos_events:
            kind = e.get("kind")
            if kind == "kill":
                self._killed.add(int(e["wid"]))
            elif kind == "raise":
                key = (int(e["job"]), int(e["batch"]))
                self._raises[key] = self._raises.get(key, 0) + 1
            elif kind == "rearm":
                self.rearm_raise(int(e["job"]), int(e["batch"]))
            elif kind == "hb_stall":
                self._stalls_stamped.add(int(e["window"]))
