"""The traced window: a ``torch.profiler`` trace reduced to what the readers need.

The arithmetic of busy time by kernel name is ``chip_smoke.py::profile_device``'s
(kernel and copy durations summed by name from the profiler's raw events);
here the device's busy time is the union of its events' intervals, so two
events that overlap are counted once.  The window is the span from the
start of the first unit the benchmark marked (``record_function``) to the
end of the last one, in the trace's own clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq

UNIT_SPAN = "perfbench.unit"


@dataclasses.dataclass
class Trace:
    """Device events of the traced units, and the host events beside them.

    ``device``: ``(name, start_ns, end_ns)`` of every kernel, copy and fill
    inside the window; ``host``: the same of every host event the profiler
    recorded there (operators, runtime calls, the benchmark's spans).
    """

    device: list
    host: list
    window_ns: tuple
    units: int

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device)) / 1e9

    def idle_pct(self) -> float | None:
        """% of the window with no kernel, copy or fill on the device."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def host_ms_per_unit(self) -> float | None:
        """ms a unit of the window's wall time the device was not busy."""
        if not self.units or not self.device:
            return None
        return (self.window_s - self.busy_s) * 1e3 / self.units

    def kernel_s(self, *parts: str) -> tuple[float, int]:
        """Seconds and launches of the device events whose name holds any of ``parts``."""
        total, n = 0, 0
        for name, a, b in self.device:
            if any(p in name for p in parts):
                total += b - a
                n += 1
        return total / 1e9, n

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: ``[name, seconds]``."""
        by: dict = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0) + (b - a)
        return [[n, s / 1e9] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device by what the host was doing: each gap between
        busy intervals is named by the innermost host event that covers its
        middle, and the seconds are summed by that name: ``[name, seconds]``."""
        busy = _union(self.device)
        lo, hi = self.window_ns
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda e: e[1])
        by: dict = {}
        live: list = []  # heap of the host events begun by now, the latest begun on top
        nxt = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) // 2
            while nxt < len(host) and host[nxt][1] <= mid:
                heapq.heappush(live, (-host[nxt][1], host[nxt][2], host[nxt][0]))
                nxt += 1
            while live and live[0][1] <= mid:  # ended: it covers no later middle either
                heapq.heappop(live)
            name = live[0][2] if live else "(no host event)"
            by[name] = by.get(name, 0) + (b - a)
        return [[n, s / 1e9] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _union(events) -> list:
    out: list = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """Marks units and, when on, traces them with ``torch.profiler``.

    ``with tracer.unit():`` wraps one measured unit (a plan, a step).
    :meth:`start` and :meth:`stop` bound the traced part of the window;
    :meth:`result` reads the trace once it is stopped.
    """

    def __init__(self, enabled: bool, device_type: str):
        self.enabled = enabled
        self.device_type = device_type
        self.prof = None
        self.stopped = False
        self.units = 0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    @contextlib.contextmanager
    def unit(self):
        if self.prof is None or self.stopped:
            yield
            return
        import torch

        with torch.profiler.record_function(UNIT_SPAN):
            yield
        self.units += 1

    def stop(self) -> None:
        if self.prof is not None and not self.stopped:
            import torch

            if self.device_type == "cuda":
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.stopped = True

    def result(self) -> Trace | None:
        if self.prof is None:
            return None
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host, spans = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns()
            ev = (e.name(), a, a + e.duration_ns())
            if e.device_type() == cuda:
                if ev[0] != UNIT_SPAN:  # the span's own mark on the device's timeline
                    device.append(ev)
            elif ev[0] == UNIT_SPAN:
                spans.append(ev)
            else:
                host.append(ev)
        if not spans:
            return None
        lo, hi = min(s[1] for s in spans), max(s[2] for s in spans)
        device = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
        host = [ev for ev in host if ev[2] > lo and ev[1] < hi] + spans
        return Trace(device, host, (lo, hi), len(spans))
