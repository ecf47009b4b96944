"""The program's spans in a traced window: count, host time, self time, device time.

``repro_torch`` marks the parts of a plan and of a train step with spans of
the names in ``repro_torch.spans.NAMES``; in a traced run they are host
events of the profiler's trace, beside the operators and the runtime calls.
:func:`attribute` sums them by name over the traced units: the count, the
host ns, the self host ns (the duration less the part of it that program
spans nested in it cover) and the device ns of the kernels, copies and fills
launched while the span was open, on any thread.  A device operation is
matched to its launch call by correlation id, never by overlap of host and
device intervals: the host runs ahead of the card.

The harness's :class:`perfbench.trace.Trace` keeps each event as ``(name,
start_ns, end_ns)``, without the profiler's correlation id.  :func:`table`
recovers it from the order of the stream: one stream runs its operations in
the order they were launched, so the k-th launch call of the window (by the
time it began) launched the k-th device operation (by the time it began).
Where the counts of the two differ, the order says nothing and the device
times are left out (``None``); the host times stay.  The order cannot read a
window whose operations run on more than one stream, nor a CUDA graph, whose
one launch puts many operations on the card; and where the profiler's times
put a few launch calls out of the order of their operations, it gives those
operations to their neighbours' spans.
"""
from __future__ import annotations

import bisect
import dataclasses

from perfbench.trace import _union

# the runtime and driver calls that put one kernel, copy or fill on a stream
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
})


@dataclasses.dataclass
class Row:
    """One span name's sums over the traced units (ns)."""

    count: int = 0
    host_ns: int = 0
    self_ns: int = 0
    device_ns: int | None = 0


def attribute(spans, launches, device) -> dict:
    """``{name: Row}`` of the program spans.

    ``spans``: ``(name, start_ns, end_ns)`` of each span's host interval, on
    any thread; ``launches``: ``(correlation, start_ns)`` of each launch call;
    ``device``: ``(correlation, start_ns, end_ns)`` of each device operation.
    A device operation belongs to a span when its launch call began inside
    one of the span's intervals; a span nested in another (its interval inside
    the other's) is a child there, and the children's union is the part of
    the parent's interval that is not its self time.
    """
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    rows: dict = {}
    covered = [[] for _ in spans]
    stack: list = []  # indices of the spans still open at the current start, outermost first
    for i, (name, a, b) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= a:
            stack.pop()
        parent = next((j for j in reversed(stack) if spans[j][2] >= b), None)
        if parent is not None:
            covered[parent].append((a, b))
        stack.append(i)
        row = rows.setdefault(name, Row())
        row.count += 1
        row.host_ns += b - a
    for (name, a, b), kids in zip(spans, covered):
        rows[name].self_ns += (b - a) - _union_ns(kids)
    began = dict(launches)
    for name, row in rows.items():
        merged = _merge([(a, b) for n, a, b in spans if n == name])
        starts = [a for a, _ in merged]
        for corr, a, b in device:
            t = began.get(corr)
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t < merged[k][1]:
                row.device_ns += b - a
    return rows


def table(trace) -> dict:
    """:func:`attribute` over a harness :class:`~perfbench.trace.Trace`, each device
    operation matched to its launch call by the order of the stream; every
    ``device_ns`` is ``None`` where :func:`stream_order` finds no such order."""
    names = program_spans()
    spans = [ev for ev in trace.host if ev[0] in names]
    launches, device = stream_order(trace)
    rows = attribute(spans, launches or [], device or [])
    if launches is None:
        for row in rows.values():
            row.device_ns = None
    return rows


def stream_order(trace):
    """``(launches, device)`` for :func:`attribute`, the correlation of each being
    its place in the order of the stream, or ``(None, None)`` where the window
    holds no device operation, or more launch calls than device operations or
    fewer.  A device event that bears the name of a host event is the
    profiler's drawing of a host range on the device's timeline, no operation."""
    host_names = {ev[0] for ev in trace.host}
    calls = sorted(ev[1] for ev in trace.host if ev[0] in LAUNCH_CALLS)
    ops = sorted((ev[1], ev[2]) for ev in trace.device if ev[0] not in host_names)
    if not ops or len(calls) != len(ops):
        return None, None
    return list(enumerate(calls)), [(k, a, b) for k, (a, b) in enumerate(ops)]


def program_spans() -> tuple:
    """Every span name of ``repro_torch.spans``; none for a program without spans."""
    try:
        from repro_torch.spans import NAMES
    except ImportError:
        return ()
    return NAMES


def per_unit_ms(trace, name: str, field: str) -> float | None:
    """``field`` of span ``name`` in ms a traced unit, or ``None`` where the span
    is absent or the field was not read."""
    if not trace.units:
        return None
    row = table(trace).get(name)
    value = None if row is None else getattr(row, field)
    return None if value is None else value / 1e6 / trace.units


def _merge(intervals) -> list:
    return _union(("", a, b) for a, b in intervals)


def _union_ns(intervals) -> int:
    return sum(b - a for a, b in _merge(intervals))
