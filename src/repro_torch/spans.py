"""Named spans at the layer boundaries of the planner and the train step.

``with span("plan.select"):`` marks a part of a call in a ``torch.profiler``
trace.  While a profiler records on the calling thread (autograd's device
thread inherits the state of the thread that runs the backward),
:func:`span` opens a record of the given name that the profiler keeps in its
own memory, on the clock of its device trace, beside the operators and the
runtime calls made inside it; nothing is written out unless the profiler
exports.  Otherwise it returns one shared null context, at the cost of one
C call: no environment variable, setting or module flag switches it.

The record is an operator's (``RecordScope.FUNCTION``), not a user
annotation: the profiler draws a user annotation on the device's timeline
too, from its first kernel to its last, and a reader of the device's busy
time would take the gaps inside it for work.  A span shows on the host's
timeline only; the kernels it launched are found through their launch calls.

:data:`NAMES` holds every name the package passes to :func:`span`:

* ``plan.scenario``, ``plan.frontier``, ``plan.select``: the three parts of
  ``RedundancyPlanner.plan_cluster`` (the scenario resolved and checked, the
  frontier's rows computed, the statistics and the choice of B);
* ``cover.upload``, ``cover.launch``: kernel B's arguments built and copied
  to the card, then its launch (``kernels.cover.frontier_sample_cover``);
* ``cover.readback``: the frontier's cover times copied back to the host,
  which waits for the kernel (``cluster.vectorized.frontier_job_times``);
* ``train.forward``, ``train.backward``, ``train.optimizer``: the loss, its
  gradients, and AdamW with the new parameters (``runtime.train``'s step on
  one device);
* ``attention.backward``, ``rmsnorm.backward``: the backward of each call
  of the attention and RMSNorm kernels' autograd functions;
* ``ssd.forward``, ``ssd.backward``: Mamba-2's chunked SSD scan
  (``models.ssm.ssd_scan``), each forward and recompute, and its backward.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["NAMES", "span"]

NAMES = (
    "plan.scenario",
    "plan.frontier",
    "plan.select",
    "cover.upload",
    "cover.launch",
    "cover.readback",
    "train.forward",
    "train.backward",
    "train.optimizer",
    "attention.backward",
    "rmsnorm.backward",
    "ssd.forward",
    "ssd.backward",
)

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records ``name`` while a profiler records, else a null one."""
    return _record(name) if _recording() else _OFF
