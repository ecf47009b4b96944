"""Logical sharding annotations for model code (port of ``repro.distributed.axes``).

Model code calls ``shard(x, "batch", None, "model", ...)`` with one logical
role per dim.  Under an active ``logical_axes`` context (set by the step
functions of ``runtime/``) a DTensor is redistributed to the placements the
roles resolve to; a plain tensor -- what the port's compute runs on, each
rank's shards of the parameters -- comes back as it is, since the
reference's constraint is a partitioner hint and never changes a value.
Without a context ``shard`` returns ``x``, as on one card.

The context also carries the groups the compute is split over
(``tensor_parallel.Group``): ``tp``, the ranks of the ``"model"`` axis that
split the model's products (``tensor_parallel.model_group``), and ``dp``,
the batch axes' ranks that the batch statistics sum over
(``tensor_parallel.batch_group``).  The context is per thread, so ranks run
as threads of one process each see their own.

The resolution is the reference's, with its rule for a dim the axes do not
divide: that dim is left unconstrained (it keeps whatever placement it has),
where ``sharding._resolve`` replicates it.  Both rules are kept.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .sharding import PartitionSpec, mesh_sizes

__all__ = ["LogicalAxes", "UNCONSTRAINED", "current", "entered", "logical_axes", "shard",
           "shard_spec"]

_LOCAL = threading.local()


class _Unconstrained:
    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


@dataclasses.dataclass(frozen=True)
class LogicalAxes:
    mesh: object  # a DeviceMesh (or a mapping of axis sizes, for the resolution alone)
    batch: Tuple[str, ...]  # mesh axes carrying the global batch
    model: Optional[str]  # tensor-parallel axis
    seq: bool = False  # sequence parallelism: residual stream seq-shards over model
    tp: Any = None  # tensor_parallel.Group over the model axis (None: a group of one)
    dp: Any = None  # tensor_parallel.Group over the batch axes (None: a group of one)

    def axis_size(self, names) -> int:
        sizes = mesh_sizes(self.mesh)
        size = 1
        for n in [names] if isinstance(names, str) else names:
            size *= sizes[n]
        return size


@contextlib.contextmanager
def logical_axes(mesh, batch: Tuple[str, ...], model: Optional[str], seq: bool = False,
                 tp=None, dp=None):
    stack = _stack()
    stack.append(LogicalAxes(mesh, tuple(batch), model, seq, tp, dp))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def entered(ctx: Optional[LogicalAxes]):
    """Run under ``ctx`` again (a context taken with :func:`current`), as in
    a checkpoint's recompute on another thread; ``None`` does nothing."""
    if ctx is None:
        yield
        return
    stack = _stack()
    stack.append(ctx)
    try:
        yield
    finally:
        stack.pop()


def _stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def current() -> Optional[LogicalAxes]:
    stack = _stack()
    return stack[-1] if stack else None


def shard_spec(ctx: LogicalAxes, shape, roles) -> PartitionSpec:
    """The spec ``shard`` constrains a tensor of ``shape`` to under ``ctx``."""
    if len(roles) != len(shape):
        raise ValueError(f"{len(roles)} roles for a tensor of shape {tuple(shape)}")
    spec = []
    for dim, role in zip(shape, roles):
        if role is None:
            spec.append(None)  # explicitly replicated on this dim
            continue
        if role == "residual":
            # sequence-parallel residual stream: seq dim shards over the TP
            # axis (Megatron-SP); plain TP keeps it replicated
            if not ctx.seq:
                spec.append(None)
                continue
            role = "model"
        names = ctx.batch if role == "batch" else ctx.model
        if not names:
            spec.append(UNCONSTRAINED)  # no axis mapped: leave it as it is
            continue
        if dim % ctx.axis_size(names):
            # non-dividing dim: None would FORCE replication -- leave the dim
            # unconstrained instead
            spec.append(UNCONSTRAINED)
        else:
            spec.append(names if isinstance(names, str) else tuple(names))
    return PartitionSpec(*spec)


def shard(x: torch.Tensor, *roles) -> torch.Tensor:
    """Constrain x's placement by logical dim roles ('batch' | 'model' | 'residual' | None)."""
    ctx = current()
    if ctx is None:
        return x
    spec = shard_spec(ctx, x.shape, roles)
    if not isinstance(x, DTensor):
        return x
    names = list(x.device_mesh.mesh_dim_names)
    out = list(x.placements)
    for d, part in enumerate(spec):
        if part is UNCONSTRAINED:
            continue
        want = () if part is None else ((part,) if isinstance(part, str) else part)
        for i, p in enumerate(out):
            if p.is_shard(d) and names[i] not in want:
                out[i] = Replicate()
        for a in want:
            out[names.index(a)] = Shard(d)
    return x.redistribute(x.device_mesh, out)
