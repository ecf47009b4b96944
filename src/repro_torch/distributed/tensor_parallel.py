"""The model group a mesh step computes over: Megatron-style tensor parallelism.

In the reference this is XLA's partitioner: the parameter rules of
``distributed/sharding.py`` and the ``shard(...)`` hints in the model code
let it split the compute over the ``"model"`` axis and place the
collectives, with no module of its own.  The port writes that out.  A
:class:`Group` is the set of ranks that split one computation (its size
and this rank's index) with the three collectives the model code calls:
:meth:`Group.all_reduce_sum`, :meth:`Group.all_reduce_max` and
:meth:`Group.all_gather`.  :class:`MeshGroup` backs them with the
``DeviceMesh``'s process groups (one axis, or several in turn); a group of
one (:data:`SINGLE`, or a mesh axis of size 1) runs no collective and
moves no value, so a step over it is the plain step, bitwise.

Model code reaches the groups through the ``logical_axes`` context
(:func:`model_group` for the ``"model"`` axis, :func:`batch_group` for the
batch axes); with no context both are :data:`SINGLE`.  A rank-local region
(a column-parallel product, a rank's heads or experts) is entered with
:func:`enter` (identity forward, sum backward: the input's gradient is
partial on each rank) and left with :func:`leave` (sum forward, identity
backward).  :func:`gather` (all-gather forward, this rank's slice backward)
and :func:`scatter` (the slice forward, all-gather backward) move a dim
between its shards and the whole where a region computes whole on every
rank.  A rank's part of a dim is a contiguous chunk by its index, the
reference's element order (``sharding.local_slice``).

Sequence parallelism (``cfg.sequence_parallel``: the reference's
``"residual"`` role, Megatron-SP): under a ``logical_axes`` context with
``seq=True`` and a model group that divides the sequence
(:func:`sequence_group`), the residual stream between the regions is each
rank's ``S / TP`` rows.  A rank-local region is entered from them with
:func:`enter_from_shards` (all-gather forward, reduce-scatter backward) and
left to them with :func:`leave_to_shards` (:meth:`Group.reduce_scatter`
forward, all-gather backward); :func:`region_in` / :func:`region_out` pick
these, ``gather`` / ``scatter`` (a region that computes whole on every
rank) or plain ``enter`` / ``leave`` (no sequence split).  The norms and
residual adds between the regions run on the rank's rows.

The block outputs' sums (the reference's ``"block_out"`` names, kept by
its ``remat_policy="block_outs"``): inside :func:`saving_sums`, each sum
:func:`region_out` runs over a group of more than one rank is recorded on
the context's :class:`SavedSums` the first time the block runs (its
forward) and handed back, in order and without the collective, every later
time (a checkpoint's recompute).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import axes, sharding

__all__ = ["Group", "MeshGroup", "SINGLE", "SavedSums", "batch_group", "enter",
           "enter_from_shards", "gather", "leave", "leave_to_shards", "model_group", "region_in",
           "region_out", "saving_sums", "scatter", "sequence_group"]


class Group:
    """A group of ``size`` ranks, this one at ``rank``.  The base class is the
    group of one: every collective returns its input."""

    size: int = 1
    rank: int = 0

    def all_reduce_sum(self, x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        """The sum of ``x`` over the group: a new tensor where the group has
        more than one rank, or ``x`` itself, summed, with ``inplace``."""
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim``, in rank order."""
        return x

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk (:meth:`part`) of the sum of ``x`` over the group
        on ``dim``: the transpose of :meth:`all_gather`."""
        return x

    def over(self, n: int) -> "Group":
        """This group where it splits a dim of ``n``, else :data:`SINGLE`: the
        rules leave a dim the axis does not divide whole on every rank."""
        return self if n % self.size == 0 else SINGLE

    def part(self, n: int) -> slice:
        """This rank's chunk of a dim of ``n`` (the reference's element order)."""
        return sharding.local_slice((n,), ("g",), {"g": self.size}, (self.rank,))[0]


SINGLE = Group()


class MeshGroup(Group):
    """The ranks of a ``DeviceMesh`` that share every coordinate but those
    of ``names`` (their product, the first axis major).  Axes of size 1
    run none."""

    def __init__(self, mesh, names: Sequence[str]):
        names = [n for n in names if n]
        sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.size = math.prod(sizes[n] for n in names)
        self.rank = 0
        for n in names:
            self.rank = self.rank * sizes[n] + coord[n]
        self._groups = [(mesh.get_group(n), sizes[n]) for n in names if sizes[n] > 1]

    def _reduce(self, x: torch.Tensor, op, inplace: bool = False) -> torch.Tensor:
        if not self._groups:
            return x
        if not inplace:
            x = x.clone()
        for g, _ in self._groups:
            dist.all_reduce(x, op=op, group=g)
        return x

    def all_reduce_sum(self, x, inplace=False):
        return self._reduce(x, dist.ReduceOp.SUM, inplace)

    def all_reduce_max(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x, dim):
        for g, n in reversed(self._groups):  # the minor axis first
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=g)
            x = torch.cat(parts, dim=dim)
        return x

    def reduce_scatter(self, x, dim):
        for g, n in self._groups:  # the major axis first: all_gather's order, inverted
            xt = x.movedim(dim, 0).contiguous()
            out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=g)
            x = out.movedim(0, dim)
        return x


def model_group() -> Group:
    """The group that splits the model's compute (``"model"``), or :data:`SINGLE`."""
    ctx = axes.current()
    return ctx.tp if ctx is not None and ctx.tp is not None else SINGLE


def sequence_group(s: int) -> Group:
    """The group the residual stream's ``s`` rows split over: the model
    group under sequence parallelism where it divides ``s``, else
    :data:`SINGLE` (plain TP; decode's one row among them, as the
    reference's ``"residual"`` role leaves a dim it does not divide)."""
    ctx = axes.current()
    return model_group().over(s) if ctx is not None and ctx.seq else SINGLE


def batch_group() -> Group:
    """The group over the batch axes (the batch statistics' sums), or :data:`SINGLE`."""
    ctx = axes.current()
    return ctx.dp if ctx is not None and ctx.dp is not None else SINGLE


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim]
        return g.narrow(ctx.dim, ctx.group.part(n).start, n // ctx.group.size), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim]
        return x.narrow(dim, group.part(n).start, n // group.size).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _LeaveToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _EnterFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


def enter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` into a rank-local region: identity forward, the gradient summed
    over ``group`` backward."""
    return x if group.size == 1 else _Enter.apply(x, group)


def leave(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A rank's partial result out of its region: summed over ``group``
    forward, its gradient passed through backward."""
    return x if group.size == 1 else _Leave.apply(x, group)


def gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The whole of a dim split over ``group``; backward keeps this rank's slice."""
    return x if group.size == 1 else _Gather.apply(x, group, dim)


def scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's slice of a whole dim; backward gathers the slices' gradients."""
    return x if group.size == 1 else _Scatter.apply(x, group, dim)


def leave_to_shards(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """A rank's partial result out of its region onto its shard of ``dim``:
    the sum over ``group`` reduce-scattered forward, the shards' gradients
    all-gathered backward."""
    return x if group.size == 1 else _LeaveToShards.apply(x, group, dim)


def enter_from_shards(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The whole of a dim split over ``group`` into a rank-local region:
    all-gathered forward, the ranks' partial gradients reduce-scattered
    backward."""
    return x if group.size == 1 else _EnterFromShards.apply(x, group, dim)


def region_in(x: torch.Tensor, group: Group, seq: Group = SINGLE, dim: int = 1) -> torch.Tensor:
    """The input of a region split over ``group`` (rank-local where its size
    is above 1, else whole on every rank) from a residual stream whose rows
    (``dim``) split over ``seq`` (:func:`sequence_group`): :func:`enter`
    where the rows are whole, else the whole rows by :func:`enter_from_shards`
    or, for a region that is not rank-local, :func:`gather`."""
    if seq.size == 1:
        return enter(x, group)
    return enter_from_shards(x, seq, dim) if group.size > 1 else gather(x, seq, dim)


def region_out(x: torch.Tensor, group: Group, seq: Group = SINGLE, dim: int = 1) -> torch.Tensor:
    """A region's output onto the residual stream: :func:`leave` where the
    rows are whole, else this rank's rows by :func:`leave_to_shards` or, for
    a region that is not rank-local, :func:`scatter`.  A sum (a group of more
    than one rank) is recorded or replayed inside :func:`saving_sums`."""
    if seq.size == 1:
        return x if group.size == 1 else _saved_sum(x, lambda: leave(x, group))
    if group.size > 1:
        return _saved_sum(x, lambda: leave_to_shards(x, seq, dim))
    return scatter(x, seq, dim)


class SavedSums:
    """The sums of one checkpointed block, in the order its forward ran them."""

    def __init__(self):
        self.values: list = []
        self.recorded = False  # the forward has run: later runs replay
        self.next = 0


_SAVING = threading.local()


@contextlib.contextmanager
def saving_sums(saved: Optional[SavedSums]):
    """Run a block recording its sums on ``saved`` (its first run) or
    replaying them (every later run); ``None`` does nothing."""
    if saved is None:
        yield
        return
    saved.next = 0
    prev, _SAVING.current = getattr(_SAVING, "current", None), saved
    try:
        yield
    finally:
        _SAVING.current = prev
        saved.recorded = True


class _Replay(torch.autograd.Function):
    """A recorded sum in place of the collective (a recompute's graph is
    discarded; the backward is the sum's, the identity)."""

    @staticmethod
    def forward(ctx, x, value):
        return value.detach()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _saved_sum(x: torch.Tensor, run) -> torch.Tensor:
    saved = getattr(_SAVING, "current", None)
    if saved is None:
        return run()
    if saved.recorded:
        value = saved.values[saved.next]
        saved.next += 1
        return _Replay.apply(x, value)
    out = run()
    saved.values.append(out.detach())
    return out
