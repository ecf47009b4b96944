"""Tensor-parallel ranks as threads of one process, on one device.

Every rank of a model group runs in its own thread of the calling process,
each under its own ``logical_axes`` context whose ``tp`` is a
:class:`ThreadGroup`: the group's collectives are a barrier and a sum (max,
concatenation) in rank order, computed by every rank, so every rank gets the
same values.  The reference has no such feature (its model ranks are
devices under XLA's partitioner); it lets a test, or a card with one device,
run every model rank of a TP group side by side.  Why threads and not
torch's own multi-threaded process group: the group's only job is the three
collectives of ``tensor_parallel.Group``, which a barrier and a list do with
no process-group state to set up or tear down, and on CUDA tensors as on
CPU ones.

Each rank runs with ``torch.autograd.set_multithreading_enabled(False)``:
autograd otherwise runs a CUDA backward on one worker thread per device,
where a rank's backward waiting in a collective would block the others'.
Ranks on one CUDA device share its default stream, so a sum launched after
the barrier reads what every rank launched before it.

Imports torch and the port only (no jax); ``chip_smoke.py`` uses it on the card.
"""
from __future__ import annotations

import threading
from typing import Callable, List

import torch

from repro_torch.distributed import axes, sharding
from repro_torch.distributed import tensor_parallel as tp

__all__ = ["ThreadGroup", "assemble", "rank_cache", "rank_params", "run_ranks", "sharded_dims"]


class _Shared:
    def __init__(self, size: int, timeout: float):
        self.slots: list = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)


class ThreadGroup(tp.Group):
    """One rank's view of a group of threads."""

    def __init__(self, shared: _Shared, rank: int):
        self._shared, self.size, self.rank = shared, len(shared.slots), rank
        self.summed: list = []  # what this rank gave each all_reduce_sum, when kept
        self.keep_summed = False

    def _exchange(self, x: torch.Tensor) -> list:
        sh = self._shared
        sh.slots[self.rank] = x
        sh.barrier.wait()
        parts = list(sh.slots)
        sh.barrier.wait()  # nobody writes a slot before every rank has read them
        return parts

    def all_reduce_sum(self, x, inplace=False):
        if self.keep_summed:
            self.summed.append(x.detach().clone())
        parts = self._exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        if inplace:
            sh = self._shared
            sh.barrier.wait()  # every rank has summed before any writes its input
            return x.copy_(out)
        return out

    def all_reduce_max(self, x):
        parts = self._exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def all_gather(self, x, dim):
        return torch.cat(self._exchange(x), dim=dim)

    def reduce_scatter(self, x, dim):
        parts = self._exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        n = out.shape[dim]
        return out.narrow(dim, self.part(n).start, n // self.size).contiguous()


def run_ranks(size: int, fn: Callable[[int, ThreadGroup], object], role: str = "tp",
              timeout: float = 300.0, seq: bool = False) -> List[object]:
    """``[fn(rank, group) for every rank]``, the ranks run at once, one
    thread each, each inside ``logical_axes`` with its group as the model
    group (``role="tp"``; ``seq``: sequence parallelism on) or as the batch
    group (``role="dp"``: each rank holds its rows of the batch).  A rank
    that raises breaks the barrier (the others raise too) and the first
    error is raised here."""
    shared = _Shared(size, timeout)
    out: list = [None] * size
    errors: list = []

    def body(rank: int) -> None:
        group = ThreadGroup(shared, rank)
        try:
            ctx = (axes.logical_axes({"model": size}, (), "model", seq=seq, tp=group)
                   if role == "tp"
                   else axes.logical_axes({"data": size}, ("data",), None, dp=group))
            with torch.autograd.set_multithreading_enabled(False), ctx:
                out[rank] = fn(rank, group)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append((rank, e))
            shared.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"tp-rank{r}")
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        errors.sort(key=lambda e: isinstance(e[1], threading.BrokenBarrierError))
        rank, e = errors[0]
        raise RuntimeError(f"tensor-parallel rank {rank} of {size} failed: {e!r}") from e
    return out


def _specs(leaves: dict, size: int) -> dict:
    return sharding.param_shardings({"model": size}, leaves)


def sharded_dims(leaves: dict, size: int) -> dict:
    """Leaf path -> the dim the rules split over ``"model"`` (leaves they do not split are absent)."""
    out = {}
    for k, sh in _specs(leaves, size).items():
        dims = [d for d, part in enumerate(sh.spec) if part == "model"]
        if dims:
            out[k] = dims[0]
    return out


def rank_params(params, size: int, rank: int, trainable: bool = False):
    """Rank ``rank``'s compute tree of a whole ``Params``: each leaf the rules
    split over ``"model"`` cut to its shard, every other leaf whole (shared
    with ``params``).  ``trainable``: every leaf a new float32 tensor that
    requires grad (the rank's master weights)."""
    specs = _specs(params.leaves(), size)
    leaves = {}
    for k, p in params.leaves().items():
        t = p.detach()[sharding.local_slice(p.shape, specs[k].spec, {"model": size}, (rank,))]
        if trainable:
            t = torch.nn.Parameter(t.clone(), requires_grad=t.is_floating_point())
        elif not t.is_contiguous():
            t = t.contiguous()
        leaves[k] = t
    return params.replace_leaves(leaves)


def rank_cache(cache, size: int, rank: int):
    """Rank ``rank``'s part of a whole decode cache (the same structure): each
    leaf the cache rules split over ``"model"`` cut to its shard (a ring's
    heads, a state-space ``conv_x``'s channels and ``h``'s heads, an RG-LRU
    ``conv``'s and ``h``'s channels), every other leaf whole."""
    mesh = {"model": size}
    specs = sharding.cache_shardings(mesh, cache)

    def cut(x, sh):
        if isinstance(x, dict):
            return {k: cut(v, sh[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [cut(v, s) for v, s in zip(x, sh)]
        return x[sharding.local_slice(x.shape, sh.spec, mesh, (rank,))]

    return cut(cache, specs)


def assemble(per_rank: List[dict], dims: dict) -> dict:
    """Whole tensors by path from every rank's tensors by path: a split leaf's
    shards concatenated on its dim, any other leaf rank 0's."""
    return {k: torch.cat([r[k] for r in per_rank], dim=dims[k]) if k in dims else v
            for k, v in per_rank[0].items()}
