"""Serving-step construction: prefill + batched single-token decode.

Port of ``repro.runtime.serve``.  ``make_prefill_step`` / ``make_serve_step``
run on one device, the decode cache written in place.  ``jit_prefill`` /
``jit_serve_step`` are their mesh halves, with the reference's names and
return tuples; nothing is compiled.  Over a ``DeviceMesh`` the parameters
are DTensors placed by ``sharding.param_shardings``, and the cache's leaves
are DTensors placed by ``sharding.cache_shardings``: the plain ring sharded
on heads over ``"model"``, the sequence-sharded true-KV ring
(``decode_kv_seq_sharded``) on its sequence.  Compute is data-parallel over
the batch axes and tensor-parallel over ``"model"`` (``runtime/train.py``):
a call gathers each parameter over every axis but ``"model"``, each model
rank computes on its shards, and every cache leaf the rules split over
``"model"`` stays this rank's part, prefilled and decoded in place: the
plain ring in its head shards, the state-space mixer's ``conv_x`` channels
and ``h`` heads, the RG-LRU's ``conv`` and ``h`` channels.  In the true-KV
mode the model axis carries the ring's sequence: the attention is
whole-head on every rank and each rank attends over its own chunk
(``models/transformer.py::_seq_sharded_decode``), while the MLPs and the
vocabulary stay tensor-parallel.  The logits come back whole, the same on
every rank.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..configs.base import ShapeConfig
from ..distributed import sharding
from ..distributed import tensor_parallel as tp
from ..distributed.axes import logical_axes
from ..models import Model
from .train import _BatchAxes, model_axes, param_shapes

__all__ = ["jit_prefill", "jit_serve_step", "make_prefill_step", "make_serve_step"]

# the true-KV ring's leaves: kept in their shards, the decode attends over them
_SEQ_KEYS = ("ks", "vs", "poss")


def make_prefill_step(model: Model, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(params, cache, tokens, t):
        return model.decode_step(params, cache, tokens, t)

    return serve_step


def _cache_shapes(model: Model, shape: ShapeConfig):
    """The decode cache's leaves as fake tensors (the reference's ``cache_specs``)."""
    with FakeTensorMode():
        tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
        return model.init_cache({"tokens": tokens}, shape.seq_len)


def _prefill_batch_shapes(model: Model, shape: ShapeConfig) -> Dict[str, torch.Size]:
    cfg, b, s = model.cfg, shape.global_batch, shape.seq_len
    stubbed = cfg.family in ("vlm", "encoder")  # modality frontend is a stub
    out = {"embeds": torch.Size((b, s, cfg.d_model))} if stubbed else {"tokens": torch.Size((b, s))}
    if cfg.family == "vlm":
        out["mrope_positions"] = torch.Size((b, s, 3))
    return out


def _compute_params(params, kept: "weakref.WeakKeyDictionary", keep: tuple):
    """The parameters gathered over every axis that shards them but those in
    ``keep`` (the model axis of a tensor-parallel family).  Where no leaf
    needs a gather (a world of one, or shards over ``keep`` only), the tree of
    local tensors is made once per parameter tree and kept in ``kept`` (it
    shares their storage)."""
    tree = kept.get(params)
    if tree is None:
        leaves = params.leaves()
        tree = params.replace_leaves({k: sharding.gather(p, keep) for k, p in leaves.items()})
        if all(sharding.is_whole(p, keep) for p in leaves.values()):
            kept[params] = tree
    return tree


def _rows(x, sh: sharding.NamedSharding, bx: _BatchAxes) -> torch.Tensor:
    """This rank's rows of a global-batch input placed (or to be placed) by ``sh``."""
    x = sharding.gather(x)
    return bx.rows(x) if sh.spec else x


def _global_rows(x: torch.Tensor, bx: _BatchAxes, split: bool) -> torch.Tensor:
    """The global batch of per-rank rows (every rank gets the whole); rows
    that were not split are the whole already."""
    return bx.all_gather(x, 0) if split else x


def _map(fn, tree, sh_tree, name: str = ""):
    """``fn(name, leaf, sharding)`` over a cache tree and its congruent
    shardings; a leaf's name is its innermost key."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, sh_tree[k], k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, s, name) for v, s in zip(tree, sh_tree)]
    return fn(name, tree, sh_tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def jit_prefill(mesh, model: Model, shape: ShapeConfig):
    """``(fn, p_sh, b_sh, c_sh)``: ``fn(params, batch) -> (logits, cache, t)``
    prefills this rank's rows of the global batch with the whole parameters
    and returns the cache as DTensors placed by ``c_sh``."""
    axes = sharding.MeshAxes.infer(mesh)
    p_sh = sharding.param_shardings(mesh, param_shapes(model))
    b_sh = sharding.batch_shardings(mesh, _prefill_batch_shapes(model, shape))
    c_sh = sharding.cache_shardings(mesh, _cache_shapes(model, shape))
    bx = _BatchAxes(mesh, axes.batch)
    tp_keep = model_axes(model, axes)
    tpg = tp.MeshGroup(mesh, tp_keep)
    kept = weakref.WeakKeyDictionary()

    def place(name: str, x: torch.Tensor, sh: sharding.NamedSharding) -> DTensor:
        # the prefill made this rank's rows, and a split family's ring heads
        skip = axes.batch + (() if name in _SEQ_KEYS else tp_keep)
        local = x[sharding.local_slice(x.shape, sh.spec, mesh, mesh.get_coordinate(),
                                       skip=skip)]
        return DTensor.from_local(local.contiguous(), mesh, sh.placements, run_check=False)

    def prefill_step(params, batch):
        split = bool(next(iter(b_sh.values())).spec)
        with logical_axes(mesh, axes.batch, axes.model, seq=model.cfg.sequence_parallel,
                          tp=tpg):
            batch = {k: _rows(v, b_sh[k], bx) for k, v in batch.items()}
            logits, cache, t = model.prefill(_compute_params(params, kept, tp_keep), batch,
                                             shape.seq_len)
        return _global_rows(logits, bx, split), _map(place, cache, c_sh), t

    return prefill_step, p_sh, b_sh, c_sh


def jit_serve_step(mesh, model: Model, shape: ShapeConfig, donate: bool = True):
    """``(fn, p_sh, c_sh, tok_sh)``: ``fn(params, cache, tokens, t) -> (logits,
    cache, t + 1)`` decodes one token of the global batch against a cache
    placed by ``c_sh``, written in place (``donate`` is accepted for the
    reference's signature)."""
    del donate
    axes = sharding.MeshAxes.infer(mesh)
    p_sh = sharding.param_shardings(mesh, param_shapes(model))
    c_sh = sharding.cache_shardings(mesh, _cache_shapes(model, shape))
    tokens = {"tokens": torch.Size((shape.global_batch, 1))}
    tok_sh = sharding.batch_shardings(mesh, tokens)["tokens"]
    bx = _BatchAxes(mesh, axes.batch)
    tp_keep = model_axes(model, axes)
    tpg = tp.MeshGroup(mesh, tp_keep)
    keep = axes.batch + tp_keep
    kept = weakref.WeakKeyDictionary()

    def view(name: str, x, sh):
        # a split family's ring is its local heads, written in place; the true-KV
        # ring stays a DTensor (each rank its chunk); other leaves are gathered
        return x if name in _SEQ_KEYS else sharding.gather(x, keep)

    def serve_step(params, cache, tokens, t):
        # no autograd: the cache's local tensors (views DTensor.to_local made)
        # are written in place
        with torch.no_grad(), logical_axes(mesh, axes.batch, axes.model,
                                           seq=model.cfg.sequence_parallel, tp=tpg):
            compute = _map(view, cache, c_sh)
            logits, _, t1 = model.decode_step(_compute_params(params, kept, tp_keep), compute,
                                              _rows(tokens, tok_sh, bx), t)
        with torch.no_grad():  # a no-op where the view shares the leaf's storage
            for x, full in zip(_leaves(cache), _leaves(compute)):
                if isinstance(x, DTensor) and x is not full:
                    sharding.write_back(x, full, keep)
        return _global_rows(logits, bx, bool(tok_sh.spec)), cache, t1

    return serve_step, p_sh, c_sh, tok_sh
