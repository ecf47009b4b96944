"""Shared utilities of the model zoo (port of ``repro.models.common``).

The reference keeps parameters in explicit pytrees; here they live in a
:class:`Params` module, a tree of ``nn.Parameter`` leaves under the
reference's names (``p["wq"]``, ``"bq" in p``), with lists of layers as
``nn.ModuleList``.  :func:`cross_entropy_loss` is the reference's token loss;
training differentiates through :func:`cast_for_compute` to the master
weights (see :class:`Params`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch
from torch import nn

from ..distributed import tensor_parallel as tp

__all__ = [
    "Params",
    "cast_for_compute",
    "count_params",
    "cross_entropy_loss",
    "dense_init",
    "normal_init",
    "pad_to_multiple",
]


class Params(nn.Module):
    """A tree of tensors under the reference's names.

    Built from a nested mapping: a mapping becomes a child :class:`Params`, a
    list an ``nn.ModuleList`` of them, and a tensor a leaf.  A plain tensor
    becomes a parameter with ``requires_grad`` off (serving needs no
    gradients); an ``nn.Parameter`` is kept as it is, so a tree rebuilt from
    another's leaves shares them; a tensor that requires grad (a cast for
    compute of a trainable leaf) is kept as it is too, outside the
    parameters, so its autograd edge to the master weight stays.
    :meth:`trainable` turns every floating-point parameter's ``requires_grad``
    on: the master weights of training.  Read it as the reference reads its
    pytree: ``p["attn"]["wq"]``, ``"bq" in p``.
    """

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._tensors: dict[str, torch.Tensor] = {}  # leaves that require grad, not parameters
        for name, value in tree.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, Mapping):
                self.add_module(name, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    v if isinstance(v, nn.Module) else Params(v) for v in value
                ))
            elif isinstance(value, nn.Parameter):
                self.register_parameter(name, value)
            elif value.requires_grad:
                self._tensors[name] = value
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._tensors:
            return self._tensors[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._tensors or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._tensors, *self._modules]

    def map_leaves(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "Params":
        """A new tree with ``fn(name, tensor)`` at each leaf (``self`` if no leaf changes).

        A new leaf keeps its autograd history: a cast of a trainable master
        weight passes its gradient back to it.
        """
        tree: dict[str, Any] = {}
        changed = False
        for name in self.keys():
            value = self[name]
            if isinstance(value, Params):
                new = value.map_leaves(fn)
            elif isinstance(value, nn.ModuleList):
                items = [v.map_leaves(fn) for v in value]
                new = value if all(a is b for a, b in zip(items, value)) else items
            else:
                new = fn(name, value)
            changed |= new is not value
            tree[name] = new
        return Params(tree) if changed else self

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every leaf by its dotted path (``"layers.0.attn.wq"``), in tree order."""
        out: dict[str, torch.Tensor] = {}
        for name in self.keys():
            value = self[name]
            if isinstance(value, Params):
                out.update((f"{name}.{k}", t) for k, t in value.leaves().items())
            elif isinstance(value, nn.ModuleList):
                for i, item in enumerate(value):
                    out.update((f"{name}.{i}.{k}", t) for k, t in item.leaves().items())
            else:
                out[name] = value
        return out

    def replace_leaves(self, new: Mapping[str, torch.Tensor], prefix: str = "") -> "Params":
        """A new tree with the leaf at each dotted path of ``new`` replaced
        (a path ``new`` lacks keeps its leaf)."""
        tree: dict[str, Any] = {}
        for name in self.keys():
            value, path = self[name], prefix + name
            if isinstance(value, Params):
                tree[name] = value.replace_leaves(new, path + ".")
            elif isinstance(value, nn.ModuleList):
                tree[name] = [item.replace_leaves(new, f"{path}.{i}.")
                              for i, item in enumerate(value)]
            else:
                tree[name] = new.get(path, value)
        return Params(tree)

    def trainable(self) -> "Params":
        """Turn ``requires_grad`` on for every floating-point leaf; returns ``self``."""
        for t in self.parameters():
            if t.is_floating_point():
                t.requires_grad_(True)
        return self


def normal_init(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Standard-normal draws times ``scale`` on the generator's device, cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return x.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """Normal 1/sqrt(fan_in) init (standard LM practice), as the reference."""
    return normal_init(generator, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


# parameters whose precision is numerically sensitive stay fp32 in compute
_KEEP_FP32 = {"router", "A_log", "dt_bias", "D", "lam", "b_a", "b_i"}


def cast_for_compute(params: Params, dtype: torch.dtype) -> Params:
    """Cast weights to the compute dtype, keeping routing/SSM params fp32.

    Returns ``params`` itself when every weight already has its compute
    dtype, so a tree cast once (as serving keeps it) costs nothing per call.
    """

    def cast(name: str, x: torch.Tensor) -> torch.Tensor:
        if name in _KEEP_FP32 or x.dtype == dtype or not x.is_floating_point():
            return x
        return x.to(dtype)

    return params.map_leaves(cast)


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    real_vocab: int | None = None,
    z_loss: float = 0.0,
    group=None,
    vocab_offset: int = 0,
) -> torch.Tensor:
    """Token CE in float32 with padded-vocab masking and optional z-loss.

    logits: (..., V_padded); labels: (...) int ids; mask: (...) weights.  The
    reference's expressions in its order: padded columns at float32's lowest
    value, the label's log-prob as a masked sum over the vocabulary (not a
    gather), and the mask-weighted mean over ``max(mask.sum(), 1)``.

    Vocab-parallel: over a ``group`` (``tensor_parallel.Group``) of more than
    one rank, ``logits`` are this rank's columns, the first at
    ``vocab_offset``.  The padded columns are masked by their global index,
    the max is an all-reduce max (a constant to the gradient), the exp-sum
    and the label's logit are sums over the group, and the z-loss is taken on
    the global log-sum-exp.
    """
    group = group or tp.SINGLE
    logits = logits.float()
    v = logits.shape[-1]
    cols = torch.arange(v, device=logits.device)
    if group.size > 1:
        cols = cols + vocab_offset
    if real_vocab is not None and real_vocab < v * group.size:
        logits = torch.where(cols >= real_vocab, torch.finfo(torch.float32).min, logits)
    label_hit = cols == labels[..., None].long()
    if group.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.where(label_hit, logits, 0.0).sum(dim=-1)
    else:
        m = group.all_reduce_max(logits.detach().amax(dim=-1))
        lse = m + torch.log(tp.leave(torch.exp(logits - m[..., None]).sum(dim=-1), group))
        ll = tp.leave(torch.where(label_hit, logits, 0.0).sum(dim=-1), group)
    nll = lse - ll
    if z_loss > 0.0:
        nll = nll + z_loss * lse**2
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
