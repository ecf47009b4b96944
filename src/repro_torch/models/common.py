"""Shared utilities of the model zoo (port of ``repro.models.common``).

The reference keeps parameters in explicit pytrees; here they live in a
:class:`Params` module, a tree of ``nn.Parameter`` leaves under the
reference's names (``p["wq"]``, ``"bq" in p``), with lists of layers as
``nn.ModuleList``.  ``cross_entropy_loss`` comes with the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch
from torch import nn

__all__ = [
    "Params",
    "cast_for_compute",
    "count_params",
    "dense_init",
    "normal_init",
    "pad_to_multiple",
]


class Params(nn.Module):
    """A tree of tensors under the reference's names.

    Built from a nested mapping: a tensor becomes a parameter (serving needs
    no gradients, so ``requires_grad`` is off), a mapping a child
    :class:`Params`, a list an ``nn.ModuleList`` of them.  Read it as the
    reference reads its pytree: ``p["attn"]["wq"]``, ``"bq" in p``.
    """

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, Mapping):
                self.add_module(name, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    v if isinstance(v, nn.Module) else Params(v) for v in value
                ))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    def map_leaves(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "Params":
        """A new tree with ``fn(name, tensor)`` at each leaf (``self`` if no leaf changes)."""
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
                new = value if new is value else new.detach()
            changed |= new is not value
            tree[name] = new
        return Params(tree) if changed else self


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
