"""AdamW with decoupled weight decay and global-norm clipping (port of ``repro.optim.adamw``).

A tree here is a :class:`~repro_torch.models.common.Params` or a mapping from
names to tensors; gradients, moments and updates are mappings from each
leaf's dotted path (``Params.leaves()``) to a tensor.  The update is the
reference's, in its order: float32 moments, the gradients clipped by their
global norm before the moments, bias corrections ``1 - b^count`` in float32,
``step = (m / c1) / (sqrt(v / c2) + eps) + wd * p`` on leaves of two or more
dimensions, and ``(p.f32 + u).to(p.dtype)``.

The reference decides "matrix or not" by ``p.ndim`` on its own tree, where
``scan_layers=True`` (its default) stacks every layer's leaves on a leading
axis: a stacked norm or bias is 2-D there and is decayed, though its
docstring says norms and biases are not (``ROADMAP.md`` §3).  The port's
layers are never stacked, so the rule applies as stated: the reference's
update with ``scan_layers=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from ..models.common import Params

__all__ = ["AdamW", "OptState", "apply_updates", "global_norm"]

Tree = Any  # Params or Mapping[str, torch.Tensor]


class OptState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    m: dict  # first moment (float32), by leaf path
    v: dict  # second moment (float32), by leaf path


def _leaves(tree: Tree) -> dict:
    return tree.leaves() if isinstance(tree, Params) else dict(tree)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in _leaves(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def apply_updates(params: Tree, updates: Mapping[str, torch.Tensor]) -> Tree:
    """``(p.f32 + u).to(p.dtype)`` at every leaf; a ``Params`` keeps its
    leaves' ``requires_grad``, a mapping comes back as a dict."""
    leaves = _leaves(params)
    with torch.no_grad():
        new = {k: (p.float() + updates[k]).to(p.dtype) for k, p in leaves.items()}
    if isinstance(params, Params):
        for k, p in leaves.items():
            new[k] = torch.nn.Parameter(new[k], requires_grad=p.requires_grad)
        return params.replace_leaves(new)
    return new


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # decay applies only to >=2D weights (not norms/biases), LM convention
    decay_min_ndim: int = 2

    def init(self, params: Tree) -> OptState:
        leaves = _leaves(params)
        device = next(iter(leaves.values())).device
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
            v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
        )

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.full((), self.learning_rate, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads: Tree, state: OptState, params: Tree):
        """Returns (updates, new_state, metrics)."""
        return self.update_shards(grads, state, params, global_norm(_leaves(grads)))

    @torch.no_grad()
    def update_shards(self, grads: Tree, state: OptState, params: Tree, gnorm: torch.Tensor):
        """:meth:`update` of shards of a tree whose whole gradient has the
        global norm ``gnorm`` (each rank of a mesh step updates its own
        shards; the update is elementwise once the clipping scale is known)."""
        grads, leaves = _leaves(grads), _leaves(params)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()
        lr = self._lr(count)

        # leaf by leaf, so no second tree of clipped gradients is ever whole
        updates, m, v = {}, {}, {}
        for k, p in leaves.items():
            g = grads[k].float() * scale if scale is not None else grads[k].float()
            m[k] = b1 * state.m[k] + (1 - b1) * g
            v[k] = b2 * state.v[k] + (1 - b2) * g * g
            step = (m[k] / c1) / (torch.sqrt(v[k] / c2) + self.eps)
            if self.weight_decay and p.dim() >= self.decay_min_ndim:
                step = step + self.weight_decay * p.float()
            updates[k] = -lr * step
        return updates, OptState(count, m, v), {"grad_norm": gnorm, "lr": lr}
