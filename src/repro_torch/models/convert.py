"""Carry the reference's weights into the port.

:func:`params_from_jax` takes the reference's parameter pytree as numpy
arrays -- ``jax.tree.map(np.asarray, params)`` on the caller's side -- and
returns the port's :class:`~repro_torch.models.common.Params` with one entry
per layer in each per-layer list.  The reference stacks layers on a leading
axis by family: the transformer's ``"layers"`` when ``cfg.scan_layers``,
the hybrid's ``"groups"`` always (its ``"tail"`` is a list), Mamba-2's
``"layers"`` always.  The port never imports jax: the caller does the
conversion to numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import Params
from .hybrid import _pattern_layers

__all__ = ["params_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, device):
    if isinstance(x, Mapping):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return _tensor(x, device)


def _layer(tree: Mapping[str, Any], i: int):
    return {k: _layer(v, i) if isinstance(v, Mapping) else v[i] for k, v in tree.items()}


def _unstack(tree: Mapping[str, Any], n: int) -> list:
    return [_layer(tree, i) for i in range(n)]


def params_from_jax(np_params: Mapping[str, Any], cfg: ArchConfig, device=None) -> Params:
    """The port's parameters from the reference's pytree of numpy arrays."""
    dev = resolve_device(device)
    tree = dict(np_params)
    if cfg.family == "hybrid":
        tree["groups"] = _unstack(tree["groups"], _pattern_layers(cfg)[1])
        tree["tail"] = list(tree["tail"])
    elif cfg.family == "ssm" or cfg.scan_layers:
        tree["layers"] = _unstack(tree["layers"], cfg.n_layers)
    elif len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} layers, got {len(tree['layers'])}")
    else:
        tree["layers"] = list(tree["layers"])
    return Params(_tree(tree, dev))
