"""Carry the reference's weights into the port.

:func:`params_from_jax` takes the reference's parameter pytree as numpy
arrays -- ``jax.tree.map(np.asarray, params)`` on the caller's side, with the
layers stacked on a leading axis when ``cfg.scan_layers`` -- and returns the
port's :class:`~repro_torch.models.common.Params`, one entry of
``params["layers"]`` per layer.  The port never imports jax: the caller does
the conversion to numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import Params

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


def params_from_jax(np_params: Mapping[str, Any], cfg: ArchConfig, device=None) -> Params:
    """The port's parameters from the reference's pytree of numpy arrays."""
    dev = resolve_device(device)
    tree = dict(np_params)
    layers = tree["layers"]
    if cfg.scan_layers:
        layers = [_layer(layers, i) for i in range(cfg.n_layers)]
    elif len(layers) != cfg.n_layers:
        raise ValueError(f"expected {cfg.n_layers} layers, got {len(layers)}")
    tree["layers"] = list(layers)
    return Params(_tree(tree, dev))
