"""Unified model API over the zoo: ``build_model(cfg) -> Model``.

Port of ``repro.models``.  ``Model`` holds the same callables as the
reference's; ``init`` takes a ``torch.Generator`` (its device is where the
weights land) in place of a ``jax.random`` key.  The reference's
``input_specs`` / ``cache_specs`` / ``param_specs`` are ``jax.eval_shape``
stand-ins for its dry run and have no counterpart here.  Only the ``dense``
family is ported; the others raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ArchConfig
from . import transformer

__all__ = ["Model", "build_model"]

_NOT_YET = {
    "moe": "models/moe.py",
    "vlm": "the M-RoPE inputs of the vlm family",
    "encoder": "the encoder family",
    "hybrid": "models/rglru.py and models/hybrid.py",
    "ssm": "models/mamba.py and models/ssm.py",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable  # (generator) -> params
    train_loss: Callable  # (params, batch) -> (loss, metrics)
    prefill: Callable  # (params, batch, max_len) -> (last_logits, cache, t)
    decode_step: Callable  # (params, cache, tokens, t) -> (logits, cache, t+1)
    init_cache: Callable  # (batch, max_len) -> cache
    for_serving: Callable  # (params) -> the compute-dtype copy serving keeps


def _transformer_model(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator: transformer.init_params(generator, cfg),
        train_loss=lambda p, b: transformer.train_loss(p, cfg, b),
        prefill=lambda p, b, max_len: transformer.prefill(p, cfg, b, max_len),
        decode_step=lambda p, c, tok, t: transformer.decode_step(p, cfg, c, tok, t),
        init_cache=lambda b, max_len: transformer.init_cache(
            cfg, _batch_size(b), max_len, device=_batch_device(b)
        ),
        for_serving=lambda p: transformer.cast_for_serving(p, cfg),
    )


def _first(batch):
    for k in ("tokens", "embeds"):
        if k in batch:
            return batch[k]
    raise ValueError("batch has no tokens/embeds")


def _batch_size(batch) -> int:
    return _first(batch).shape[0]


def _batch_device(batch):
    return _first(batch).device


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "dense":
        return _transformer_model(cfg)
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"the {cfg.family} family of {cfg.name} is not ported yet: it waits for "
            f"{_NOT_YET[cfg.family]} (ROADMAP.md queue 1, item 6)"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
