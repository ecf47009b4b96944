"""Serving-step construction: prefill + batched single-token decode.

Port of ``repro.runtime.serve``.  The reference's ``jit_prefill`` /
``jit_serve_step`` wrap these steps in ``jax.jit`` with mesh shardings and
cache donation; PyTorch runs eagerly on one card and the decode cache is
written in place, so they have no counterpart here (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable

from ..models import Model

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(model: Model, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(params, cache, tokens, t):
        return model.decode_step(params, cache, tokens, t)

    return serve_step
