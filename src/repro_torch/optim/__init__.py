"""Optimizer substrate: AdamW + schedules + global-norm clipping (port of ``repro.optim``).

Self-contained (no ``torch.optim``).  The optimizer's state is congruent with
the parameters: a mapping from each leaf's dotted path to its float32
moment, so it saves and restores beside them.
"""
from .adamw import AdamW, OptState, apply_updates, global_norm
from .schedule import constant, cosine_with_warmup, linear_with_warmup

__all__ = [
    "AdamW",
    "OptState",
    "apply_updates",
    "global_norm",
    "constant",
    "cosine_with_warmup",
    "linear_with_warmup",
]
