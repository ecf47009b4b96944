"""Train-step construction: autograd + AdamW on one device.

Port of ``repro.runtime.train``.  A train step is a function of
``(TrainState, batch)`` returning the next state and the step's metrics, as
the reference's; PyTorch runs it eagerly on one card.  Gradients come from
``torch.autograd.grad`` of the model's ``train_loss`` with respect to every
leaf of the float32 master weights; AdamW then builds the next parameters
(the previous state stays as it was).  The reference's ``state_shardings``,
``jit_train_step`` and ``jit_init_state`` are mesh code: they wait for
``distributed/`` on ``torch.distributed`` (``ROADMAP.md`` §1, item 2).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from ..models import Model
from ..optim import AdamW, OptState, apply_updates

__all__ = ["TrainState", "default_microbatches", "init_state", "make_train_step"]


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Any  # Params: float32 master weights that require grad
    opt_state: OptState


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator) -> TrainState:
    """Seeded trainable master weights on the generator's device, and zero moments."""
    params = model.init(generator).trainable()
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return TrainState(step, params, optimizer.init(params))


def _value_and_grad(model: Model, params, batch):
    """``(loss, metrics, grads)``, the grads by leaf path; a leaf the forward
    never reads gets zeros, as under ``jax.grad``."""
    leaves = params.leaves()
    loss, metrics = model.train_loss(params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads


def make_train_step(model: Model, optimizer: AdamW, microbatches: int = 1) -> Callable:
    """Train step with optional gradient accumulation.

    ``microbatches > 1`` splits the global batch along dim 0 and runs the
    loss and its gradients over the chunks in turn, accumulating float32
    gradient sums -- the standard way to fit large-activation cells into
    device memory while keeping the *global* batch semantics.  The step
    then takes ``grads / M`` and ``loss / M``, and each metric's mean over
    the chunks.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(model, state.params, batch)
        else:
            chunks = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                      for k, v in batch.items()}
            gsum, lsum, metrics_all = None, 0.0, []
            for i in range(microbatches):
                loss_i, metrics_i, g_i = _value_and_grad(
                    model, state.params, {k: v[i] for k, v in chunks.items()})
                if gsum is None:  # zeros + g: the first chunk's gradients, in float32
                    gsum = {k: g.float() for k, g in g_i.items()}
                else:
                    for k, g in g_i.items():
                        gsum[k].add_(g.float())
                lsum = lsum + loss_i
                metrics_all.append(metrics_i)
            grads = {k: g / microbatches for k, g in gsum.items()}
            loss = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in metrics_all]).mean()
                       for k in metrics_all[0]}
        updates, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params
        )
        del grads  # freed before the next parameters are made: a copy of the model less at peak
        params = apply_updates(state.params, updates)
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return TrainState(state.step + 1, params, opt_state), metrics

    return train_step


def default_microbatches(model: Model, shape) -> int:
    """Pick grad-accumulation depth so activations fit ~6GB/device.

    The reference's rule, for its production mesh (16-way data parallel,
    vocab 16-way tensor parallel): with full remat the live set is ~ per-layer
    saved inputs plus the fp32 logits pipeline,
      act ~ (L * t * d * 2  +  t * V_pad/16 * 12) / M   per device.
    """
    cfg = model.cfg
    dp = 16  # production data-axis width
    t = shape.global_batch * shape.seq_len // dp  # tokens per device
    act = cfg.n_layers * t * cfg.d_model * 2 + t * (cfg.padded_vocab // 16) * 12
    m = 1
    rows = shape.global_batch
    while act / m > 6e9 and m < rows and rows % (2 * m) == 0:
        m *= 2
    return m
