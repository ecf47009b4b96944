"""Train-step construction: autograd + AdamW, on one device or over a mesh.

Port of ``repro.runtime.train``.  A train step is a function of
``(TrainState, batch)`` returning the next state and the step's metrics, as
the reference's; PyTorch runs it eagerly.  Gradients come from
``torch.autograd.grad`` of the model's ``train_loss`` with respect to every
leaf of the float32 master weights; AdamW then builds the next parameters
(the previous state stays as it was).

The mesh half (``state_shardings``, ``jit_train_step``, ``jit_init_state``)
keeps the reference's names; nothing is compiled.  Over a ``DeviceMesh`` the
parameters and both AdamW moments are DTensors placed by
``sharding.param_shardings``.  A mesh step gathers the parameters over every
axis that shards them but ``"model"`` (FSDP-style), so the forward and its
kernels run on plain tensors; it runs data-parallel over the batch axes,
sums the gradients over them, and each rank applies AdamW to its own
shards.  It has the reference's global-batch semantics: the cross-entropy
divides by the mask sum of the whole global batch (all-reduced before the
backward), and the clipping norm is taken over the whole summed gradient.

Tensor parallelism over ``"model"`` (every family), as XLA's partitioner
splits the reference: each model rank keeps its model shard of every leaf
the rules shard there and computes on it (head-parallel attention, column /
row MLPs, expert-parallel MoE, the state-space mixer on its heads and the
RG-LRU on its blocks with their gated norm a split row, vocab-parallel
embedding, unembedding and cross-entropy;
``distributed/tensor_parallel.py``), the model group reached through the
step's ``logical_axes`` context.  A model-sharded leaf's gradient is its
model shard; a replicated leaf's is whole (summed over the group inside the
model where a rank-local region read it).  The clipping norm sums each
shard's squares over the group and counts each replicated leaf once.  On a
model axis of size 1 no collective runs and the step is the plain
step, bitwise.

The MoE router's aux loss takes its two batch means over the global batch
(sums over the batch group inside ``models/moe.py``); it enters the
objective unweighted, so the batch ranks' summed gradients are the global
batch's.  Capacity is per sequence row and needs no collective.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..distributed import sharding
from ..distributed import tensor_parallel as tp
from ..distributed.axes import logical_axes
from ..models import Model
from ..optim import AdamW, OptState, apply_updates, global_norm
from ..spans import span

__all__ = ["TP_FAMILIES", "TrainState", "default_microbatches", "init_state", "jit_init_state",
           "jit_train_step", "make_train_step", "model_axes", "param_shapes", "shard_state",
           "state_shardings"]

# the families whose compute is split over "model": every one
TP_FAMILIES = ("dense", "moe", "vlm", "encoder", "ssm", "hybrid")


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
    with span("train.forward"):
        loss, metrics = model.train_loss(params, batch)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads


def _accumulate(value_and_grad: Callable, batch, microbatches: int):
    """``value_and_grad(batch)``, or with ``microbatches = M > 1`` its mean
    over M chunks of the batch's rows: float32 gradient sums over M, the
    loss sum over M, each metric's mean over the chunks."""
    if microbatches == 1:
        return value_and_grad(batch)
    chunks = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
              for k, v in batch.items()}
    gsum, lsum, metrics_all = None, 0.0, []
    for i in range(microbatches):
        loss_i, metrics_i, g_i = value_and_grad({k: v[i] for k, v in chunks.items()})
        if gsum is None:  # zeros + g: the first chunk's gradients, in float32
            gsum = {k: g.float() for k, g in g_i.items()}
        else:
            for k, g in g_i.items():
                gsum[k].add_(g.float())
        lsum = lsum + loss_i
        metrics_all.append(metrics_i)
    grads = {k: g / microbatches for k, g in gsum.items()}
    metrics = {k: torch.stack([m[k] for m in metrics_all]).mean() for k in metrics_all[0]}
    return lsum / microbatches, metrics, grads


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
        loss, metrics, grads = _accumulate(
            lambda chunk: _value_and_grad(model, state.params, chunk), batch, microbatches)
        with span("train.optimizer"):
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


# ---------------------------------------------------------------------------
# the mesh half
# ---------------------------------------------------------------------------


def param_shapes(model: Model) -> Dict[str, torch.Tensor]:
    """The parameters by leaf path as fake tensors: shapes and dtypes with no
    storage (the reference's ``param_specs``, traced under ``FakeTensorMode``)."""
    with FakeTensorMode():
        return model.init(torch.Generator()).leaves()


def state_shardings(mesh, model: Model, optimizer: AdamW, axes=None) -> TrainState:
    """NamedSharding tree congruent with TrainState (opt moments ~ params)."""
    p_sh = sharding.param_shardings(mesh, param_shapes(model), axes)
    scalar = sharding.scalar_sharding(mesh)
    return TrainState(step=scalar, params=p_sh, opt_state=OptState(count=scalar, m=p_sh, v=p_sh))


def shard_state(state: TrainState, st_sh: TrainState) -> TrainState:
    """A plain TrainState (the same on every rank) as DTensors placed by
    ``st_sh``; each rank keeps its own shards (no collective)."""
    params = state.params.replace_leaves(
        {k: sharding.distribute(p.detach(), st_sh.params[k])
         for k, p in state.params.leaves().items()})
    opt = state.opt_state
    return TrainState(state.step, params, OptState(
        opt.count,
        {k: sharding.distribute(t, st_sh.opt_state.m[k]) for k, t in opt.m.items()},
        {k: sharding.distribute(t, st_sh.opt_state.v[k]) for k, t in opt.v.items()},
    ))


def jit_init_state(mesh, model: Model, optimizer: AdamW):
    """``(init, st_sh)``: ``init(generator)`` is :func:`init_state` placed on
    the mesh by :func:`state_shardings` (nothing is compiled)."""
    st_sh = state_shardings(mesh, model, optimizer)
    return (lambda generator: shard_state(init_state(model, optimizer, generator), st_sh)), st_sh


def _input_shapes(model: Model, shape) -> Dict[str, torch.Size]:
    """The reference's ``input_specs`` for a train cell, as shapes."""
    cfg, b, s = model.cfg, shape.global_batch, shape.seq_len
    out: Dict[str, torch.Size] = {}
    if cfg.family in ("vlm", "encoder"):  # modality frontend is a stub
        out["embeds"] = torch.Size((b, s, cfg.d_model))
    else:
        out["tokens"] = torch.Size((b, s))
    if cfg.family == "vlm":
        out["mrope_positions"] = torch.Size((b, s, 3))
    out["labels"] = torch.Size((b, s))
    out["loss_mask"] = torch.Size((b, s))
    return out


class _BatchAxes(tp.MeshGroup):
    """The batch axes of a mesh as a group: this rank's index among the batch
    shards (``rank``), their count (``size``) and this rank's rows."""

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (dim 0), or every row
        where they do not divide over the batch shards (a microbatch of fewer
        rows than shards): the rules' replication of a dim the axes do not
        divide.  The step's global normalisation holds either way: the CE
        weight is then one over the shards, and the MoE aux loss's batch
        means divide by the rows times the shards."""
        return x if x.shape[0] % self.size else x[self.part(x.shape[0])]


def model_axes(model: Model, axes: sharding.MeshAxes) -> tuple:
    """The mesh axes a mesh step keeps its parameters' shards over while it
    computes: ``(axes.model,)`` for a family split over it, else ``()``."""
    return (axes.model,) if axes.model and model.cfg.family in TP_FAMILIES else ()


def _mesh_value_and_grad(model: Model, params, batch, bx: _BatchAxes):
    """:func:`_value_and_grad` of this rank's rows, normalised by the whole
    global batch: the CE loss's divisor ``max(mask.sum(), 1)`` becomes the
    mask sum over every batch shard (all-reduced before the backward), so
    summing the ranks' gradients gives the global batch's.  An MoE family's
    aux loss is a statistic of the global batch already (``moe_ffn`` sums
    over the batch group), so it enters unweighted.  Returns the global loss
    and metrics and this rank's gradients."""
    leaves = params.leaves()
    mask = batch.get("loss_mask")
    labels = batch["labels"]
    dev = labels.device
    local = (mask.float().sum() if mask is not None
             else torch.tensor(float(labels.numel()), device=dev))
    total = bx.all_reduce_sum(local)
    # exactly 1.0 on one batch shard (x / x), so the step is the plain one there
    w = torch.clamp(local, min=1.0) / torch.clamp(total, min=1.0)
    loss, metrics = model.train_loss(params, batch)
    moe = model.cfg.is_moe and bx.size > 1
    aux = model.cfg.router_aux_loss * metrics["moe_aux"] if moe else None
    objective = metrics["loss"] * w + aux if moe else loss * w
    grads = torch.autograd.grad(objective, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    metrics = {k: bx.all_reduce_sum(m.detach() * w) if k == "loss" else m.detach()
               for k, m in metrics.items()}
    total = metrics["loss"] + aux.detach() if moe else bx.all_reduce_sum(loss.detach() * w)
    return total, metrics, grads


def jit_train_step(mesh, model: Model, optimizer: AdamW, shape, donate: bool = True,
                   microbatches: int = 1, mesh_axes=None):
    """The mesh train step + the (state, batch) shardings it uses.

    Returns ``(step, st_sh, b_sh)`` as the reference's; ``step(state,
    batch)`` takes a state placed by ``st_sh`` (:func:`jit_init_state`,
    :func:`shard_state`) and the global batch -- plain tensors, the same on
    every rank, or DTensors placed by ``b_sh`` -- and returns the next state
    (DTensors again) and the metrics, the same on every rank.  Nothing is
    compiled, and the step keeps no reference to the state it was given
    (``donate`` is accepted for the reference's signature).  With
    ``microbatches = M`` the global batch splits into M chunks of rows, as the
    reference's, and each rank takes its rows of each chunk.
    """
    del donate
    axes = mesh_axes or sharding.MeshAxes.infer(mesh)
    st_sh = state_shardings(mesh, model, optimizer, axes)
    b_sh = sharding.batch_shardings(mesh, _input_shapes(model, shape), axes)
    bx = _BatchAxes(mesh, axes.batch)
    keep = model_axes(model, axes)
    tpg = tp.MeshGroup(mesh, keep)
    slices: Dict[str, tuple] = {}  # each leaf's shard of its gradient, by path

    def step(state: TrainState, batch: Dict[str, Any]):
        with logical_axes(mesh, axes.batch, axes.model, seq=model.cfg.sequence_parallel,
                          tp=tpg, dp=bx):
            return _mesh_step(model, optimizer, microbatches, bx, tpg, keep, slices, state,
                              batch)

    return step, st_sh, b_sh


def _grad_norm(grads: Dict[str, torch.Tensor], split, tpg: tp.Group) -> torch.Tensor:
    """The clipping norm of the whole gradient from this rank's: each leaf's
    sum of squares, those of the leaves ``split`` over the model group summed
    over it (one all-reduce), each replicated leaf counted once; in the plain
    step's leaf order, and its expressions where the group is of one."""
    if tpg.size == 1 or not split:
        return global_norm(grads)
    sq = {k: torch.sum(torch.square(g.float())) for k, g in grads.items()}
    keys = [k for k in grads if k in split]
    sq.update(zip(keys, tpg.all_reduce_sum(torch.stack([sq[k] for k in keys])).unbind()))
    return torch.sqrt(torch.sum(torch.stack(list(sq.values()))))


def _mesh_step(model: Model, optimizer: AdamW, microbatches: int, bx: _BatchAxes,
               tpg: tp.Group, keep: tuple, slices: Dict[str, tuple], state: TrainState, batch):
    leaves = state.params.leaves()  # path -> DTensor, in the plain tree's order
    with torch.no_grad():
        # each leaf whole but over the model axis: a leaf split there stays its shard
        full = {k: sharding.gather(p, keep).detach().requires_grad_(True)
                for k, p in leaves.items()}
    split = {k for k, p in leaves.items() if full[k].shape != p.shape} if tpg.size > 1 else set()
    params = state.params.replace_leaves(full)
    batch = {k: sharding.gather(v) for k, v in batch.items()}  # the global batch

    def value_and_grad(chunk):
        return _mesh_value_and_grad(model, params, {k: bx.rows(v) for k, v in chunk.items()}, bx)

    loss, metrics, grads = _accumulate(value_and_grad, batch, microbatches)
    del params, full
    with torch.no_grad():
        for g in grads.values():
            bx.all_reduce_sum(g, inplace=True)
        # the clipping norm of the whole summed gradient, in the plain step's leaf order
        gnorm = _grad_norm({k: grads[k] for k in leaves}, split, tpg)
        opt = state.opt_state
        local = {k: p.to_local() for k, p in leaves.items()}
        g_local = {}
        for k, p in leaves.items():
            if k not in slices:  # the gradient is whole but over the model axis
                slices[k] = sharding.local_slice(grads[k].shape, sharding.spec_of(p),
                                                 p.device_mesh, p.device_mesh.get_coordinate(),
                                                 skip=keep)
            g_local[k] = grads[k][slices[k]]
        del grads
        updates, new_opt, opt_metrics = optimizer.update_shards(
            g_local, OptState(opt.count, {k: m.to_local() for k, m in opt.m.items()},
                              {k: v.to_local() for k, v in opt.v.items()}),
            local, gnorm)
        del g_local
        new_local = apply_updates(local, updates)

    place = sharding.with_local
    params = state.params.replace_leaves({k: place(p, new_local[k]) for k, p in leaves.items()})
    opt_state = OptState(new_opt.count, {k: place(opt.m[k], t) for k, t in new_opt.m.items()},
                         {k: place(opt.v[k], t) for k, t in new_opt.v.items()})
    metrics = {**metrics, **opt_metrics, "loss_total": loss}
    return TrainState(state.step + 1, params, opt_state), metrics
