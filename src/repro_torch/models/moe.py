"""Mixture-of-Experts FFN with top-k routing and sort/gather dispatch.

Port of ``repro.models.moe``.  Assignments are sorted per batch row (stable,
by expert id), ranked within their expert, dropped past the capacity, and
gathered into a dense ``(E, C, d)`` block per row, which the expert products
consume as batched ``einsum``s.  The reference ``vmap``s ``_dispatch_row`` and
``_combine_row`` over the rows; :func:`_dispatch_rows` and
:func:`_combine_rows` do every row in one pass, each row's slots offset into
one flat buffer.

Two choices pin the reference's numbers where torch promises less:

* routing takes the first ``k`` of a stable descending sort, so a tie picks
  the lower expert id, as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order);
* the combine sums each token's ``k`` contributions left to right from zeros
  in sorted-assignment order (ascending expert id), the order of the
  reference's scatter-add, instead of ``index_add_``, whose CUDA atomics add
  in no fixed order and would make bf16 results change from run to run.

The decode step (S = 1, capacity 1) runs every expert's product, as the
reference does.  Covers dbrx (16 experts, top-4) and qwen3-moe (128, top-8).

Over a mesh (``tensor_parallel``): the experts are expert-parallel over the
model group where it divides E (the rules' ``("model", "fsdp", None)``).
The routing and the dispatch metadata are computed whole on every rank, each
rank gathers and runs only its ``E / TP`` experts' capacity blocks and
combines its own rows, and the partial outputs are summed over the group.
Capacity is per batch row (``k * S / E``), so it does not depend on how the
batch is sharded; the aux loss's two batch means, of the routed fractions
``f`` and of the router probabilities, are sums over the batch group
(``tensor_parallel.batch_group``, set by the mesh train step only: serving
discards the aux) divided by the global token count.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from .common import dense_init
from .layers import _gelu_tanh

__all__ = ["init_moe", "moe_ffn", "moe_ffn_reference"]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype) -> dict:
    return {
        "router": dense_init(generator, (d_model, n_experts), d_model, torch.float32),
        "w_gate": dense_init(generator, (n_experts, d_model, d_ff), d_model, dtype),
        "w_up": dense_init(generator, (n_experts, d_model, d_ff), d_model, dtype),
        "w_down": dense_init(generator, (n_experts, d_ff, d_model), d_ff, dtype),
    }


def _route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert ids (a tie to the lower id) and their softmax weights in float32."""
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_idx = top_logits[..., :k], top_idx[..., :k]
    return top_idx, torch.softmax(top_logits.float(), dim=-1)


def _dispatch_rows(x: torch.Tensor, expert_ids: torch.Tensor, n_experts: int, capacity: int,
                   first: int = 0, width: int | None = None):
    """Every row at once.  x: (B,S,d); expert_ids: (B,S,k).

    Returns the gathered expert inputs ``(B, E*C, d)`` and the combine
    metadata ``(token_of, slot, order, keep)``, each ``(B, S*k)`` and equal to
    the reference's ``_dispatch_row`` of each row.  With ``width``, only the
    slots ``[first, first + width)`` are gathered (an expert-parallel rank's
    experts), ``(B, width, d)``; the metadata stay whole.
    """
    b, s, k = expert_ids.shape
    d = x.shape[-1]
    n = s * k
    flat_e = expert_ids.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # token priority within expert
    sorted_e = torch.gather(flat_e, 1, order)
    token_of = order // k
    row = torch.arange(b, device=x.device)[:, None]
    # the reference's bincount(length=E) per row; torch.bincount reads the
    # input's max back to the host on CUDA, so count by scatter_add_
    counts = torch.zeros((b, n_experts), dtype=flat_e.dtype, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix
    rank = torch.arange(n, device=x.device)[None, :] - torch.gather(starts, 1, sorted_e)
    keep = rank < capacity
    sentinel = n_experts * capacity
    slot = torch.where(keep, sorted_e * capacity + rank, sentinel)
    into = slot
    if width is not None and width < sentinel:  # other ranks' slots go to the drop slot
        into = slot - first
        into = torch.where((into >= 0) & (into < width), into, width)
        sentinel = width
    # one flat buffer of B rows of E*C + 1 slots; the last slot of a row takes
    # its drops and is cut off (the reference's mode="drop" and xg[:-1])
    xg = torch.zeros((b * (sentinel + 1), d), dtype=x.dtype, device=x.device)
    src = torch.gather(x, 1, token_of[..., None].expand(b, n, d))
    xg.index_copy_(0, (into + row * (sentinel + 1)).reshape(-1), src.reshape(b * n, d))
    xg = xg.view(b, sentinel + 1, d)[:, :sentinel]
    return xg, (token_of, slot, order, keep)


def _combine_rows(y_flat: torch.Tensor, meta, weights: torch.Tensor, s: int,
                  first: int | None = None) -> torch.Tensor:
    """y_flat: (B, E*C, d) expert outputs -> (B, S, d), each token's k
    contributions summed left to right in sorted-assignment order.  With
    ``first``, ``y_flat`` holds the slots from ``first`` on (an
    expert-parallel rank's experts) and a token's rows in other slots count
    as zeros."""
    token_of, slot, order, keep = meta
    b, n = slot.shape
    k = n // s
    d = y_flat.shape[-1]
    w = torch.gather(weights.reshape(b, n), 1, order).to(y_flat.dtype)  # sorted order
    if first is not None:  # a rank's slots only
        slot = slot - first
        keep = keep & (slot >= 0) & (slot < y_flat.shape[1])
        slot = slot.clamp(min=0)
    idx = slot.clamp(max=y_flat.shape[1] - 1)
    y_rows = torch.gather(y_flat, 1, idx[..., None].expand(b, n, d))
    y_rows = y_rows * (w * keep.to(y_flat.dtype))[..., None]
    # each token's sorted positions, ascending: where its k rows sit in y_rows
    inv = torch.argsort(order, dim=-1)  # assignment -> sorted position
    pos = torch.sort(inv.reshape(b, s, k), dim=-1).values.reshape(b, n)
    rows = torch.gather(y_rows, 1, pos[..., None].expand(b, n, d)).reshape(b, s, k, d)
    out = torch.zeros((b, s, d), dtype=y_flat.dtype, device=y_flat.device)
    for j in range(k):
        out = out + rows[:, :, j]
    return out


def moe_ffn(
    params,
    x: torch.Tensor,
    n_experts_per_tok: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
    seq: tp.Group = tp.SINGLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Routing and aux math in float32.  Over
    a ``seq`` group (sequence parallelism) ``x`` and ``y`` are this rank's
    rows: the whole rows are gathered first (the routing, the aux loss and
    the per-row capacity see the whole sequence, as without it)."""
    x = tp.gather(x, seq, 1)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    k = n_experts_per_tok
    capacity = max(1, math.ceil(k * s / e * capacity_factor))  # per row

    logits = (x.float() @ params["router"]).float()  # (B,S,E)
    expert_ids, weights = _route(logits, k)

    # load-balancing aux loss (Switch-style): E * sum_i f_i * P_i
    probs = torch.softmax(logits, dim=-1)
    counts = F.one_hot(expert_ids, e).float().sum(dim=-2)  # (B,S,E)
    bg = tp.batch_group()
    if bg.size == 1:
        f = counts.mean(dim=(0, 1)) / k
        aux = e * torch.sum(f * probs.mean(dim=(0, 1)))
    else:  # the means of the global batch: sums over the batch shards
        n = b * s * bg.size
        f = bg.all_reduce_sum(counts.sum(dim=(0, 1))) / n / k
        aux = e * torch.sum(f * (tp.leave(probs.sum(dim=(0, 1)), bg) / n))

    eg = tp.model_group().over(e)  # expert-parallel: this rank's E / TP experts
    el = e // eg.size
    first, width = eg.rank * el * capacity, el * capacity  # this rank's slots
    xg, meta = _dispatch_rows(tp.enter(x, eg), expert_ids, e, capacity, first, width)
    xg = xg.reshape(b, el, capacity, d)
    fn = F.silu if act == "silu" else _gelu_tanh  # jax.nn.gelu's default: tanh
    g = torch.einsum("becd,edf->becf", xg, params["w_gate"])
    u = torch.einsum("becd,edf->becf", xg, params["w_up"])
    y = torch.einsum("becf,efd->becd", fn(g) * u, params["w_down"])
    out = _combine_rows(y.reshape(b, width, d), meta, tp.enter(weights, eg), s,
                        None if eg.size == 1 else first)
    return tp.region_out(out, eg, seq).to(x.dtype), aux


def moe_ffn_reference(params, x: torch.Tensor, n_experts_per_tok: int, act: str = "silu"):
    """Oracle: every expert on every token (no capacity drop); test sizes only."""
    e = params["router"].shape[-1]
    logits = x.float() @ params["router"]
    expert_ids, weights = _route(logits, n_experts_per_tok)
    fn = F.silu if act == "silu" else _gelu_tanh
    g = torch.einsum("bsd,edf->besf", x, params["w_gate"])
    u = torch.einsum("bsd,edf->besf", x, params["w_up"])
    y_all = torch.einsum("besf,efd->besd", fn(g) * u, params["w_down"])  # (B,E,S,d)
    onehot = F.one_hot(expert_ids, e).float()  # (B,S,k,E)
    w = torch.einsum("bske,bsk->bse", onehot, weights)  # per-expert combine weight
    return torch.einsum("besd,bse->bsd", y_all, w.to(x.dtype)).to(x.dtype)
