"""RecurrentGemma / Griffin blocks: the RG-LRU recurrence (port of ``repro.models.rglru``).

The RG-LRU (real-gated linear recurrent unit):

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is a diagonal first-order recurrence.  The reference evaluates it with
``jax.lax.associative_scan``; :func:`rglru_scan` runs ceil(log2 S)
Hillis-Steele steps of the same combine ``(a_l a_r, a_r b_l + b_r)`` in
float32, so a 1024-token prefill is 10 steps, not 1024.  The temporal-mixing
block is Griffin's: ``out = W_o(GeLU(W_y x) * RGLRU(conv4(W_x x)))``.
Everything here is plain torch: the reference computes it in jnp and reaches
no Pallas kernel.

Tensor parallelism over ``"model"`` (the block's ``group``, the model group
where it splits ``d_rnn``; the reference's rules): a rank holds its
``d_rnn / TP`` columns of ``w_y`` / ``w_x`` (column-parallel), its channels
of ``conv_w`` / ``conv_b`` / ``b_a`` / ``b_i`` / ``lam``, its rows of
``w_out`` (row-parallel, one sum at the end), and its ``nb / TP`` whole
blocks of ``w_a`` / ``w_i`` (``("model", None, None)``): a block's gates
read only its own channels, so the recurrence runs on the rank's channels
with no collective.  Where the group does not divide the block count (the
rules leave ``w_a`` / ``w_i`` whole), the gates and the scan run whole on
every rank over the gathered channels, and each rank keeps its own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from .common import dense_init
from .layers import _gelu_tanh

__all__ = [
    "init_rglru_block",
    "recurrent_block_apply",
    "recurrent_block_step",
    "rglru_reference",
    "rglru_scan",
    "rglru_step",
]


def init_rglru_block(generator: torch.Generator, d_model: int, d_rnn: int, d_conv: int, dtype,
                     n_gate_blocks: int = 16) -> dict:
    if d_rnn % n_gate_blocks:
        n_gate_blocks = 1
    db = d_rnn // n_gate_blocks
    dev = generator.device
    # Lambda init so a^c in ~(0.9, 0.999) (griffin appendix)
    u = torch.rand((d_rnn,), generator=generator, device=dev) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))  # softplus^-1(-log u)
    return {
        "w_y": dense_init(generator, (d_model, d_rnn), d_model, dtype),
        "w_x": dense_init(generator, (d_model, d_rnn), d_model, dtype),
        "conv_w": dense_init(generator, (d_conv, d_rnn), d_conv, dtype),
        "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=dev),
        # block-diagonal gate matrices, as Griffin's
        "w_a": dense_init(generator, (n_gate_blocks, db, db), db, dtype),
        "b_a": torch.zeros((d_rnn,), dtype=torch.float32, device=dev),
        "w_i": dense_init(generator, (n_gate_blocks, db, db), db, dtype),
        "b_i": torch.zeros((d_rnn,), dtype=torch.float32, device=dev),
        "lam": lam.float(),
        "w_out": dense_init(generator, (d_rnn, d_model), d_rnn, dtype),
    }


def _block_diag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., D) with D = nb*db; w: (nb, db, db) block-diagonal weights."""
    nb, db, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, db)
    yb = torch.einsum("...nd,ndk->...nk", xb, w)
    return yb.reshape(*x.shape[:-1], nb * db)


def _rglru_gates(params, x: torch.Tensor, c: float):
    """x: (..., d_rnn) float32 -> (a, b) of the recurrence h = a h_ + b."""
    r = torch.sigmoid(_block_diag_matmul(x, params["w_a"].float()) + params["b_a"])
    i = torch.sigmoid(_block_diag_matmul(x, params["w_i"].float()) + params["b_i"])
    log_a = -c * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x)
    return a, b


def rglru_scan(params, x: torch.Tensor, c: float, h0: Optional[torch.Tensor] = None):
    """Parallel evaluation over the sequence.  x: (B,S,D) -> (y, h_last float32)."""
    a, b = _rglru_gates(params, x.float(), c)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    # inclusive scan of (a, b) under (a_l a_r, a_r b_l + b_r), log-depth
    s, step = x.shape[1], 1
    while step < s:
        a_l, b_l = a[:, :-step], b[:, :-step]
        a_r, b_r = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_l * a_r], dim=1)
        b = torch.cat([b[:, :step], a_r * b_l + b_r], dim=1)
        step *= 2
    return b.to(x.dtype), b[:, -1]


def rglru_step(params, x_t: torch.Tensor, h: torch.Tensor, c: float):
    """Single decode step.  x_t: (B,D); h: (B,D) float32."""
    a, b = _rglru_gates(params, x_t.float(), c)
    h_new = a * h.float() + b
    return h_new.to(x_t.dtype), h_new


def _recur(params, x: torch.Tensor, h: Optional[torch.Tensor], c: float, group: tp.Group, fn):
    """``fn(params, x, h, c)`` (:func:`rglru_scan` or :func:`rglru_step`) on
    this rank's channels ``x`` and state ``h``.  Where ``w_a`` holds the
    rank's blocks (or the group is of one), directly; where it is whole, on
    the gathered channels with the split gate leaves gathered, each output
    cut back to the rank's channels."""
    w_a = params["w_a"]
    if group.size == 1 or w_a.shape[0] * w_a.shape[1] == x.shape[-1]:
        return fn(params, x, h, c)
    whole = dict(params)
    for k in ("b_a", "b_i", "lam"):
        whole[k] = tp.gather(params[k], group, -1)
    y, h_new = fn(whole, tp.gather(x, group, -1),
                  None if h is None else tp.gather(h, group, -1), c)
    return tp.scatter(y, group, -1), tp.scatter(h_new, group, -1)


def rglru_reference(params, x: torch.Tensor, c: float, h0: Optional[torch.Tensor] = None):
    """Sequential oracle."""
    xf = x.float()
    a, b = _rglru_gates(params, xf, c)
    h = torch.zeros_like(xf[:, 0]) if h0 is None else h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), h


def recurrent_block_apply(
    params,
    x: torch.Tensor,  # (B,S,d_model)
    c: float,
    conv_tail: Optional[torch.Tensor] = None,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
    group: tp.Group = tp.SINGLE,
    seq: tp.Group = tp.SINGLE,
):
    """Griffin temporal-mixing block (the RG-LRU branch x gated GeLU branch).
    Over a ``group`` of more than one rank, on this rank's channels: the
    tail and state in and out are its own.  Over a ``seq`` group (sequence
    parallelism) ``x`` and the output are this rank's rows: the whole rows
    are gathered, and the output leaves as the rank's rows of the sum."""
    x = tp.region_in(x, group, seq)
    y_branch = _gelu_tanh(x @ params["w_y"])
    xr = x @ params["w_x"]
    # causal depthwise conv, kernel d_conv, in the reference's term order
    k = params["conv_w"].shape[0]
    s = x.shape[1]
    if conv_tail is None:
        conv_tail = torch.zeros((x.shape[0], k - 1, xr.shape[-1]), dtype=xr.dtype,
                                device=xr.device)
    xp = torch.cat([conv_tail, xr], dim=1)
    xr = sum(xp[:, i : i + s] * params["conv_w"][i] for i in range(k))
    xr = xr + params["conv_b"]
    new_tail = xp[:, -(k - 1) :] if k > 1 else conv_tail
    rec, h_last = _recur(params, xr, h0, c, group,
                         lambda p, x, h, c: rglru_scan(p, x, c, h))
    out = tp.region_out((rec * y_branch) @ params["w_out"], group, seq)
    if return_state:
        return out, (new_tail, h_last)
    return out


def recurrent_block_step(params, x_t: torch.Tensor, c: float, conv_tail: torch.Tensor,
                         h: torch.Tensor, group: tp.Group = tp.SINGLE):
    """Decode step.  x_t: (B,1,d_model) -> (out, new conv tail, new h); over a
    ``group``, on this rank's channels."""
    x_t = tp.enter(x_t, group)
    y_branch = _gelu_tanh(x_t @ params["w_y"])
    xr = x_t @ params["w_x"]  # (B,1,D)
    k = params["conv_w"].shape[0]
    xp = torch.cat([conv_tail, xr], dim=1)  # (B,k,D)
    xc = sum(xp[:, -(k - i)] * params["conv_w"][i] for i in range(k)) + params["conv_b"]
    new_tail = xp[:, 1:]
    rec, h_new = _recur(params, xc, h, c, group, rglru_step)
    out = tp.leave((rec[:, None] * y_branch) @ params["w_out"], group)
    return out, new_tail, h_new
