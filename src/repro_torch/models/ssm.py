"""Mamba-2 (SSD, state-space duality) blocks (port of ``repro.models.ssm``).

Prefill uses the chunked SSD algorithm: the sequence is cut into chunks of
``Q`` steps; within a chunk the recurrence runs in its quadratic dual form
(per-head Q x Q decay-masked scores), and the chunk-boundary state is carried
from chunk to chunk.  The reference carries it with ``lax.scan``; here a
Python loop walks the S / Q chunks (8 at a 1024-token prompt, Q = 128), each
chunk's work a handful of batched products.  Decode is the O(1) recurrent
update on the cached state.

Layout follows mamba2-2.7b: d_inner = 2 d_model, scalar-per-head A, B/C
shared across heads (n_groups = 1), causal conv (k = 4), gated RMSNorm
before ``out_proj``; the projections are stored separately (``w_z``,
``w_x``, ``w_bc``, ``w_dt``), as the reference stores them.  The gated
RMSNorm goes to the RMSNorm kernel at width d_inner; everything else is
plain torch, as the reference leaves it to XLA.

The chunk's decay masks its upper triangle before the exp, where the
reference masks after it: once a chunk's log-decay spans more than
float32's exp range the reference's masked entries are inf and its backward
NaN (mamba2-2.7b's full-width training); the forward values are the same.

Tensor parallelism over ``"model"`` (:func:`_groups`; the reference's rules,
``distributed/sharding.py``): where the model group splits the heads, a
rank holds its ``nh / TP`` heads' columns of ``w_z`` / ``w_x`` / ``w_dt``
(column-parallel), its channels of ``conv_x`` / ``conv_x_b`` / ``norm_w``,
its heads of ``A_log`` / ``dt_bias`` / ``D`` and its rows of ``out_proj``
(row-parallel, one sum at the end); ``w_bc`` / ``conv_bc`` stay whole on
every rank (entered: B and C are shared across heads, so each rank's
gradient of them is partial).  The SSD scan runs on the rank's heads with
no collective; the gated norm is a row split over the group
(``kernels/rmsnorm.py::rms_norm_split``: one sum of the rows' squares).
Where the group splits ``d_inner`` but not the heads, the rules split the
channel leaves alone: the rank's channels are gathered whole after the conv
and the mixer runs whole on every rank, then each rank multiplies its
channels by its row shard of ``out_proj``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..kernels.rmsnorm import rms_norm_split
from .common import dense_init

__all__ = [
    "SSMDims",
    "init_ssm_layer",
    "ssd_chunked",
    "ssd_reference",
    "ssm_decode_step",
    "ssm_layer_apply",
]


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    headdim: int
    d_state: int
    d_conv: int
    chunk: int

    @staticmethod
    def from_config(cfg) -> "SSMDims":
        d_inner = cfg.ssm_expand * cfg.d_model
        return SSMDims(
            d_model=cfg.d_model,
            d_inner=d_inner,
            n_heads=d_inner // cfg.ssm_headdim,
            headdim=cfg.ssm_headdim,
            d_state=cfg.ssm_state,
            d_conv=cfg.ssm_conv,
            chunk=cfg.ssm_chunk,
        )


def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo


def init_ssm_layer(generator: torch.Generator, dims: SSMDims, dtype) -> dict:
    dev = generator.device
    # dt bias initialized so softplus(dt_bias) spans ~[1e-3, 1e-1] (mamba init)
    u = _uniform(generator, (dims.n_heads,), math.log(1e-3), math.log(1e-1))
    dt_init = torch.log(torch.expm1(torch.exp(u)))  # inverse softplus
    return {
        "w_z": dense_init(generator, (dims.d_model, dims.d_inner), dims.d_model, dtype),
        "w_x": dense_init(generator, (dims.d_model, dims.d_inner), dims.d_model, dtype),
        "w_bc": dense_init(generator, (dims.d_model, 2 * dims.d_state), dims.d_model, dtype),
        "w_dt": dense_init(generator, (dims.d_model, dims.n_heads), dims.d_model, dtype),
        "conv_x": dense_init(generator, (dims.d_conv, dims.d_inner), dims.d_conv, dtype),
        "conv_x_b": torch.zeros((dims.d_inner,), dtype=dtype, device=dev),
        "conv_bc": dense_init(generator, (dims.d_conv, 2 * dims.d_state), dims.d_conv, dtype),
        "conv_bc_b": torch.zeros((2 * dims.d_state,), dtype=dtype, device=dev),
        "A_log": torch.log(_uniform(generator, (dims.n_heads,), 1.0, 16.0)),
        "dt_bias": dt_init.float(),
        "D": torch.ones((dims.n_heads,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((dims.d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (dims.d_inner, dims.d_model), dims.d_inner, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv, then SiLU.  x: (B,S,C); w: (K,C); tail: (B,K-1,C) history."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(k)) + b
    new_tail = xp[:, -(k - 1) :] if k > 1 else tail
    return F.silu(out), new_tail


def ssd_chunked(
    x: torch.Tensor,  # (B,S,nh,hp)
    dt: torch.Tensor,  # (B,S,nh) post-softplus, float32
    a_neg: torch.Tensor,  # (nh,) negative A, float32
    bmat: torch.Tensor,  # (B,S,N)
    cmat: torch.Tensor,  # (B,S,N)
    d_skip: torch.Tensor,  # (nh,)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B,nh,N,hp) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,S,nh,hp) float32, final state (B,nh,N,hp) float32)."""
    b, s, nh, hp = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = x.reshape(b, nc, q, nh, hp).float()
    dtc = dt.reshape(b, nc, q, nh)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    h = torch.zeros((b, nh, n, hp), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))  # i >= j
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        a = dtq * a_neg  # (B,Q,nh) log-decay per step (negative)
        cum = torch.cumsum(a, dim=1)  # inclusive
        # intra-chunk dual form
        cb = torch.einsum("bqn,bkn->bqk", cq, bq)  # (B,Q,Q)
        # (B,Q,Q,nh): i,j; the upper triangle masked before the exp, not after
        # (the reference's order), whose exp overflows to inf once a chunk's
        # log-decay spans more than float32's range, and inf * 0 makes the
        # backward NaN; the forward's values are the same
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.exp(torch.where(tri[None, :, :, None], diff, -math.inf))
        dtx = dtq[..., None] * xq  # (B,Q,nh,hp)
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", cb, decay, dtx)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bqn,bhnp->bqhp", cq, h) * torch.exp(cum)[..., None]
        # state for the next chunk: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
        w = torch.exp(cum[:, -1:, :] - cum) * dtq  # (B,Q,nh)
        s_new = torch.einsum("bqn,bqh,bqhp->bhnp", bq, w, xq)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + s_new
        ys.append(y + d_skip[None, None, :, None] * xq)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, nh, hp)[:, :s]
    return y, h


def ssd_reference(x, dt, a_neg, bmat, cmat, d_skip, h0=None):
    """Naive sequential recurrence oracle."""
    b, s, nh, hp = x.shape
    n = bmat.shape[-1]
    h = torch.zeros((b, nh, n, hp), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    ys = []
    for t in range(s):
        a_t = torch.exp(dt[:, t] * a_neg)  # (B,nh)
        upd = torch.einsum("bn,bh,bhp->bhnp", bmat[:, t], dt[:, t], x[:, t].float())
        h = a_t[:, :, None, None] * h + upd
        y = torch.einsum("bn,bhnp->bhp", cmat[:, t], h) + d_skip[None, :, None] * x[:, t]
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _groups(dims: SSMDims) -> Tuple[tp.Group, tp.Group]:
    """``(inner, heads)``: the model group where it splits ``d_inner`` (the
    channel leaves are then this rank's), and where it also splits the
    heads (the mixer then runs on the rank's heads; else it is
    :data:`~repro_torch.distributed.tensor_parallel.SINGLE` and the mixer runs whole)."""
    inner = tp.model_group().over(dims.d_inner)
    return inner, inner.over(dims.n_heads)


def _front(params, dims: SSMDims, x_in: torch.Tensor, tail_x, tail_bc,
           seq: tp.Group = tp.SINGLE):
    """The projections, both causal convs and the gates, on the rank's
    channels and heads where the group splits the heads, or gathered whole
    where it splits ``d_inner`` alone.  Returns ``(z, xr, bmat, cmat, dt,
    a_neg, norm_w, (tail_x, tail_bc), heads, inner)``, the tails of the
    rank's channels.  Over a ``seq`` group ``x_in`` is this rank's rows."""
    inner, heads = _groups(dims)
    # column-parallel products: each rank's input gradient is partial; the
    # shared ones (B, C, dt) too where the mixer is per head, else whole
    xc = tp.region_in(x_in, inner, seq)
    xs = xc if heads is inner else tp.gather(x_in, seq, 1)
    z = xc @ params["w_z"]
    xr = xc @ params["w_x"]
    bcmat = xs @ tp.enter(params["w_bc"], heads)
    dt_raw = xs @ params["w_dt"]
    xr, new_tail_x = _causal_conv(xr, params["conv_x"], params["conv_x_b"], tail_x)
    bcmat, new_tail_bc = _causal_conv(bcmat, tp.enter(params["conv_bc"], heads),
                                      tp.enter(params["conv_bc_b"], heads), tail_bc)
    norm_w = params["norm_w"]
    if heads is not inner:  # only d_inner splits: the mixer runs whole on every rank
        z, xr, norm_w = (tp.gather(t, inner, -1) for t in (z, xr, norm_w))
    bmat, cmat = torch.chunk(bcmat, 2, dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_neg = -torch.exp(params["A_log"])
    return z, xr, bmat, cmat, dt, a_neg, norm_w, (new_tail_x, new_tail_bc), heads, inner


def _back(params, y: torch.Tensor, z: torch.Tensor, norm_w: torch.Tensor, heads: tp.Group,
          inner: tp.Group) -> torch.Tensor:
    """The gated norm (a row split over ``heads``) and the row-parallel
    ``out_proj`` (the rank's channels of a whole ``y`` where only ``d_inner``
    splits): the rank's partial product, which the caller sums over ``inner``."""
    y = rms_norm_split(y * F.silu(z), norm_w, heads)
    if heads is not inner:
        y = tp.scatter(y, inner, -1)
    return y @ params["out_proj"]


def ssm_layer_apply(
    params,
    dims: SSMDims,
    x_in: torch.Tensor,  # (B,S,d_model)
    conv_tail_x: Optional[torch.Tensor] = None,
    conv_tail_bc: Optional[torch.Tensor] = None,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
    seq: tp.Group = tp.SINGLE,
):
    """Full mamba2 mixer.  Returns y (B,S,d) [+ (tails, h) if requested];
    over a model group, the rank's tails and state (its channels and heads).
    Over a ``seq`` group (sequence parallelism) ``x_in`` and ``y`` are this
    rank's rows: the whole rows are gathered, the sum reduce-scattered back."""
    z, xr, bmat, cmat, dt, a_neg, norm_w, tails, heads, inner = _front(
        params, dims, x_in, conv_tail_x, conv_tail_bc, seq)
    xh = xr.reshape(*xr.shape[:-1], -1, dims.headdim)
    y, h = ssd_chunked(xh, dt, a_neg, bmat, cmat, params["D"], dims.chunk, h0)
    y = y.reshape(*y.shape[:-2], -1).to(x_in.dtype)
    out = tp.region_out(_back(params, y, z, norm_w, heads, inner), inner, seq)
    if return_state:
        return out, (*tails, h)
    return out


def ssm_decode_step(
    params,
    dims: SSMDims,
    x_in: torch.Tensor,  # (B,1,d)
    conv_tail_x: torch.Tensor,
    conv_tail_bc: torch.Tensor,
    h: torch.Tensor,
):
    """Single-token update.  Returns (y (B,1,d), new tails, new h); over a
    model group, the rank's tails and state."""
    z, xr, bmat, cmat, dt, a_neg, norm_w, (new_tail_x, new_tail_bc), heads, inner = _front(
        params, dims, x_in, conv_tail_x, conv_tail_bc)
    dt = dt[:, 0]  # (B,nh)
    b = x_in.shape[0]
    xh = xr[:, 0].reshape(b, -1, dims.headdim).float()
    a_t = torch.exp(dt * a_neg)  # (B,nh)
    upd = torch.einsum("bn,bh,bhp->bhnp", bmat[:, 0].float(), dt, xh)
    h = a_t[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, -1).to(x_in.dtype)
    return tp.leave(_back(params, y, z, norm_w, heads, inner), inner), new_tail_x, new_tail_bc, h
