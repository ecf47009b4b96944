"""Decoder / encoder / MoE / VLM transformer: init, forward, KV cache, prefill, decode.

Port of ``repro.models.transformer``.  The reference runs
its layers under ``lax.scan`` over stacked weights; here ``params["layers"]``
is an ``nn.ModuleList`` and a Python loop walks it.  Weights keep the
reference's names and ``(d_in, d_out)`` layout and apply as ``x @ W``.
Every norm goes to the RMSNorm kernel and every attention to the
flash-attention kernel (their plain versions on the CPU); the projections,
MLPs and unembedding stay ``torch.matmul``, as the reference leaves them to
XLA.

The KV cache is one ``{"k", "v": (B, W, K_pad, hd), "pos": (W,)}`` dict per
layer.  Prefill and decode write it IN PLACE (``index_copy_`` into the ring
buffer at ``pos % W``), where the reference returns updated copies; the
functions still return the cache, so callers read as the reference's do.

A prefill (S > 1 tokens on a fresh cache) attends over the prompt's own k/v
at their positions and writes the ring as before.  This repairs a fault of
the reference's ``attention_apply``: it attends every prompt query over the
ring alone, so with a window shorter than the prompt a query older than the
ring's W positions sees no key and averages V uniformly (``ROADMAP.md`` §3).
Where S <= W the two agree; decode is unchanged.

Tensor-parallel head layout (``HeadLayout``): with ``pad_heads_to = 0``, as
on one card, it degenerates to plain GQA (``repeat = 1``, no head mask);
with ``pad_heads_to > 0`` KV heads repeat and padded query slots are masked,
so the math is the unpadded model's.

Tensor parallelism over the ``"model"`` axis (the group
``tensor_parallel.model_group()`` of the step's ``logical_axes`` context;
none outside a mesh step): each rank holds the shards the reference's rules
give it and computes as XLA's partitioner splits the reference.  Attention
is head-parallel (:func:`_attention_heads`), the MLPs column / row parallel
with one sum, the MoE experts expert-parallel (``moe.py``), the embedding
and unembedding vocab-parallel on ``embed``'s rows (``lm_head``'s columns):
``forward`` returns this rank's logit columns, ``train_loss`` takes the
vocab-parallel cross-entropy, and ``prefill`` / ``decode_step`` gather the
logits whole.  A dim the axis does not divide is whole on every rank and
computed whole, as the rules leave it.

The sequence-sharded true-KV cache (``decode_kv_seq_sharded``, no window):
``{"ks", "vs": (B, W, K_true, hd), "poss": (W,)}`` per layer, no head
repetition.  A prefill writes the ring and attends over the activations; a
decode step is :func:`_seq_sharded_decode`.  Under a mesh
(``runtime/serve.py``) the ring is a DTensor sharded on its sequence over
the ``"model"`` axis, and each model rank attends over its chunk; the ranks
combine their partial softmax statistics with all-reduces.

Sequence parallelism (``cfg.sequence_parallel`` under a mesh step, where
the model group divides the sequence: ``tensor_parallel.sequence_group``):
the residual stream between the regions is each rank's ``S / TP`` rows.
The embedding leaves onto them (its sum reduce-scattered), each region
(attention, the MLPs, the MoE, the unembedding) enters by an all-gather of
the rows and the rank-local ones leave by a reduce-scatter, and the norms
and residual adds run on the rank's rows; values are the plain TP path's.
Decode (one row) and a sequence the group does not divide run plain TP.

Training: :func:`train_loss` is the reference's (CE plus the MoE router's
aux loss).  With ``cfg.remat`` and autograd recording, each block runs
under ``torch.utils.checkpoint`` (non-reentrant), its weights cast for
compute inside it, so its backward recomputes it.  ``cfg.remat_policy``
is the reference's: ``"full"`` recomputes the whole block, the two sums
over the model group included; ``"block_outs"`` keeps the block's two
post-sum outputs (attention and MLP / MoE, the reference's ``"block_out"``
names) from the forward, and the recompute uses them and runs no sum over
the model group (``tensor_parallel.saving_sums``).  The values, and so the
gradients, are the same bitwise.  The recompute still forms the two partial
products those sums took (their inputs are saved tensors of the backward),
which the reference's compiler drops.  The batch group's MoE statistics and
sequence parallelism's all-gathers into a region run again in either case.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..distributed import axes
from ..distributed import tensor_parallel as tp
from .common import Params, cast_for_compute, cross_entropy_loss, dense_init
from .layers import (
    apply_mrope,
    apply_rope,
    flash_attention,
    gated_mlp,
    init_gated_mlp,
    init_mlp,
    layer_norm,
    mlp,
    rms_norm,
)
from .moe import init_moe, moe_ffn

Cache = List[Dict[str, torch.Tensor]]


# --------------------------------------------------------------------------
# head layout for TP sharding
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    n_heads: int  # true H
    n_kv: int  # true K
    repeat: int  # R: kv repetition factor
    g_pad: int  # query slots per repeated kv head
    h_pad: int  # K_pad * g_pad total query slots

    @property
    def k_pad(self) -> int:
        return self.n_kv * self.repeat

    @staticmethod
    def make(n_heads: int, n_kv: int, pad_to: int = 0) -> "HeadLayout":
        g = n_heads // n_kv
        if pad_to <= 0:
            return HeadLayout(n_heads, n_kv, 1, g, n_heads)
        # repeat kv so K_pad = lcm(K, pad_to) is shardable over the TP axis
        r = math.lcm(n_kv, pad_to) // n_kv
        k_pad = n_kv * r
        g_pad = math.ceil(g / r)
        # ensure total query slots divisible by pad_to
        while (k_pad * g_pad) % pad_to:
            g_pad += 1
        return HeadLayout(n_heads, n_kv, r, g_pad, k_pad * g_pad)

    def head_mask(self, device=None) -> torch.Tensor:
        """(H_pad,) float mask: 1 for real query slots, 0 for padding.

        Slot h = (t*R + c) * G_pad + g is real iff c*G_pad + g < G (true group
        size) -- q heads of true kv t are packed across its R copies.
        """
        g_true = self.n_heads // self.n_kv
        idx = torch.arange(self.h_pad, device=device)
        kc = idx // self.g_pad  # repeated-kv index
        g = idx % self.g_pad
        c = kc % self.repeat
        return (c * self.g_pad + g < g_true).float()


def repeat_kv(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B,S,K,hd) -> (B,S,K*r,hd) with contiguous copies per true head."""
    if r == 1:
        return x
    return torch.repeat_interleave(x, r, dim=2)


def _layout(cfg: ArchConfig) -> HeadLayout:
    return HeadLayout.make(cfg.n_heads, cfg.n_kv_heads, cfg.pad_heads_to)


# --------------------------------------------------------------------------
# attention layer
# --------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ArchConfig, layout: HeadLayout, dtype):
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, layout.h_pad * hd), d, dtype),
        "wk": dense_init(generator, (d, layout.n_kv * hd), d, dtype),
        "wv": dense_init(generator, (d, layout.n_kv * hd), d, dtype),
        "wo": dense_init(generator, (layout.h_pad * hd, d), layout.n_heads * hd, dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((layout.h_pad * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((layout.n_kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((layout.n_kv * hd,), dtype=dtype, device=dev)
    return p


def attention_apply(
    p,
    cfg: ArchConfig,
    layout: HeadLayout,
    x: torch.Tensor,  # (B,S,d)
    positions: torch.Tensor,  # (B,S) int32
    mrope_positions: Optional[torch.Tensor] = None,  # (B,S,3) for vlm
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v": (B,W,K_pad,hd), "pos": (W,)}
    window: Optional[int] = None,
    seq: tp.Group = tp.SINGLE,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer.  With a cache, S > 1 tokens are a prefill on a
    fresh cache: they attend over their own k/v only, so a warm cache must be
    continued one token a call (decode), which attends over the ring.

    Over a model group (``tensor_parallel.model_group``) that divides the
    query slots, each rank attends on its own slots (:func:`_attention_heads`).
    Where the group divides ``wq``'s columns but not the slots, or the ring is
    the sequence-sharded one, ``q`` is gathered whole, the attention runs
    whole on every rank, and each rank multiplies its columns of ``o`` by its
    row shard of ``wo``.  Over a ``seq`` group (sequence parallelism) ``x``
    and the output are this rank's rows; ``positions`` are whole."""
    grp = tp.model_group().over(layout.h_pad * cfg.head_dim)
    seq_ring = cache is not None and "ks" in cache
    if not seq_ring and grp.over(layout.h_pad).size > 1:
        return _attention_heads(p, cfg, layout, grp, x, positions, mrope_positions, cache,
                                window, seq)
    x = tp.gather(x, seq, 1)  # every product below reads the whole rows
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = tp.enter(x, grp) @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = tp.gather(q, grp, -1).reshape(b, s, layout.h_pad, hd)
    k = k.reshape(b, s, layout.n_kv, hd)
    v = v.reshape(b, s, layout.n_kv, hd)
    q, k = _rotary(cfg, q, k, positions, mrope_positions)
    if seq_ring:
        # sequence-sharded TRUE-KV cache mode (no xR head repetition)
        if s == 1:  # decode: partial-softmax combine over the ring's chunks
            o = _seq_sharded_decode(cfg, layout, q, k, v, cache, positions[0, 0])
        else:
            # prefill on a fresh (plain) cache: write the true-KV ring; attend
            # over the activations (the empty-cache contents are exactly k/v)
            w = cache["ks"].shape[1]
            keep = min(s, w)
            pos_tail = positions[0, s - keep :]
            slots = (pos_tail % w).long()
            cache["ks"].index_copy_(1, slots, k[:, s - keep :])
            cache["vs"].index_copy_(1, slots, v[:, s - keep :])
            cache["poss"].index_copy_(0, slots, pos_tail.int())
            o = flash_attention(q, k, v, positions, positions, causal=cfg.is_causal,
                                window=window)
        if layout.h_pad != layout.n_heads:
            o = o * layout.head_mask(o.device)[None, None, :, None].to(o.dtype)
        return _out(p, o.reshape(b, s, layout.h_pad * hd), grp, seq), cache

    k = repeat_kv(k, layout.repeat)
    v = repeat_kv(v, layout.repeat)
    new_cache, k_att, v_att, kv_pos = _ring(cache, k, v, k, v, positions)
    o = flash_attention(q, k_att, v_att, positions, kv_pos, causal=cfg.is_causal, window=window)
    if layout.h_pad != layout.n_heads:
        o = o * layout.head_mask(o.device)[None, None, :, None].to(o.dtype)
    return _out(p, o.reshape(b, s, layout.h_pad * hd), grp, seq), new_cache


def _rotary(cfg: ArchConfig, q, k, positions, mrope_positions):
    if mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def _out(p, o: torch.Tensor, grp: tp.Group, seq: tp.Group = tp.SINGLE) -> torch.Tensor:
    """``o @ wo``; over a group, this rank's columns of a whole ``o`` by its
    row shard of ``wo``, summed (onto the rank's rows over a ``seq`` group)."""
    return tp.region_out(tp.scatter(o, grp, -1) @ p["wo"], grp, seq)


def _ring(cache, k_write, v_write, k, v, positions):
    """Write the ring (if any) and pick what the queries attend over:
    ``(cache, k, v, kv_positions)``.  No cache, or a prefill on a fresh one:
    the prompt's own ``k`` / ``v``; a decode step: the ring."""
    if cache is None:
        return None, k, v, positions
    # ring-buffer write of the last W positions (decode: the one new token at
    # t % W), IN PLACE into the caller's cache tensors
    b, s = positions.shape
    w = cache["k"].shape[1]
    keep = min(s, w)
    pos_tail = positions[0, s - keep :]
    slots = (pos_tail % w).long()
    cache["k"].index_copy_(1, slots, k_write[:, s - keep :])
    cache["v"].index_copy_(1, slots, v_write[:, s - keep :])
    cache["pos"].index_copy_(0, slots, pos_tail.int())
    if s == 1:  # decode: attend over the ring
        return cache, cache["k"], cache["v"], cache["pos"][None, :].expand(b, w)
    return cache, k, v, positions


def _attention_heads(p, cfg: ArchConfig, layout: HeadLayout, grp: tp.Group, x, positions,
                     mrope_positions, cache, window, seq: tp.Group = tp.SINGLE):
    """Head-parallel attention: this rank's ``H_pad / TP`` query slots (its
    ``wq`` / ``bq`` columns) over the repeated KV heads they map to, then its
    row shard of ``wo`` and a sum over the group.

    ``k`` / ``v`` come from the replicated ``wk`` / ``wv``: only the true
    heads the rank's slots read, or all of them where its ring is whole (the
    axis does not divide ``K_pad``; every rank then writes every head, so the
    replicas agree).  A sharded ring holds the rank's ``K_pad / TP`` repeated
    heads.  Where the slots do not split evenly over their KV heads, each
    slot gets its own copy of its head (a group size of one)."""
    xi = tp.region_in(x, grp, seq)
    b, s, _ = xi.shape
    hd, r, g_pad = cfg.head_dim, layout.repeat, layout.g_pad
    hl = layout.h_pad // grp.size
    s0 = grp.rank * hl
    kc0, kc1 = s0 // g_pad, (s0 + hl - 1) // g_pad + 1  # the slots' repeated KV heads
    ring_whole = cache is not None and cache["k"].shape[2] == layout.k_pad
    t0, t1 = (0, layout.n_kv) if ring_whole else (kc0 // r, (kc1 - 1) // r + 1)
    cols = slice(t0 * hd, t1 * hd)
    q = xi @ p["wq"]
    k = xi @ tp.enter(p["wk"], grp)[:, cols]
    v = xi @ tp.enter(p["wv"], grp)[:, cols]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + tp.enter(p["bk"], grp)[cols]
        v = v + tp.enter(p["bv"], grp)[cols]
    q = q.reshape(b, s, hl, hd)
    q, k = _rotary(cfg, q, k.reshape(b, s, t1 - t0, hd), positions, mrope_positions)
    k = repeat_kv(k, r)
    v = repeat_kv(v.reshape(b, s, t1 - t0, hd), r)
    mine = slice(kc0 - t0 * r, kc1 - t0 * r)  # the rank's repeated heads within k / v
    k_loc, v_loc = k[:, :, mine], v[:, :, mine]
    if ring_whole:
        new_cache, k_att, v_att, kv_pos = _ring(cache, k, v, k_loc, v_loc, positions)
        if s == 1:
            k_att, v_att = k_att[:, :, kc0:kc1], v_att[:, :, kc0:kc1]
    else:
        new_cache, k_att, v_att, kv_pos = _ring(cache, k_loc, v_loc, k_loc, v_loc, positions)
    if kc1 - kc0 > 1 and (s0 % g_pad or hl % g_pad):
        idx = torch.arange(s0, s0 + hl, device=x.device) // g_pad - kc0
        k_att, v_att = k_att.index_select(2, idx), v_att.index_select(2, idx)
    o = flash_attention(q, k_att, v_att, positions, kv_pos, causal=cfg.is_causal, window=window)
    if layout.h_pad != layout.n_heads:
        o = o * layout.head_mask(o.device)[s0:s0 + hl][None, None, :, None].to(o.dtype)
    return tp.region_out(o.reshape(b, s, hl * hd) @ p["wo"], grp, seq), new_cache


# --------------------------------------------------------------------------
# sequence-sharded KV decode (partial-softmax combine)
# --------------------------------------------------------------------------


def _attend(qg, ck, cv, pos, t, scale):
    """Partial flash statistics of one chunk, in float32.  Returns (m, l, acc)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), ck.float()) * scale  # (B,K,G',1,wl)
    valid = (pos >= 0) & (pos <= t)
    s = torch.where(valid[None, None, None, None, :], s,
                    torch.finfo(torch.float32).min / 2)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, cv.float())
    return m, lsum, acc


def _write(ck, cv, pos, kn, vn, t, slot_local, active):
    """Write the new token at ``slot_local`` where ``active`` (a 0-d bool
    tensor), IN PLACE; the slot keeps its contents elsewhere."""
    idx = slot_local.long().reshape(1)
    ck.index_copy_(1, idx, torch.where(active, kn, ck.index_select(1, idx)))
    cv.index_copy_(1, idx, torch.where(active, vn, cv.index_select(1, idx)))
    pos.index_copy_(0, idx, torch.where(active, t.int().reshape(1), pos.index_select(0, idx)))


def _seq_sharded_decode(cfg: ArchConfig, layout: HeadLayout, q, k_new, v_new, cache, t):
    """Decode attention over a sequence-sharded true-KV cache -> (B,1,H_pad,hd).

    q: (B,1,H_pad,hd); k_new / v_new: (B,1,K_true,hd); cache: {"ks","vs":
    (B,W,K_true,hd), "poss": (W,)}, plain tensors or DTensors; t: the 0-d
    position.  Each model rank holds a W/TP chunk of the ring (TRUE kv heads --
    no xR repetition), writes the new token if its slot lands locally,
    computes the partial flash statistics over its chunk, and the ranks
    combine with a max/sum reduction over the model group
    (``tensor_parallel.model_group``): o = sum(acc*exp(m-M)) / sum(l*exp(m-M)).
    With no model group, or a ring that is whole on the rank (a model axis
    that does not divide W), the whole ring is local (the reference's
    single-device branch); so it is under a model axis of size 1, where the
    combine is the identity (M = m, exp(0) = 1) and this branch gives the same
    values with no collective.  The cache is written in place.
    """
    grp = tp.model_group()
    b, _, h_pad, hd = q.shape
    gp = layout.repeat * layout.g_pad  # query slots per TRUE kv head
    scale = 1.0 / math.sqrt(hd)
    w_total = cache["ks"].shape[1]  # a DTensor's shape is the global one
    ck, cv, pos = (x.to_local() if isinstance(x, DTensor) else x
                   for x in (cache["ks"], cache["vs"], cache["poss"]))
    qg = q.reshape(b, 1, layout.n_kv, gp, hd)
    slot = t % w_total
    wl = ck.shape[1]
    if grp.size == 1 or wl == w_total:
        # single-device / unsharded: same math, whole buffer local
        _write(ck, cv, pos, k_new, v_new, t, slot, torch.ones((), dtype=torch.bool,
                                                               device=q.device))
        m, lsum, acc = _attend(qg, ck, cv, pos, t, scale)
        o = acc / torch.clamp(lsum[..., None], min=1e-30)
        return o.reshape(b, 1, h_pad, hd).to(q.dtype)

    lo = grp.rank * wl
    active = (slot >= lo) & (slot < lo + wl)
    _write(ck, cv, pos, k_new, v_new, t, torch.clamp(slot - lo, 0, wl - 1), active)
    m, lsum, acc = _attend(qg, ck, cv, pos, t, scale)
    # flash combine across seq shards
    m_g = grp.all_reduce_max(m)
    alpha = torch.exp(m - m_g)
    l_g = grp.all_reduce_sum(lsum * alpha)
    acc_g = grp.all_reduce_sum(acc * alpha[..., None])
    o = acc_g / torch.clamp(l_g[..., None], min=1e-30)
    return o.reshape(b, 1, h_pad, hd).to(q.dtype)


# --------------------------------------------------------------------------
# transformer block (attention + FFN/MoE) for dense / moe / vlm / encoder
# --------------------------------------------------------------------------


def _norm(p, cfg: ArchConfig, x, name: str, seq: tp.Group = tp.SINGLE):
    """The block's norm ``name`` of ``x``; over a ``seq`` group ``x`` is this
    rank's rows, so the weights' gradient is partial (entered: summed)."""
    if cfg.norm_type == "rms":
        return rms_norm(x, tp.enter(p[name], seq), plus_one=cfg.norm_plus_one)
    return layer_norm(x, tp.enter(p[name + "_w"], seq), tp.enter(p[name + "_b"], seq))


def init_norm(cfg: ArchConfig, d: int, dtype, name: str, device) -> dict:
    if cfg.norm_type == "rms":
        init = torch.zeros if cfg.norm_plus_one else torch.ones
        return {name: init((d,), dtype=dtype, device=device)}
    return {
        name + "_w": torch.ones((d,), dtype=dtype, device=device),
        name + "_b": torch.zeros((d,), dtype=dtype, device=device),
    }


def init_block(generator: torch.Generator, cfg: ArchConfig, layout: HeadLayout, dtype) -> dict:
    dev = generator.device
    p: Dict[str, Any] = {"attn": init_attention(generator, cfg, layout, dtype)}
    p.update(init_norm(cfg, cfg.d_model, dtype, "norm1", dev))
    p.update(init_norm(cfg, cfg.d_model, dtype, "norm2", dev))
    if cfg.is_moe:
        p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype)
    elif cfg.gated_mlp:
        p["mlp"] = init_gated_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, bias=cfg.mlp_bias)
    return p


def block_apply(
    p,
    cfg: ArchConfig,
    layout: HeadLayout,
    x: torch.Tensor,
    positions: torch.Tensor,
    mrope_positions=None,
    cache=None,
    seq: tp.Group = tp.SINGLE,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """One block; over a ``seq`` group ``x`` is this rank's rows."""
    h, new_cache = attention_apply(
        p["attn"], cfg, layout, _norm(p, cfg, x, "norm1", seq), positions, mrope_positions,
        cache, cfg.window, seq,
    )
    x = x + h
    y_in = _norm(p, cfg, x, "norm2", seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ff = tp.model_group().over(cfg.d_ff)  # the rules shard the MLP's d_ff where it divides
    if cfg.is_moe:
        y, aux = moe_ffn(p["moe"], y_in, cfg.n_experts_per_tok, cfg.capacity_factor, cfg.act,
                         seq)
    elif cfg.gated_mlp:
        y = gated_mlp(p["mlp"], y_in, cfg.act, ff, seq)
    else:
        y = mlp(p["mlp"], y_in, cfg.act, ff, seq)
    return x + y, new_cache, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """Seeded random weights on the generator's device, in the param dtype.

    The draws differ from the reference's ``jax.random`` ones; tests carry the
    reference's weights across with :func:`repro_torch.models.convert.params_from_jax`.
    """
    dtype = cfg.dtype("param")
    layout = _layout(cfg)
    dev = generator.device
    params: Dict[str, Any] = {
        "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model), cfg.d_model, dtype),
        "layers": [init_block(generator, cfg, layout, dtype) for _ in range(cfg.n_layers)],
    }
    params.update(init_norm(cfg, cfg.d_model, dtype, "final_norm", dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype
        )
    return Params(params)


def cast_for_serving(params: Params, cfg: ArchConfig) -> Params:
    """The compute-dtype copy that serving keeps, made once.

    The reference casts each layer's weights inside its scan body on every
    call (``cast_for_compute``), and casts the gathered embedding rows and the
    unembedding matrix to the compute dtype on every call; casting once gives
    the same values.  The final norm's weight keeps its storage dtype, as in
    the reference.  The hybrid and Mamba-2 models share it: their per-layer
    lists are ``"groups"`` and ``"tail"``, and ``"layers"``.
    """
    dt = cfg.dtype("compute")
    tree: Dict[str, Any] = {name: params[name] for name in params.keys()}
    for name in ("layers", "groups", "tail"):
        if name in params:
            tree[name] = [cast_for_compute(lp, dt) for lp in params[name]]
    for name in ("embed", "lm_head"):
        if name in params:
            tree[name] = params[name].detach().to(dt)
    return Params(tree)


def _vocab_group(cfg: ArchConfig) -> tp.Group:
    """The model group where it splits the (padded) vocabulary: ``embed``'s
    rows and ``lm_head``'s columns are then this rank's."""
    return tp.model_group().over(cfg.padded_vocab)


def _embed(params, cfg: ArchConfig, tokens=None, embeds=None,
           seq: tp.Group = tp.SINGLE) -> torch.Tensor:
    """The residual stream's input (over a ``seq`` group, this rank's rows)."""
    if embeds is None:
        vg = _vocab_group(cfg)
        if vg.size == 1:
            embeds = tp.scatter(params["embed"][tokens.long()], seq, 1)
        else:  # this rank's rows; an id outside them gives zeros; then the sum
            table = params["embed"]
            ids = tokens.long() - vg.rank * table.shape[0]
            hit = (ids >= 0) & (ids < table.shape[0])
            rows = table[ids.clamp(0, table.shape[0] - 1)]
            embeds = tp.region_out(torch.where(hit[..., None], rows, torch.zeros_like(rows)), vg,
                                   seq)
    else:
        embeds = tp.scatter(embeds, seq, 1)
    x = embeds.to(cfg.dtype("compute"))
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _unembed(params, cfg: ArchConfig, x: torch.Tensor, seq: tp.Group = tp.SINGLE) -> torch.Tensor:
    """Float32 logits of every row: over a vocabulary group, this rank's
    columns (over a ``seq`` group ``x`` is this rank's rows, gathered)."""
    x = tp.region_in(_norm(params, cfg, x, "final_norm", seq), _vocab_group(cfg), seq)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()


def _whole_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits of every column: a vocabulary group's columns all-gathered."""
    return tp.gather(logits, _vocab_group(cfg), -1)


def remat_layer(fn, *args, save_block_outs: bool = False):
    """``fn(*args)``, under a non-reentrant ``torch.utils.checkpoint`` while
    autograd records (the forward holds no state a recompute could miss).
    The recompute runs under the forward's ``logical_axes`` context, on
    whichever thread autograd runs it.  With ``save_block_outs`` the block's
    sums over the model group are kept from the forward and the recompute
    runs none (``remat_policy="block_outs"``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    ctx = axes.current()
    saved = tp.SavedSums() if save_block_outs else None

    def block(*a):
        with axes.entered(ctx), tp.saving_sums(saved):
            return fn(*a)

    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)


def _block_fn(layer_p, cfg: ArchConfig, layout: HeadLayout, x, positions, mrope_positions,
              layer_cache, seq: tp.Group = tp.SINGLE):
    layer_p = cast_for_compute(layer_p, cfg.dtype("compute"))
    x, _, aux = block_apply(layer_p, cfg, layout, x, positions, mrope_positions, layer_cache, seq)
    return x, aux


def forward(
    params,
    cfg: ArchConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits fp32, cache written in place, moe_aux); over a model
    group that splits the vocabulary, the logits are this rank's columns."""
    layout = _layout(cfg)
    b, s = (tokens if embeds is None else embeds).shape[:2]
    seq = tp.sequence_group(s)
    x = _embed(params, cfg, tokens, embeds, seq)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).repeat(b, 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block_outs = cfg.remat_policy == "block_outs"
    for i, layer_p in enumerate(params["layers"]):
        args = (layer_p, cfg, layout, x, positions, mrope_positions,
                None if cache is None else cache[i], seq)
        x, a = remat_layer(_block_fn, *args, save_block_outs=block_outs) \
            if cfg.remat and cache is None else _block_fn(*args)
        aux = aux + a
    logits = _unembed(params, cfg, x, seq)
    return logits, cache, aux


# --------------------------------------------------------------------------
# cache init
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> Cache:
    """One zeroed ring buffer per layer, ``pos`` -1 in every (unwritten) slot.

    With ``decode_kv_seq_sharded`` (and no window) the ring holds the TRUE
    kv heads: ``{"ks", "vs": (B, W, K, hd), "poss": (W,)}``.  Over a model
    group that divides ``K_pad`` a plain ring holds this rank's heads.
    """
    dev = resolve_device(device)
    if cfg.decode_kv_seq_sharded and not cfg.window:
        w, dtype = max_len, cfg.dtype("compute")
        shape = (batch, w, cfg.n_kv_heads, cfg.head_dim)
        return [{"ks": torch.zeros(shape, dtype=dtype, device=dev),
                 "vs": torch.zeros(shape, dtype=dtype, device=dev),
                 "poss": torch.full((w,), -1, dtype=torch.int32, device=dev)}
                for _ in range(cfg.n_layers)]
    return [kv_cache(cfg, batch, max_len, dev) for _ in range(cfg.n_layers)]


def kv_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """One attention layer's zeroed ring buffer (the hybrid's attention layers too)."""
    layout = _layout(cfg)
    w = min(max_len, cfg.window) if cfg.window else max_len
    dtype = cfg.dtype("compute")
    shape = (batch, w, layout.k_pad // tp.model_group().over(layout.k_pad).size, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((w,), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# losses / steps (train, prefill, decode)
# --------------------------------------------------------------------------


def train_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """batch: tokens/embeds, labels, loss_mask [, mrope_positions] -> (total, metrics)."""
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        mrope_positions=batch.get("mrope_positions"),
    )
    loss = lm_loss(cfg, logits, batch)
    total = loss + cfg.router_aux_loss * aux if cfg.is_moe else loss
    return total, {"loss": loss, "moe_aux": aux}


def lm_loss(cfg: ArchConfig, logits: torch.Tensor, batch: Dict[str, torch.Tensor]):
    """The cross-entropy of ``forward``'s logits: vocab-parallel over a model
    group that splits the vocabulary (the logits are then this rank's columns)."""
    vg = _vocab_group(cfg)
    return cross_entropy_loss(
        logits, batch["labels"], batch.get("loss_mask"), real_vocab=cfg.vocab_size,
        group=vg, vocab_offset=vg.rank * logits.shape[-1],
    )


def prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], max_len: int):
    """Run the prompt through a fresh cache -> (last logits, cache, next position)."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    first = tokens if tokens is not None else embeds
    b, s = first.shape[:2]
    cache = init_cache(cfg, b, max_len, device=first.device)
    logits, cache, _ = forward(
        params, cfg, tokens=tokens, embeds=embeds,
        mrope_positions=batch.get("mrope_positions"), cache=cache,
    )
    return _whole_vocab(cfg, logits[:, -1]), cache, s


def decode_step(params, cfg: ArchConfig, cache: Cache, tokens: torch.Tensor, t: int):
    """One token per sequence at position ``t`` -> (logits, cache, t + 1)."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), t, dtype=torch.int32, device=tokens.device)
    mrope = None
    if cfg.family == "vlm":
        mrope = torch.full((b, 1, 3), t, dtype=torch.int32, device=tokens.device)
    logits, cache, _ = forward(
        params, cfg, tokens=tokens, positions=positions, mrope_positions=mrope, cache=cache
    )
    return _whole_vocab(cfg, logits[:, -1]), cache, t + 1
