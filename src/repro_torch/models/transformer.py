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
on one card, it degenerates to plain GQA (``repeat = 1``, no head mask).
Not ported yet, each raising ``NotImplementedError`` that names its
``ROADMAP.md`` item: the sequence-sharded decode cache
(``decode_kv_seq_sharded``, multi-chip: item 3.7) and ``train_loss`` (the
training path: item 3.6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import Params, cast_for_compute, dense_init
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

_SEQ_SHARDED = ("the sequence-sharded decode cache is multi-chip: it waits for distributed/ "
                "on torch.distributed (ROADMAP.md open items, 3.7)")


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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer.  With a cache, S > 1 tokens are a prefill on a
    fresh cache: they attend over their own k/v only, so a warm cache must be
    continued one token a call (decode), which attends over the ring."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, layout.h_pad, hd)
    k = k.reshape(b, s, layout.n_kv, hd)
    v = v.reshape(b, s, layout.n_kv, hd)
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None and "ks" in cache:
        raise NotImplementedError(_SEQ_SHARDED)

    k = repeat_kv(k, layout.repeat)
    v = repeat_kv(v, layout.repeat)

    # no cache, or a prefill on a fresh one: the prompt's own k/v
    new_cache, k_att, v_att, kv_pos = None, k, v, positions
    if cache is not None:
        # ring-buffer write of the last W positions (decode: the one new
        # token at t % W), IN PLACE into the caller's cache tensors
        w = cache["k"].shape[1]
        keep = min(s, w)
        pos_tail = positions[0, s - keep :]
        slots = (pos_tail % w).long()
        cache["k"].index_copy_(1, slots, k[:, s - keep :])
        cache["v"].index_copy_(1, slots, v[:, s - keep :])
        cache["pos"].index_copy_(0, slots, pos_tail.int())
        new_cache = cache
        if s == 1:  # decode: attend over the ring
            k_att, v_att = cache["k"], cache["v"]
            kv_pos = cache["pos"][None, :].expand(b, w)

    o = flash_attention(q, k_att, v_att, positions, kv_pos, causal=cfg.is_causal, window=window)
    if layout.h_pad != layout.n_heads:
        o = o * layout.head_mask(o.device)[None, None, :, None].to(o.dtype)
    out = o.reshape(b, s, layout.h_pad * hd) @ p["wo"]
    return out, new_cache


# --------------------------------------------------------------------------
# transformer block (attention + FFN/MoE) for dense / moe / vlm / encoder
# --------------------------------------------------------------------------


def _norm(p, cfg: ArchConfig, x, name: str):
    if cfg.norm_type == "rms":
        return rms_norm(x, p[name], plus_one=cfg.norm_plus_one)
    return layer_norm(x, p[name + "_w"], p[name + "_b"])


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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    h, new_cache = attention_apply(
        p["attn"], cfg, layout, _norm(p, cfg, x, "norm1"), positions, mrope_positions,
        cache, cfg.window,
    )
    x = x + h
    y_in = _norm(p, cfg, x, "norm2")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        y, aux = moe_ffn(p["moe"], y_in, cfg.n_experts_per_tok, cfg.capacity_factor, cfg.act)
    elif cfg.gated_mlp:
        y = gated_mlp(p["mlp"], y_in, cfg.act)
    else:
        y = mlp(p["mlp"], y_in, cfg.act)
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


def _embed(params, cfg: ArchConfig, tokens=None, embeds=None) -> torch.Tensor:
    if embeds is None:
        embeds = params["embed"][tokens.long()]
    x = embeds.to(cfg.dtype("compute"))
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _unembed(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(params, cfg, x, "final_norm")
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()


def forward(
    params,
    cfg: ArchConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits fp32, cache written in place, moe_aux)."""
    layout = _layout(cfg)
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).repeat(b, 1)
    compute = cfg.dtype("compute")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer_p in enumerate(params["layers"]):
        layer_p = cast_for_compute(layer_p, compute)
        layer_cache = None if cache is None else cache[i]
        x, _, a = block_apply(layer_p, cfg, layout, x, positions, mrope_positions, layer_cache)
        aux = aux + a
    logits = _unembed(params, cfg, x)
    return logits, cache, aux


# --------------------------------------------------------------------------
# cache init
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> Cache:
    """One zeroed ring buffer per layer, ``pos`` -1 in every (unwritten) slot."""
    if cfg.decode_kv_seq_sharded and not cfg.window:
        raise NotImplementedError(_SEQ_SHARDED)
    dev = resolve_device(device)
    return [kv_cache(cfg, batch, max_len, dev) for _ in range(cfg.n_layers)]


def kv_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """One attention layer's zeroed ring buffer (the hybrid's attention layers too)."""
    layout = _layout(cfg)
    w = min(max_len, cfg.window) if cfg.window else max_len
    dtype = cfg.dtype("compute")
    shape = (batch, w, layout.k_pad, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((w,), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# steps (prefill, decode); training waits for its slice
# --------------------------------------------------------------------------


def train_loss(params, cfg: ArchConfig, batch):
    raise NotImplementedError(
        "train_loss waits for the training path (ROADMAP.md open items, 3.6: "
        "cross_entropy_loss, optim/, data/pipeline.py, runtime/train.py)"
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
    return logits[:, -1], cache, s


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
    return logits[:, -1], cache, t + 1
