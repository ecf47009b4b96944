"""RecurrentGemma-style hybrid model: the (RG-LRU, RG-LRU, local-attn) pattern.

Port of ``repro.models.hybrid``.  Layers follow ``cfg.block_pattern``
repeated; the trailing ``L % len(pattern)`` layers take the pattern's prefix
(recurrentgemma-2b: 26 = 8 x (R, R, A) + (R, R)).  The reference stacks the
full groups and scans them; here ``params["groups"]`` is a list of
``{"rglru_0", "rglru_1", "attn_2"}`` layer trees and ``params["tail"]`` a
list of layers, walked by a Python loop.  Each layer is a pre-norm temporal
mixing block and a pre-norm gated MLP, with gemma's conventions ((1 + w)
RMSNorm, sqrt(d) embedding scale, GeGLU).

The cache mirrors the parameters (``{"groups": [...], "tail": [...]}``):
an attention layer keeps the transformer's ring-buffer KV, an RG-LRU layer
``conv (B, 3, D)`` in the compute dtype and ``h (B, D)`` in float32.
Prefill and decode write it IN PLACE.  :func:`train_loss` is the
reference's (CE only); with ``cfg.remat`` each full group runs under a
non-reentrant checkpoint while autograd records (the tail does not, as in
the reference, which checkpoints only its scanned groups).

Over a model group (``tensor_parallel.model_group``) each rank computes on
its shards: attention head-parallel (``transformer.attention_apply``, the
ring in the rank's heads where the group divides ``K_pad``), the GeGLU
column / row parallel over ``d_ff``, the RG-LRU blocks on the rank's
channels (``rglru.py``; the cache's ``conv`` and ``h`` are its ``D / TP``
channels), the embedding, unembedding and cross-entropy vocab-parallel;
``prefill`` / ``decode_step`` gather the logits whole.  Under sequence
parallelism (``tensor_parallel.sequence_group``) the residual stream is the
rank's rows, as in ``transformer.py``; the RG-LRU block enters by the same
all-gather (the scan needs the whole sequence), and its summed output is
cut back to the rank's rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..distributed import tensor_parallel as tp
from .common import Params, cast_for_compute, dense_init
from .layers import gated_mlp, init_gated_mlp
from .rglru import init_rglru_block, recurrent_block_apply, recurrent_block_step
from .transformer import (
    HeadLayout,
    _embed,
    _layout,
    _norm,
    _unembed,
    _whole_vocab,
    attention_apply,
    init_attention,
    init_norm,
    kv_cache,
    lm_loss,
    remat_layer,
)

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill", "train_loss"]


def _pattern_layers(cfg: ArchConfig):
    pat = cfg.block_pattern or ("rglru", "rglru", "attn")
    n_groups = cfg.n_layers // len(pat)
    tail = tuple(pat[: cfg.n_layers % len(pat)])
    return pat, n_groups, tail


def _init_layer(generator: torch.Generator, cfg: ArchConfig, kind: str, layout: HeadLayout,
                dtype) -> dict:
    dev = generator.device
    p: Dict[str, Any] = {}
    p.update(init_norm(cfg, cfg.d_model, dtype, "norm1", dev))
    p.update(init_norm(cfg, cfg.d_model, dtype, "norm2", dev))
    if kind == "attn":
        p["attn"] = init_attention(generator, cfg, layout, dtype)
    else:
        p["rglru"] = init_rglru_block(generator, cfg.d_model, cfg.d_model, 4, dtype)
    p["mlp"] = init_gated_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """Seeded random weights on the generator's device, in the param dtype."""
    dtype = cfg.dtype("param")
    layout = _layout(cfg)
    pat, n_groups, tail = _pattern_layers(cfg)
    dev = generator.device
    params: Dict[str, Any] = {
        "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model), cfg.d_model, dtype),
        "groups": [
            {f"{kind}_{i}": _init_layer(generator, cfg, kind, layout, dtype)
             for i, kind in enumerate(pat)}
            for _ in range(n_groups)
        ],
        "tail": [_init_layer(generator, cfg, kind, layout, dtype) for kind in tail],
    }
    params.update(init_norm(cfg, cfg.d_model, dtype, "final_norm", dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype
        )
    return Params(params)


# -- caches ------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, dev) -> dict:
    if kind == "attn":
        return kv_cache(cfg, batch, max_len, dev)
    d = cfg.d_model // _rnn_group(cfg).size  # the rank's channels
    return {
        "conv": torch.zeros((batch, 3, d), dtype=cfg.dtype("compute"), device=dev),
        "h": torch.zeros((batch, d), dtype=torch.float32, device=dev),
    }


def _rnn_group(cfg: ArchConfig) -> tp.Group:
    """The model group where it splits the RG-LRU's channels (d_rnn = d_model)."""
    return tp.model_group().over(cfg.d_model)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    dev = resolve_device(device)
    pat, n_groups, tail = _pattern_layers(cfg)
    return {
        "groups": [
            {f"{kind}_{i}": _layer_cache(cfg, kind, batch, max_len, dev)
             for i, kind in enumerate(pat)}
            for _ in range(n_groups)
        ],
        "tail": [_layer_cache(cfg, kind, batch, max_len, dev) for kind in tail],
    }


# -- forward -----------------------------------------------------------------


def _apply_layer(
    p,
    cfg: ArchConfig,
    kind: str,
    layout: HeadLayout,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    decode: bool,
    seq: tp.Group = tp.SINGLE,
) -> torch.Tensor:
    """One layer; over a ``seq`` group ``x`` is this rank's rows."""
    h_in = _norm(p, cfg, x, "norm1", seq)
    if kind == "attn":
        h, _ = attention_apply(p["attn"], cfg, layout, h_in, positions, None, cache, cfg.window,
                               seq)
    elif decode:
        h, conv, hid = recurrent_block_step(
            p["rglru"], h_in, cfg.rglru_c, cache["conv"], cache["h"], _rnn_group(cfg)
        )
        cache["conv"].copy_(conv)
        cache["h"].copy_(hid)
    else:
        h0 = None if cache is None else cache["h"]
        tail_in = None if cache is None else cache["conv"]
        h, (conv, hid) = recurrent_block_apply(
            p["rglru"], h_in, cfg.rglru_c, tail_in, h0, return_state=True,
            group=_rnn_group(cfg), seq=seq,
        )
        if cache is not None:
            cache["conv"].copy_(conv)
            cache["h"].copy_(hid)
    x = x + h
    y = gated_mlp(p["mlp"], _norm(p, cfg, x, "norm2", seq), cfg.act,
                  tp.model_group().over(cfg.d_ff), seq)
    return x + y


def forward(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (logits fp32, cache written in place)."""
    pat, n_groups, tail = _pattern_layers(cfg)
    layout = _layout(cfg)
    compute = cfg.dtype("compute")
    b, s = tokens.shape[:2]
    seq = tp.sequence_group(s)
    x = _embed(params, cfg, tokens, seq=seq)
    decode = s == 1 and cache is not None
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).repeat(b, 1)

    def group_fn(x, group_p, group_cache):
        group_p = cast_for_compute(group_p, compute)
        for i, kind in enumerate(pat):
            name = f"{kind}_{i}"
            lc = None if group_cache is None else group_cache[name]
            x = _apply_layer(group_p[name], cfg, kind, layout, x, positions, lc, decode, seq)
        return x

    for g, group_p in enumerate(params["groups"]):
        if cache is None and cfg.remat:
            x = remat_layer(group_fn, x, group_p, None)
        else:
            x = group_fn(x, group_p, None if cache is None else cache["groups"][g])
    for i, kind in enumerate(tail):
        lc = None if cache is None else cache["tail"][i]
        tail_p = cast_for_compute(params["tail"][i], compute)
        x = _apply_layer(tail_p, cfg, kind, layout, x, positions, lc, decode, seq)
    return _unembed(params, cfg, x, seq), cache


def train_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """batch: tokens, labels, loss_mask -> (loss, {"loss"})."""
    logits, _ = forward(params, cfg, batch["tokens"])
    loss = lm_loss(cfg, logits, batch)
    return loss, {"loss": loss}


def prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], max_len: int):
    """Run the prompt through a fresh cache -> (last logits, cache, next position)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    logits, cache = forward(params, cfg, tokens, cache=cache)
    return _whole_vocab(cfg, logits[:, -1]), cache, tokens.shape[1]


def decode_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor, t: int):
    """One token per sequence at position ``t`` -> (logits, cache, t + 1)."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), t, dtype=torch.int32, device=tokens.device)
    logits, cache = forward(params, cfg, tokens, positions=positions, cache=cache)
    return _whole_vocab(cfg, logits[:, -1]), cache, t + 1
