"""Mamba-2 language model, an attention-free SSD stack (port of ``repro.models.mamba``).

The reference stacks the layers and scans them; here ``params["layers"]``
is a list walked by a Python loop.  The cache is one ``{"conv_x", "conv_bc",
"h"}`` dict per layer (the conv tails in the compute dtype, the state
``(B, nh, N, hp)`` in float32), written IN PLACE by prefill and decode.
``train_loss`` is the transformer's, which raises: it waits for the training
path (``ROADMAP.md`` open items, 3.6).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from .common import Params, cast_for_compute, dense_init
from .ssm import SSMDims, init_ssm_layer, ssm_decode_step, ssm_layer_apply
from .transformer import _embed, _norm, _unembed, init_norm, train_loss

__all__ = ["decode_step", "forward", "init_cache", "init_params", "prefill", "train_loss"]

Cache = List[Dict[str, torch.Tensor]]


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """Seeded random weights on the generator's device, in the param dtype."""
    dtype = cfg.dtype("param")
    dims = SSMDims.from_config(cfg)
    dev = generator.device
    layers = []
    for _ in range(cfg.n_layers):
        p: Dict[str, Any] = {"mixer": init_ssm_layer(generator, dims, dtype)}
        p.update(init_norm(cfg, cfg.d_model, dtype, "norm1", dev))
        layers.append(p)
    params: Dict[str, Any] = {
        "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model), cfg.d_model, dtype),
        "layers": layers,
    }
    params.update(init_norm(cfg, cfg.d_model, dtype, "final_norm", dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype
        )
    return Params(params)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> Cache:
    del max_len  # the SSM state is O(1) in sequence length
    dev = resolve_device(device)
    dims = SSMDims.from_config(cfg)
    cdt = cfg.dtype("compute")
    return [
        {
            "conv_x": torch.zeros((batch, dims.d_conv - 1, dims.d_inner), dtype=cdt, device=dev),
            "conv_bc": torch.zeros((batch, dims.d_conv - 1, 2 * dims.d_state), dtype=cdt,
                                   device=dev),
            "h": torch.zeros((batch, dims.n_heads, dims.d_state, dims.headdim),
                             dtype=torch.float32, device=dev),
        }
        for _ in range(cfg.n_layers)
    ]


def forward(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    cache: Optional[Cache] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (logits fp32, cache written in place)."""
    dims = SSMDims.from_config(cfg)
    compute = cfg.dtype("compute")
    x = _embed(params, cfg, tokens)
    for i, p in enumerate(params["layers"]):
        p = cast_for_compute(p, compute)
        lc = None if cache is None else cache[i]
        h_in = _norm(p, cfg, x, "norm1")
        if decode:
            y, cx, cbc, h = ssm_decode_step(
                p["mixer"], dims, h_in, lc["conv_x"], lc["conv_bc"], lc["h"]
            )
        elif lc is None:
            y = ssm_layer_apply(p["mixer"], dims, h_in)
        else:
            y, (cx, cbc, h) = ssm_layer_apply(
                p["mixer"], dims, h_in, lc["conv_x"], lc["conv_bc"], lc["h"],
                return_state=True,
            )
        if lc is not None:
            lc["conv_x"].copy_(cx)
            lc["conv_bc"].copy_(cbc)
            lc["h"].copy_(h)
        x = x + y
    return _unembed(params, cfg, x), cache


def prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], max_len: int):
    """Run the prompt through a fresh cache -> (last logits, cache, next position)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    logits, cache = forward(params, cfg, tokens, cache=cache)
    return logits[:, -1], cache, tokens.shape[1]


def decode_step(params, cfg: ArchConfig, cache: Cache, tokens: torch.Tensor, t: int):
    """One token per sequence -> (logits, cache, t + 1)."""
    logits, cache = forward(params, cfg, tokens, cache=cache, decode=True)
    return logits[:, -1], cache, t + 1
