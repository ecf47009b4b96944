"""Mamba-2 language model, an attention-free SSD stack (port of ``repro.models.mamba``).

The reference stacks the layers and scans them; here ``params["layers"]``
is a list walked by a Python loop.  The cache is one ``{"conv_x", "conv_bc",
"h"}`` dict per layer (the conv tails in the compute dtype, the state
``(B, nh, N, hp)`` in float32), written IN PLACE by prefill and decode.
:func:`train_loss` is the reference's (CE only); with ``cfg.remat`` each
layer runs under a non-reentrant checkpoint while autograd records.

Over a model group (``tensor_parallel.model_group``) each rank computes on
its shards (``ssm.py``): its cache holds its ``d_inner / TP`` channels of
``conv_x`` and its ``nh / TP`` heads of ``h`` (the reference's cache rules),
``conv_bc`` whole; the embedding and unembedding are vocab-parallel
(``transformer._embed`` / ``_unembed``), ``train_loss`` takes the
vocab-parallel cross-entropy and ``prefill`` / ``decode_step`` gather the
logits whole.  Under sequence parallelism the residual stream is the rank's
rows (``transformer.py``); the mixer gathers the whole rows (``ssm.py``).
With ``cfg.residual_in_fp32`` the residual stream is float32 (the embedding
and every block's sum, as ``mamba_ssm`` keeps it); each norm reads it in
float32 and gives the compute dtype.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..distributed import tensor_parallel as tp
from .common import Params, cast_for_compute, dense_init
from .ssm import SSMDims, init_ssm_layer, ssm_decode_step, ssm_layer_apply
from .transformer import _embed, _norm, _unembed, _whole_vocab, init_norm, lm_loss, remat_layer

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
    grp = tp.model_group()  # a rank's channels and heads, where the group splits them
    d_inner = dims.d_inner // grp.over(dims.d_inner).size
    n_heads = dims.n_heads // grp.over(dims.n_heads).size
    return [
        {
            "conv_x": torch.zeros((batch, dims.d_conv - 1, d_inner), dtype=cdt, device=dev),
            "conv_bc": torch.zeros((batch, dims.d_conv - 1, 2 * dims.d_state), dtype=cdt,
                                   device=dev),
            "h": torch.zeros((batch, n_heads, dims.d_state, dims.headdim),
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
    seq = tp.sequence_group(tokens.shape[1])
    x = _embed(params, cfg, tokens, seq=seq,
               dtype=torch.float32 if cfg.residual_in_fp32 else None)
    for i, p in enumerate(params["layers"]):
        if cache is None and cfg.remat:
            x = remat_layer(_layer_fn, x, p, cfg, dims, None, False, seq)
        else:
            x = _layer_fn(x, p, cfg, dims, None if cache is None else cache[i], decode, seq)
    return _unembed(params, cfg, x, seq), cache


def _layer_fn(x, p, cfg: ArchConfig, dims: SSMDims, lc=None, decode: bool = False,
              seq: tp.Group = tp.SINGLE):
    """One pre-norm SSD layer; writes a cache ``lc`` in place.  Over a ``seq``
    group ``x`` is this rank's rows."""
    cdt = cfg.dtype("compute")
    p = cast_for_compute(p, cdt)
    h_in = _norm(p, cfg, x, "norm1", seq).to(cdt)
    eps = cfg.norm_eps
    if decode:
        y, cx, cbc, h = ssm_decode_step(
            p["mixer"], dims, h_in, lc["conv_x"], lc["conv_bc"], lc["h"], norm_eps=eps
        )
    elif lc is None:
        y = ssm_layer_apply(p["mixer"], dims, h_in, seq=seq, norm_eps=eps)
    else:
        y, (cx, cbc, h) = ssm_layer_apply(
            p["mixer"], dims, h_in, lc["conv_x"], lc["conv_bc"], lc["h"],
            return_state=True, seq=seq, norm_eps=eps,
        )
    if lc is not None:
        lc["conv_x"].copy_(cx)
        lc["conv_bc"].copy_(cbc)
        lc["h"].copy_(h)
    return x + y  # in x's dtype: float32 with residual_in_fp32


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


def decode_step(params, cfg: ArchConfig, cache: Cache, tokens: torch.Tensor, t: int):
    """One token per sequence -> (logits, cache, t + 1)."""
    logits, cache = forward(params, cfg, tokens, cache=cache, decode=True)
    return _whole_vocab(cfg, logits[:, -1]), cache, t + 1
