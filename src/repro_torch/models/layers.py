"""Core layers: norms, RoPE / M-RoPE, GQA flash attention, gated MLPs.

Port of ``repro.models.layers``.  The reference computes ``rms_norm`` and
``flash_attention`` in jnp as the contract its Pallas kernels implement;
here both go to the hand-written kernels' wrappers
(:mod:`repro_torch.kernels.rmsnorm`, :mod:`repro_torch.kernels.flash_attention`),
which launch the CUDA kernel on a CUDA tensor and run the plain version on
the CPU.  Each goes through its kernel's ``torch.autograd.Function``: the
wrapper's forward, one launch, and a closed-form backward in plain torch
that autograd runs when it records.  Everything else is plain torch: the projections and
MLPs are ``x @ W`` with ``W`` in the reference's ``(d_in, d_out)`` layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..kernels import flash_attention as _flash
from ..kernels.rmsnorm import RMSNormFunction
from .common import dense_init

__all__ = [
    "NEG_INF",
    "apply_mrope",
    "apply_rope",
    "attention_reference",
    "flash_attention",
    "gated_mlp",
    "init_gated_mlp",
    "init_mlp",
    "layer_norm",
    "mlp",
    "rms_norm",
]

NEG_INF = _flash.NEG_INF

# the naive O(S^2)-memory oracle is the attention kernel's plain version
attention_reference = _flash.attention_ref


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, plus_one: bool = False):
    """RMSNorm over the last axis: the fused kernel (its plain version on the CPU)."""
    return RMSNormFunction.apply(x.contiguous(), weight.contiguous(), eps, plus_one)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def _rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / theta**exps


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)[..., None, :]  # (B,S,1,hd)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Llama-style rotary embedding.  x: (B,S,H,hd); positions: (B,S) int."""
    inv = _rope_inv_freq(x.shape[-1], theta, x.device)  # (hd/2,)
    return _rotate(x, positions[..., None].float() * inv)  # angles (B,S,hd/2)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    sections: Sequence[int],
    theta: float = 10000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions: (B,S,3) = (temporal,h,w) ids.

    The hd/2 frequency slots are partitioned into `sections` (t,h,w); each
    slot rotates by its own position stream.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {hd // 2}")
    inv = _rope_inv_freq(hd, theta, x.device)
    sec_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.as_tensor(list(sections), device=x.device),
        output_size=hd // 2,  # known: no device-to-host read of the repeats
    )  # (hd/2,) in {0,1,2}
    pos_sel = positions.float()[..., sec_ids]  # (B,S,hd/2): position stream per freq slot
    return _rotate(x, pos_sel * inv)


# --------------------------------------------------------------------------
# attention (GQA grouped, causal/window masks, -1 = unwritten cache slot)
# --------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with float32 running max/sum: the hand-written kernel.

    Shapes: q (B,Sq,H,hd), k/v (B,Sk,K,hd) with H % K == 0 (GQA grouped --
    KV is never materialized repeated); int32 positions.  ``kv_positions < 0``
    marks invalid (unwritten cache) slots.  Works for prefill and
    single-token decode (Sq == 1, Sk == cache length).  The reference's
    ``block_k`` has no counterpart: the kernel's KV tile is fixed.
    """
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            q_positions.contiguous(), kv_positions.contiguous())
    return _flash.AttentionFunction.apply(*args, causal, window, scale)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_gated_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), d_model, dtype),
        "w_up": dense_init(generator, (d_model, d_ff), d_model, dtype),
        "w_down": dense_init(generator, (d_ff, d_model), d_ff, dtype),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gated_mlp(params, x: torch.Tensor, act: str = "silu", group: tp.Group = tp.SINGLE,
              seq: tp.Group = tp.SINGLE):
    """SwiGLU (silu) / GeGLU (gelu) feed-forward.  Over a ``group`` of more
    than one rank, ``w_gate`` / ``w_up`` are this rank's column shards and
    ``w_down`` its row shard: the rank's partial product is summed.  Over a
    ``seq`` group (sequence parallelism) ``x`` and the output are this rank's
    rows (``tensor_parallel.region_in`` / ``region_out``)."""
    fn = F.silu if act == "silu" else _gelu_tanh
    x = tp.region_in(x, group, seq)
    return tp.region_out((fn(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"],
                         group, seq)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype, bias: bool = True):
    p = {
        "w_in": dense_init(generator, (d_model, d_ff), d_model, dtype),
        "w_out": dense_init(generator, (d_ff, d_model), d_ff, dtype),
    }
    if bias:
        dev = generator.device
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=dev)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=dev)
    return p


def mlp(params, x: torch.Tensor, act: str = "gelu", group: tp.Group = tp.SINGLE,
        seq: tp.Group = tp.SINGLE):
    """Over a ``group`` of more than one rank, ``w_in`` / ``b_in`` are this
    rank's column shards and ``w_out`` its row shard; ``b_out`` (whole) is
    added once, after the sum (on the rank's rows under a ``seq`` group)."""
    fn = _gelu_tanh if act == "gelu" else F.relu
    x = tp.region_in(x, group, seq)
    h = x @ params["w_in"]
    if "b_in" in params:
        h = h + params["b_in"]
    y = tp.region_out(fn(h) @ params["w_out"], group, seq)
    if "b_out" in params:  # on the rank's rows under a seq group: its gradient is partial
        y = y + tp.enter(params["b_out"], seq)
    return y

