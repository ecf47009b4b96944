"""Architecture + run configuration (port of ``repro.configs.base``).

One frozen dataclass covers all 10 assigned families; per-arch modules under
``repro_torch.configs`` provide ``full_config()`` (the exact published numbers)
and ``smoke_config()`` (same family, tiny dims, CPU-runnable).  The fields are
the reference's, and two more, ``norm_eps`` and ``residual_in_fp32``;
:meth:`ArchConfig.dtype` differs: it returns a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads (gemma overrides: 256)

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window width (recurrentgemma local attn)
    attn_logit_softcap: Optional[float] = None

    # block details
    norm_type: str = "rms"  # rms | layer
    norm_plus_one: bool = False  # gemma (1+w) convention
    act: str = "silu"  # silu | gelu (gated) -- or plain mlp when gated_mlp=False
    gated_mlp: bool = True
    mlp_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    # epsilon of every RMSNorm: the blocks', the final one and mamba2's gated
    # norm (layer norm keeps its own 1e-5); the reference has no such field
    # and runs every RMSNorm at 1e-6
    norm_eps: float = 1e-6
    # mamba2: the residual stream (the embedding and every block's sum) in
    # float32 whatever the compute dtype, each norm reading it in float32 and
    # giving the compute dtype; the reference has no such field and keeps the
    # residual in the compute dtype
    residual_in_fp32: bool = False

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (recurrentgemma): block pattern, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ()
    rglru_c: float = 8.0  # RG-LRU gate exponent constant

    # VLM
    mrope_sections: Tuple[int, ...] = ()  # (t,h,w) freq slots, sum = head_dim//2

    # encoder
    is_causal: bool = True  # False for encoder-only (hubert)

    # numerics / layout
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # 'full' = recompute everything (cheapest memory, but the backward RERUNS
    # the TP psums); 'block_outs' = save the attn/ffn psum outputs so the
    # recompute pass skips the collectives (EXPERIMENTS §Perf cell A)
    remat_policy: str = "full"
    scan_layers: bool = True
    attn_block_k: int = 1024
    # sharding-time padding (applied by the launcher for TP meshes; 0 = off)
    pad_heads_to: int = 0
    pad_vocab_to_multiple: int = 0
    # causal-attention blockwise skip (hillclimb lever; see EXPERIMENTS §Perf)
    causal_block_skip: bool = False
    # ---- beyond-paper perf levers (EXPERIMENTS.md §Perf) ----
    # Megatron-style sequence parallelism: residual stream seq-shards over
    # the TP axis (cuts saved-activation memory TP-fold -> fewer microbatches)
    sequence_parallel: bool = False
    # decode KV cache lives in the layer-scan carry (in-place ring-buffer
    # updates alias; avoids the xs/ys double-buffer).  A no-op in the port by
    # design: its cache is written in place always (models/transformer.py)
    cache_in_carry: bool = False
    # decode KV cache stores TRUE kv heads sharded over the TP axis by
    # SEQUENCE (shard_map partial-softmax combine) instead of repeated heads:
    # -R x footprint and read traffic for kv < TP archs (full-attention only)
    decode_kv_seq_sharded: bool = False

    # paper-technique integration defaults (replication plan for the data axis)
    replication: int = 1  # r: replicas per data shard (B = dp_size / r)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # -- derived ------------------------------------------------------------

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_heads(self) -> int:
        if self.pad_heads_to and self.n_heads % self.pad_heads_to:
            return ((self.n_heads + self.pad_heads_to - 1) // self.pad_heads_to) * self.pad_heads_to
        return self.n_heads

    @property
    def padded_kv_heads(self) -> int:
        """KV heads after TP-repetition (kv < axis -> repeat to axis)."""
        if self.pad_heads_to and self.n_kv_heads < self.pad_heads_to:
            return self.pad_heads_to
        if self.pad_heads_to and self.n_kv_heads % self.pad_heads_to:
            return (
                (self.n_kv_heads + self.pad_heads_to - 1) // self.pad_heads_to
            ) * self.pad_heads_to
        return self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m and self.vocab_size % m:
            return ((self.vocab_size + m - 1) // m) * m
        return self.vocab_size

    def dtype(self, which: str) -> torch.dtype:
        name = {"param": self.param_dtype, "compute": self.compute_dtype}[which]
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{which} dtype {name!r} is not a torch dtype")
        return dt

    # -- model-FLOPs accounting for the roofline (6ND rule) ------------------

    def param_count_estimate(self) -> int:
        """Analytic total parameter count (pre-padding)."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        hd = self.head_dim
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_headdim
            conv_dim = d_in + 2 * self.ssm_state
            per = (
                d * (2 * d_in + 2 * self.ssm_state + nh)  # in_proj
                + conv_dim * self.ssm_conv
                + 2 * nh  # A, D
                + d_in  # norm
                + d_in * d
            )
            return v * d + L * per + d
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.gated_mlp:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.is_moe:
            ffn = self.n_experts * ffn + d * self.n_experts
        per = att + ffn + 2 * d
        rglru = 0
        if self.family == "hybrid":
            # replace attention with RG-LRU recurrent block on pattern layers
            pass  # estimate handled roughly; exact count comes from init
        total = v * d + L * per + d
        if not self.tie_embeddings:
            total += d * v
        return total + rglru

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count_estimate()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        ffn_one = 3 * d * self.d_ff
        per = att + self.n_experts_per_tok * ffn_one + d * self.n_experts + 2 * d
        total = self.vocab_size * d + L * per + d
        if not self.tie_embeddings:
            total += d * self.vocab_size
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
