"""The yardstick: the card's peaks, and the work of each measured unit in closed form.

Nothing here reads the program: every count comes from a configuration's
shapes, so a change to a kernel or to the step never moves it.

Peaks are the data sheet's for one NVIDIA H100 SXM5 80 GB (dense rates, at
its full power limit of 700 W; a run prints the card's own limit beside
them).  The arithmetic of :func:`bound_s` is ``chip_smoke.py::bound_ms``'s.
"""
from __future__ import annotations

import math

# --- peaks of one H100 SXM (NVIDIA's data sheet) ------------------------------
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989.4e12
F32_FLOP_PER_S = 66.9e12
# 32-bit integer / float lane instructions a second: 132 SMs x 128 lanes x 1.98 GHz
LANE_INSTR_PER_S = 132 * 128 * 1.98e9


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time of some work: the larger of its bytes over the memory
    rate and its operations over the peak rate, and which of the two it is."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# --- the planner: kernel B's draws -------------------------------------------
# Lane instructions one replica draw of an Empirical law needs, derived from
# the algorithms and frozen (not counted from any compiled kernel):
#   Philox-4x32-10, per counter: 10 rounds of two 32 x 32 -> 64-bit products
#   (a low and a high half each: 4), two three-input XORs (2) and the two key
#   words' increments (2) = 80; one counter gives four 32-bit words, one a
#   draw: 20 a draw;
#   the Empirical law's lookup: the index as the high half of word * n (1),
#   its address (1) and the load (1) = 3;
#   the size-dependent scale, one multiply (1);
#   the minimum over the batch's replicas, one compare (1).
# The maximum over a candidate's batches is one compare per batch and is
# counted apart (:func:`frontier_ops`).
PHILOX_INSTR_PER_DRAW = 20
EMPIRICAL_LOOKUP_INSTR = 3
SCALE_INSTR = 1
MIN_INSTR = 1
INSTR_PER_DRAW = PHILOX_INSTR_PER_DRAW + EMPIRICAL_LOOKUP_INSTR + SCALE_INSTR + MIN_INSTR


def divisors(n: int) -> list[int]:
    """Every B that splits ``n`` workers into equal batches, ascending."""
    return [b for b in range(1, n + 1) if n % b == 0]


def frontier_ops(n_workers: int, candidates, n_reps: int) -> int:
    """Lane instructions of one frontier pass: every replica of every
    candidate drawn and reduced, then each candidate's batches' maximum."""
    draws = sum((n_workers // b) * b for b in candidates) * n_reps
    maxima = sum(candidates) * n_reps
    return INSTR_PER_DRAW * draws + maxima


def frontier_bytes(n_table: int, n_cand: int, n_reps: int, itemsize: int = 4) -> int:
    """Bytes of one frontier pass: the law's table read once, the
    ``(C, n_reps)`` cover times written once."""
    return (n_table + n_cand * n_reps) * itemsize


def frontier_bound_s(n_workers: int, candidates, n_reps: int, n_table: int) -> tuple[float, str]:
    """The least time of one frontier pass on the card (kernel B's work)."""
    return bound_s(frontier_bytes(n_table, len(candidates), n_reps),
                   frontier_ops(n_workers, candidates, n_reps), LANE_INSTR_PER_S)


# --- the dense transformer (qwen2-1.5b) --------------------------------------

def head_dim(arch: dict) -> int:
    return int(arch.get("head_dim") or arch["d_model"] // arch["n_heads"])


def param_count(arch: dict) -> int:
    """Parameters of a dense GQA transformer with a gated MLP and RMSNorm."""
    d, hd, v, layers = arch["d_model"], head_dim(arch), arch["vocab_size"], arch["n_layers"]
    h, k, ff = arch["n_heads"], arch["n_kv_heads"], arch["d_ff"]
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    if arch.get("qkv_bias"):
        attn += h * hd + 2 * k * hd
    per_layer = attn + 3 * d * ff + 2 * d
    head = 0 if arch.get("tie_embeddings") else d * v
    return v * d + layers * per_layer + d + head


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal sequence of ``seq`` tokens attends over."""
    return seq * (seq + 1) // 2


def train_flops(arch: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, with no recompute counted: 6 per
    parameter and token (forward 2, backward 4), plus causal attention's
    products, 4 * head_dim per visible pair and query head forward and
    twice that backward."""
    tokens = batch * seq
    attn = 12 * head_dim(arch) * arch["n_heads"] * causal_pairs(seq) * batch * arch["n_layers"]
    return 6.0 * param_count(arch) * tokens + attn


def attention_fwd_bound_s(arch: dict, batch: int, seq: int, itemsize: int = 2):
    """The least time of one layer's causal attention forward over the batch:
    q, k, v and the positions read once and o written once; 4 * head_dim
    FLOPs per visible pair and query head at the bf16 rate."""
    hd, h, k = head_dim(arch), arch["n_heads"], arch["n_kv_heads"]
    rows = batch * seq
    n_bytes = 2 * rows * h * hd * itemsize + 2 * rows * k * hd * itemsize + 2 * rows * 4
    n_ops = 4.0 * hd * h * causal_pairs(seq) * batch
    return bound_s(n_bytes, n_ops, BF16_FLOP_PER_S)


def rmsnorm_fwd_bound_s(arch: dict, batch: int, seq: int, itemsize: int = 2):
    """The least time of one RMSNorm forward over the batch's rows: x read
    and the output written once, the weight read once."""
    d, rows = arch["d_model"], batch * seq
    return bound_s(2 * rows * d * itemsize + d * itemsize, 4.0 * rows * d, F32_FLOP_PER_S)


def share_pct(bound: float, measured: float) -> float | None:
    """``bound / measured`` as a percentage, or None where nothing was measured."""
    if not measured or measured <= 0 or not math.isfinite(measured):
        return None
    return 100.0 * bound / measured
