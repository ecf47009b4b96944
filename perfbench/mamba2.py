"""Mamba-2's leaves, initial weights and work, from the configuration's shapes alone.

The layout names every leaf as the port's ``Params.leaves()`` does for the
``ssm`` family (``embed``, ``layers.<i>.norm1``, ``layers.<i>.mixer.w_z``,
..., ``final_norm``), with the ``(d_in, d_out)`` orientation of ``x @ W``
and the in-projection stored in four parts (z, x, B and C, dt) as the port
stores it.  The initial weights are ``mamba_ssm``'s: matrices (the
projections, the depthwise convs' taps, the embedding) normal with standard
deviation ``1 / sqrt(fan_in)`` from :func:`perfbench.weights.normal_pieces`'s
stream, norms and ``D`` one, conv biases zero; ``A_log`` is ``log A`` with
``A ~ U(1, 16)``, and ``dt_bias`` the inverse softplus of ``dt =
exp(U(ln 1e-3, ln 1e-1))`` floored at ``1e-4``, each drawn on the device from
a generator keyed on (seed, leaf name).

:func:`train_flops` and :func:`ssd_bound_s` count the work of a step from
the shapes, whatever implements it.
"""
from __future__ import annotations

import math

from perfbench import traffic, weights, work

# the leaves that are neither normal, ones nor zeros: drawn by _draw
DRAWN = ("A_log", "dt_bias")
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
A_MIN, A_MAX = 1.0, 16.0


def dims(arch: dict) -> dict:
    """The mixer's sizes: ``d_inner``, ``heads``, ``headdim``, ``state``, ``conv``, ``chunk``."""
    d_inner = arch["ssm_expand"] * arch["d_model"]
    return {"d_inner": d_inner, "heads": d_inner // arch["ssm_headdim"],
            "headdim": arch["ssm_headdim"], "state": arch["ssm_state"],
            "conv": arch["ssm_conv"], "chunk": arch["ssm_chunk"]}


def layout(arch: dict) -> list:
    """``(name, shape, kind, std)`` of every leaf; ``kind`` is normal, ones,
    zeros, ``A_log`` or ``dt_bias``."""
    d, v = arch["d_model"], arch["vocab_size"]
    m = dims(arch)
    di, nh, n, k = m["d_inner"], m["heads"], m["state"], m["conv"]

    def mat(name, shape, fan_in):
        return (name, shape, "normal", 1.0 / math.sqrt(fan_in))

    out = [mat("embed", (v, d), d)]
    for i in range(arch["n_layers"]):
        p = f"layers.{i}."
        q = p + "mixer."
        out += [(p + "norm1", (d,), "ones", 0.0),
                mat(q + "w_z", (d, di), d), mat(q + "w_x", (d, di), d),
                mat(q + "w_bc", (d, 2 * n), d), mat(q + "w_dt", (d, nh), d),
                mat(q + "conv_x", (k, di), k), (q + "conv_x_b", (di,), "zeros", 0.0),
                mat(q + "conv_bc", (k, 2 * n), k), (q + "conv_bc_b", (2 * n,), "zeros", 0.0),
                (q + "A_log", (nh,), "A_log", 0.0), (q + "dt_bias", (nh,), "dt_bias", 0.0),
                (q + "D", (nh,), "ones", 0.0), (q + "norm_w", (di,), "ones", 0.0),
                mat(q + "out_proj", (di, d), di)]
    out.append(("final_norm", (d,), "ones", 0.0))
    if not arch.get("tie_embeddings"):
        out.append(("lm_head", (d, v), "normal", 1.0 / math.sqrt(d)))
    return out


def _draw(name: str, shape, kind: str, seed: int, device):
    """The initial value of an ``A_log`` or ``dt_bias`` leaf, float32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(traffic.derive(seed, "ssm", name))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    if kind == "A_log":
        return torch.log(A_MIN + (A_MAX - A_MIN) * u)
    dt = torch.exp(math.log(DT_MIN) + (math.log(DT_MAX) - math.log(DT_MIN)) * u)
    dt = dt.clamp_min(DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) == dt


def _split(lay: list):
    return ([e for e in lay if e[2] not in DRAWN], [e for e in lay if e[2] in DRAWN])


def fill(leaves: dict, lay: list, seed: int) -> None:
    """Write the initial weights into ``leaves`` (name -> tensor), in place."""
    import torch

    plain, drawn = _split(lay)
    weights.fill(leaves, plain, seed)
    with torch.no_grad():
        for name, shape, kind, _ in drawn:
            if tuple(leaves[name].shape) != tuple(shape):
                raise ValueError(f"leaf {name}: shape {tuple(leaves[name].shape)}, layout {shape}")
            leaves[name].copy_(_draw(name, shape, kind, seed, leaves[name].device))


def make(lay: list, seed: int, device) -> dict:
    """The initial weights as new float32 tensors, by name."""
    import torch

    leaves = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape, _, _ in lay}
    fill(leaves, lay, seed)
    return leaves


def change_norms(leaves: dict, lay: list, seed: int) -> dict:
    """``||leaf - initial||`` of every leaf, the initial values made again."""
    import torch

    plain, drawn = _split(lay)
    out = weights.change_norms(leaves, plain, seed)
    with torch.no_grad():
        for name, shape, kind, _ in drawn:
            t = leaves[name]
            out[name] = float((t.float() - _draw(name, shape, kind, seed, t.device)).norm())
    return out


def param_count(arch: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout(arch))


def ssd_flops_per_token(arch: dict) -> float:
    """One layer's SSD products for one token, one pass of the chunked
    algorithm (Q the chunk, N the state, P the head size, H the heads):
    C B^T over the chunk 2 Q N, the masked scores times X 2 Q P H, the
    chunk's state and the output from the carried state 2 N P H each, and
    the state pass between chunks 2 N P H a chunk."""
    m = dims(arch)
    q, n, p, h = m["chunk"], m["state"], m["headdim"], m["heads"]
    return 2.0 * q * n + 2.0 * q * p * h + 4.0 * n * p * h + 2.0 * n * p * h / q


def train_flops(arch: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, with no recompute counted: 6 per
    parameter and token, plus the SSD's products forward (one pass) and
    backward (two)."""
    tokens = batch * seq
    ssd = 3.0 * ssd_flops_per_token(arch) * tokens * arch["n_layers"]
    return 6.0 * param_count(arch) * tokens + ssd


# passes of the scan a training step makes: the forward, its recompute, and
# the backward counted as two
SSD_PASSES = 4


def ssd_bound_s(arch: dict, batch: int, seq: int, itemsize: int = 2) -> tuple[float, str]:
    """The least time of a training step's SSD scans, every layer: each of
    :data:`SSD_PASSES` passes computes :func:`ssd_flops_per_token` a token at
    the bf16 rate, reads x, B and C (``itemsize``) and dt (float32) and
    writes y (``itemsize``) once."""
    m = dims(arch)
    tokens = batch * seq * arch["n_layers"] * SSD_PASSES
    per_token = 2 * m["d_inner"] * itemsize + 2 * m["state"] * itemsize + m["heads"] * 4
    return work.bound_s(tokens * per_token, tokens * ssd_flops_per_token(arch),
                        work.BF16_FLOP_PER_S)
