"""The dense transformer's initial weights, made on the device from the seed.

The layout names every leaf as the port's ``Params.leaves()`` does
(``embed``, ``layers.<i>.attn.wq``, ..., ``final_norm``), with the
``(d_in, d_out)`` orientation of ``x @ W``.  Matrices are normal with
standard deviation ``1 / sqrt(fan_in)``, norms one, biases zero.  The normal
draws of all matrices form one flat stream cut into chunks of
:data:`CHUNK` values, chunk ``j`` drawn by one ``torch.randn`` from a
generator keyed on (seed, j): a few large calls on the device, and any leaf
can be made again chunk by chunk without holding the whole model twice.
"""
from __future__ import annotations

import math

from perfbench import traffic, work

CHUNK = 2**28


def layout(arch: dict) -> list:
    """``(name, shape, kind, std)`` of every leaf; ``kind`` is normal, ones or zeros."""
    d, hd, v = arch["d_model"], work.head_dim(arch), arch["vocab_size"]
    h, k, ff = arch["n_heads"], arch["n_kv_heads"], arch["d_ff"]

    def mat(name, shape):
        return (name, shape, "normal", 1.0 / math.sqrt(shape[0] if name != "embed" else d))

    out = [mat("embed", (v, d))]
    for i in range(arch["n_layers"]):
        p = f"layers.{i}."
        out += [mat(p + "attn.wq", (d, h * hd)), mat(p + "attn.wk", (d, k * hd)),
                mat(p + "attn.wv", (d, k * hd)), mat(p + "attn.wo", (h * hd, d))]
        if arch.get("qkv_bias"):
            out += [(p + "attn.bq", (h * hd,), "zeros", 0.0),
                    (p + "attn.bk", (k * hd,), "zeros", 0.0),
                    (p + "attn.bv", (k * hd,), "zeros", 0.0)]
        out += [(p + "norm1", (d,), "ones", 0.0), (p + "norm2", (d,), "ones", 0.0),
                mat(p + "mlp.w_gate", (d, ff)), mat(p + "mlp.w_up", (d, ff)),
                mat(p + "mlp.w_down", (ff, d))]
    out.append(("final_norm", (d,), "ones", 0.0))
    if not arch.get("tie_embeddings"):
        out.append(("lm_head", (d, v), "normal", 1.0 / math.sqrt(d)))
    return out


def normal_pieces(lay: list, seed: int, device):
    """Yield ``(name, offset, values)``: the normal leaves' values, a piece
    of a leaf at a time (``offset`` into the flattened leaf), in float32."""
    import torch

    spans, total = [], 0
    for name, shape, kind, std in lay:
        if kind == "normal":
            n = math.prod(shape)
            spans.append((name, total, n, std))
            total += n
    for j in range(-(-total // CHUNK)):
        lo, hi = j * CHUNK, min((j + 1) * CHUNK, total)
        gen = torch.Generator(device=device).manual_seed(traffic.derive(seed, "weights", j))
        x = torch.randn(hi - lo, generator=gen, device=device, dtype=torch.float32)
        for name, start, n, std in spans:
            a, b = max(lo, start), min(hi, start + n)
            if a < b:
                yield name, a - start, x[a - lo: b - lo].mul(std)


def fill(leaves: dict, lay: list, seed: int) -> None:
    """Write the initial weights into ``leaves`` (name -> tensor), in place."""
    import torch

    with torch.no_grad():
        for name, shape, kind, _ in lay:
            if tuple(leaves[name].shape) != tuple(shape):
                raise ValueError(f"leaf {name}: shape {tuple(leaves[name].shape)}, layout {shape}")
            if kind != "normal":
                leaves[name].fill_(1.0 if kind == "ones" else 0.0)
        device = next(iter(leaves.values())).device
        for name, off, vals in normal_pieces(lay, seed, device):
            flat = leaves[name].view(-1)
            flat[off: off + vals.numel()].copy_(vals)


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

    sq = {}
    with torch.no_grad():
        for name, shape, kind, _ in lay:
            if kind != "normal":
                sq[name] = float((leaves[name].float() - (1.0 if kind == "ones" else 0.0))
                                 .square().sum())
            else:
                sq[name] = 0.0
        device = next(iter(leaves.values())).device
        for name, off, vals in normal_pieces(lay, seed, device):
            part = leaves[name].view(-1)[off: off + vals.numel()].float()
            sq[name] += float((part - vals).square().sum())
    return {k: math.sqrt(v) for k, v in sq.items()}
