"""The training step's plain reference: Qwen2 forward, loss, backward and AdamW in plain PyTorch.

A decoder of ``n_layers`` blocks (Qwen2, arXiv:2407.10671): token embedding;
per block ``x + attn(rmsnorm(x))`` then ``x + mlp(rmsnorm(x))``, attention
grouped-query with bias on q, k, v, rotary positions (rotate-half, base
``rope_theta``) and causal; a SwiGLU MLP; a final RMSNorm; logits against
the tied embedding; the mean token cross-entropy.  As the configuration
states, master weights, gradients and AdamW's moments are float32 and the
compute is bfloat16: each block casts its weights to bfloat16, products run
in bfloat16 with float32 sums, RMSNorm, RoPE, the softmax of attention and
the loss run in float32, and attention's products in float32 (TF32 off).

The batch is taken a block of rows at a time, so that it fits beside
nothing else on the card: each block's loss is summed over its tokens and
divided by the whole batch's token count, its gradient added into the
master weights' ``.grad``, and each block's layers are recomputed in the
backward (``torch.utils.checkpoint``).  AdamW follows (Loshchilov and
Hutter): global-norm clipping, bias corrections, decoupled weight decay on
leaves of two or more dimensions, the cosine schedule with linear warm-up.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (a per-tensor scale to its largest value) before the product,
the next precision below the configuration's bfloat16.  Nothing of the
program is imported: the reference makes its weights (:mod:`perfbench.weights`)
and its batches (:mod:`perfbench.traffic`) itself from the seed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import traffic, weights, work

BF16 = torch.bfloat16
FP8_MAX = 448.0


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    rounded = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (rounded - x.detach())  # the rounded values; the gradient passes through


def _mm(a, b, precision):
    return _round(a, precision) @ _round(b, precision)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): rotate-half rotary embedding at positions 0 .. S-1, in float32."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos()] * 2, -1)[None, :, None, :]
    sin = torch.cat([ang.sin()] * 2, -1)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, -1)
    return (xf * cos + torch.cat([-x2, x1], -1) * sin).to(x.dtype)


def _attention(q, k, v):
    """Causal grouped-query attention in float32; q (B,S,H,hd), k/v (B,S,K,hd)."""
    h, kh, hd = q.shape[2], k.shape[2], q.shape[3]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(h // kh, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // kh, dim=2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) / math.sqrt(hd)
    n = s.shape[-1]
    mask = torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)


def _block(x, p: dict, arch: dict, precision: str):
    w = {k: t.to(BF16) for k, t in p.items()}
    b, s, d = x.shape
    h, kh, hd = arch["n_heads"], arch["n_kv_heads"], work.head_dim(arch)
    eps = arch["rms_norm_eps"]
    y = _rms(x, w["norm1"], eps)
    q = _mm(y, w["attn.wq"], precision)
    k = _mm(y, w["attn.wk"], precision)
    v = _mm(y, w["attn.wv"], precision)
    if arch.get("qkv_bias"):
        q, k, v = q + w["attn.bq"], k + w["attn.bk"], v + w["attn.bv"]
    q = _rope(q.reshape(b, s, h, hd), arch["rope_theta"])
    k = _rope(k.reshape(b, s, kh, hd), arch["rope_theta"])
    o = _attention(q, k, v.reshape(b, s, kh, hd)).reshape(b, s, h * hd)
    x = x + _mm(o, w["attn.wo"], precision)
    y = _rms(x, w["norm2"], eps)
    gate = F.silu(_mm(y, w["mlp.w_gate"], precision))
    return x + _mm(gate * _mm(y, w["mlp.w_up"], precision), w["mlp.w_down"], precision)


def _loss_sum(params: dict, arch: dict, tokens, labels, mask, precision: str):
    x = params["embed"][tokens.long()].to(BF16)
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        layer = {k[len(pre):]: t for k, t in params.items() if k.startswith(pre)}
        x = checkpoint(_block, x, layer, arch, precision, use_reentrant=False)
    x = _rms(x, params["final_norm"], arch["rms_norm_eps"])
    head = params["embed"].T if arch.get("tie_embeddings") else params["lm_head"]
    logits = _mm(x, head.to(BF16), precision).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum()


def _lr(opt: dict, count: int) -> float:
    s = opt["schedule"]
    peak, warm, total = s["peak"], s["warmup"], s["total"]
    if count < warm:
        return peak * count / max(warm, 1)
    frac = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = peak * s["floor_frac"]
    return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * frac))


class Trainer:
    """The reference's state: master weights and AdamW's moments by leaf name."""

    def __init__(self, arch: dict, seed: int, device, precision: str = "bf16"):
        self.arch, self.precision = arch, precision
        self.layout = weights.layout(arch)
        self.params = weights.make(self.layout, seed, device)
        for p in self.params.values():
            p.requires_grad_(True)
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def step(self, batch: dict, opt: dict, block_tokens: int) -> float:
        """One step on ``batch``; returns its mean token loss."""
        tokens, labels, mask = batch["tokens"], batch["labels"], batch["loss_mask"]
        rows = max(1, block_tokens // tokens.shape[1])
        denom = mask.sum().clamp_min(1.0)
        total = 0.0
        for p in self.params.values():
            p.grad = None
        for lo in range(0, tokens.shape[0], rows):
            part = slice(lo, lo + rows)
            loss = _loss_sum(self.params, self.arch, tokens[part], labels[part], mask[part],
                             self.precision) / denom
            loss.backward()
            total += float(loss.detach())
        self._adamw(opt)
        return total

    @torch.no_grad()
    def _adamw(self, opt: dict) -> None:
        grads = {k: p.grad.float() for k, p in self.params.items()}
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12), max=1.0)
        self.count += 1
        b1, b2 = opt["b1"], opt["b2"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        lr = _lr(opt, self.count)
        for k, p in self.params.items():
            g = grads[k] * scale
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            step = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + opt["eps"])
            if opt["weight_decay"] and p.dim() >= opt["decay_min_ndim"]:
                step = step + opt["weight_decay"] * p
            p.add_(step, alpha=-lr)
            p.grad = None

    def grad_norms(self, b1: float) -> dict:
        """Each leaf's first gradient as AdamW received it: ``||m|| / (1 - b1)`` after one step."""
        return {k: float(m.norm()) / (1 - b1) for k, m in self.m.items()}


def follow(config: dict, mix: dict, seed: int, n_steps: int, device,
           precision: str = "bf16", rows: int | None = None) -> dict:
    """The reference over the run's first ``n_steps`` batches: each step's
    loss, each leaf's first gradient norm and each leaf's change after the
    steps.  ``rows`` keeps only each batch's first rows (a fault for the
    limits' readings: half the batch left out, the mean over the rest)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(config, seed, device, precision)
    losses, grads = [], None
    for k in range(n_steps):
        batch = traffic.lm_batch(mix, config["vocab_size"], seed, k, device)
        if rows is not None:
            batch = {name: t[:rows] for name, t in batch.items()}
        losses.append(tr.step(batch, config["optimizer"], int(mix.get("block_tokens", 4096))))
        if k == 0:
            grads = tr.grad_norms(config["optimizer"]["b1"])
    change = weights.change_norms({k: p.detach() for k, p in tr.params.items()}, tr.layout, seed)
    return {"loss": losses, "grad": grads, "change": change}


def compare(program: dict, reference: dict, skip_share: float = 1e-3) -> dict:
    """The numbers compared between the program's readings and the reference's:

    * ``loss_gap``: the largest ``|loss - reference loss| / reference loss`` over the steps;
    * ``grad_gap``: over every leaf, the largest ``| ||g|| - ||g_ref|| |`` of the
      first gradient, against the larger of the leaf's reference norm and the
      median leaf's;
    * ``change_gap``: the same of each leaf's change after the steps, leaving
      out the leaves whose reference gradient is under ``skip_share`` of the
      median leaf's (they move by round-off alone, as a key's bias under
      softmax does).
    """
    def worst(got: dict, want: dict, names) -> float:
        names = list(names)
        med = sorted(want[n] for n in names)[len(names) // 2]
        return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], reference["loss"]))
    g_ref = reference["grad"]
    g_med = sorted(g_ref.values())[len(g_ref) // 2]
    moved = [n for n, g in g_ref.items() if g >= skip_share * g_med]
    return {"loss_gap": loss_gap, "grad_gap": worst(program["grad"], g_ref, g_ref),
            "change_gap": worst(program["change"], reference["change"], moved)}
