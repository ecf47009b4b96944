"""The Mamba-2 training step's plain reference: forward, loss, backward and AdamW in plain PyTorch.

Mamba-2 (arXiv:2405.21060; ``mamba_ssm``'s ``MambaLMHeadModel`` with its
``Mamba2`` mixer): token embedding; per block ``x + mixer(rmsnorm(x))`` with
the residual ``x`` in float32 (``residual_in_fp32``); a final RMSNorm;
logits against the tied embedding; the mean token cross-entropy.  The mixer:
the in-projection (no bias) to z, x, B, C and dt; a depthwise causal conv of
width ``ssm_conv`` with bias over x and over B, C, then SiLU;
``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD scan with the
``D`` skip; the gated norm ``rmsnorm(y * silu(z)) * w`` (norm after the
gate); the out-projection.  Every RMSNorm at ``norm_eps``.

The scan is the paper's chunked dual form, from its minimal listing: chunks
of ``ssm_chunk`` steps; within a chunk ``exp(segsum(dt A))``, its upper
triangle masked to ``-inf`` before the exp, weights ``C B^T`` over ``dt x``;
each chunk's final state; the states passed from chunk to chunk by the same
``segsum`` over the chunks' total decays; the output from the state each
chunk starts from.  ``carry=False`` is a fault for the limits' readings:
every chunk starts from a zero state.

Precision mirrors :mod:`perfbench.reference.train` (qwen2's): master weights,
gradients and AdamW's moments in float32; each block casts its weights to
bfloat16 but ``A_log``, ``dt_bias`` and ``D``; the projections and the logits
are bfloat16 products with float32 sums; the conv, the scan, every norm, the
softplus and the loss run in float32 (TF32 off) on bfloat16 inputs.
``precision="fp8"`` rounds every product's operands to float8 e4m3, the
control.  The batch is taken a block of rows at a time, each block's layers
recomputed in the backward (``torch.utils.checkpoint``); the loss is a plain
token mean, so the blocks' sums add up exactly.  AdamW, the schedule and
:func:`compare` are :mod:`perfbench.reference.train`'s.  Nothing of the
program is imported: weights come from :mod:`perfbench.mamba2`, batches from
:mod:`perfbench.traffic`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import mamba2, traffic
from perfbench.harness import HERE, load_module

_train = load_module(HERE / "reference" / "train.py", "perfbench_reference_train")
BF16 = _train.BF16
KEEP_FP32 = ("A_log", "dt_bias", "D")
compare = _train.compare
_mm = _train._mm


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 of ``x``, times ``w``; float32 out."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU, float32: x (B, S, C), taps w (K, C), the
    last tap on the current step."""
    k, c = w.shape
    y = F.conv1d(x.float().transpose(1, 2), w.float().T[:, None, :], b.float(),
                 padding=k - 1, groups=c)[..., : x.shape[1]]
    return F.silu(y).transpose(1, 2)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` for ``i >= j``, and
    ``-inf`` above the diagonal: the log-decay from step ``j`` to step ``i``."""
    t = a.shape[-1]
    a = a[..., None].expand(*a.shape, t)  # [..., i, j] = a[i]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    s = torch.cumsum(a.masked_fill(~below, 0.0), dim=-2)
    return s.masked_fill(~torch.ones_like(below).tril(0), -torch.inf)


def ssd(x, a, b, c, chunk: int, carry: bool = True):
    """The chunked SSD scan of the minimal listing (float32, any length).

    ``x`` (B, S, H, P) is ``dt x``, ``a`` (B, S, H) is ``dt A``, ``b`` and
    ``c`` (B, S, N) shared by the heads.  Returns ``y`` (B, S, H, P) and the
    final state (B, H, P, N)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, a, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, a, b, c))
    nc = (s + pad) // chunk
    X = x.reshape(bsz, nc, chunk, h, p)
    A = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, L)
    Bc = b.reshape(bsz, nc, chunk, n)
    Cc = c.reshape(bsz, nc, chunk, n)
    a_cum = torch.cumsum(A, dim=-1)
    # 1. within each chunk: the masked scores C B^T exp(segsum) times X
    scores = (Cc @ Bc.transpose(-1, -2))[:, None] * torch.exp(segsum(A))  # (B, H, C, L, L)
    y = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    # 2. each chunk's own final state
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, H, C, L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, X)
    # 3. the states carried from chunk to chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B, H, C+1, C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = states[:, :-1], states[:, -1]
    # 4. each chunk's output from the state it starts from
    if carry:
        y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states, torch.exp(a_cum))
    return y.reshape(bsz, nc * chunk, h, p)[:, :s], final


def _mixer(u, w: dict, arch: dict, precision: str, carry: bool):
    m = mamba2.dims(arch)
    bsz, s, _ = u.shape
    h, p, n = m["heads"], m["headdim"], m["state"]
    z = _mm(u, w["w_z"], precision)
    xr = _conv(_mm(u, w["w_x"], precision), w["conv_x"], w["conv_x_b"]).to(BF16)
    bc = _conv(_mm(u, w["w_bc"], precision), w["conv_bc"], w["conv_bc_b"]).to(BF16)
    dt = F.softplus(_mm(u, w["w_dt"], precision).float() + w["dt_bias"])  # (B, S, H)
    a = -torch.exp(w["A_log"])
    xh = xr.float().reshape(bsz, s, h, p)
    bm, cm = bc.float().chunk(2, dim=-1)
    y, _ = ssd(xh * dt[..., None], dt * a, bm, cm, m["chunk"], carry)
    y = (y + w["D"][:, None] * xh).reshape(bsz, s, h * p)
    g = _rms(y * F.silu(z.float()), w["norm_w"], arch["norm_eps"])
    return _mm(g.to(BF16), w["out_proj"], precision)


def _block(x, p: dict, arch: dict, precision: str, carry: bool):
    w = {k: (t if k.rsplit(".", 1)[-1] in KEEP_FP32 else t.to(BF16)) for k, t in p.items()}
    u = _rms(x, w["norm1"], arch["norm_eps"]).to(BF16)
    mixer = {k[len("mixer."):]: t for k, t in w.items() if k.startswith("mixer.")}
    return x + _mixer(u, mixer, arch, precision, carry).float()


def _loss_sum(params: dict, arch: dict, tokens, labels, mask, precision: str, carry: bool):
    x = params["embed"][tokens.long()]  # the float32 residual
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        layer = {k[len(pre):]: t for k, t in params.items() if k.startswith(pre)}
        x = checkpoint(_block, x, layer, arch, precision, carry, use_reentrant=False)
    x = _rms(x, params["final_norm"], arch["norm_eps"]).to(BF16)
    head = params["embed"].T if arch.get("tie_embeddings") else params["lm_head"]
    logits = _mm(x, head.to(BF16), precision).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum()


class Trainer(_train.Trainer):
    """The reference's state: master weights and AdamW's moments by leaf name."""

    def __init__(self, arch: dict, seed: int, device, precision: str = "bf16",
                 carry: bool = True):
        self.arch, self.precision, self.carry = arch, precision, carry
        self.layout = mamba2.layout(arch)
        self.params = mamba2.make(self.layout, seed, device)
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
                             self.precision, self.carry) / denom
            loss.backward()
            total += float(loss.detach())
        self._adamw(opt)
        return total


def follow(config: dict, mix: dict, seed: int, n_steps: int, device,
           precision: str = "bf16", rows: int | None = None, carry: bool = True) -> dict:
    """The reference over the run's first ``n_steps`` batches: each step's
    loss, each leaf's first gradient norm and each leaf's change after the
    steps.  ``rows`` keeps only each batch's first rows and ``carry=False``
    starts every chunk of the scan from a zero state (faults for the limits'
    readings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(config, seed, device, precision, carry)
    losses, grads = [], None
    for k in range(n_steps):
        batch = traffic.lm_batch(mix, config["vocab_size"], seed, k, device)
        if rows is not None:
            batch = {name: t[:rows] for name, t in batch.items()}
        losses.append(tr.step(batch, config["optimizer"], int(mix.get("block_tokens", 4096))))
        if k == 0:
            grads = tr.grad_norms(config["optimizer"]["b1"])
    change = mamba2.change_norms({k: p.detach() for k, p in tr.params.items()}, tr.layout, seed)
    return {"loss": losses, "grad": grads, "change": change}
