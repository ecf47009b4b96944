"""The planner's plain reference: the frontier of (B, r) scored by Monte-Carlo, in plain PyTorch.

For ``n_workers`` workers and every B that divides them (r = N / B), rep
``k`` of candidate ``c`` draws each replica's service time from the job
class's observations, scales it by the §VI size model (N / B), and takes
``T = max over batches of min over replicas``; a candidate's mean and CoV
are taken over its reps, and B* is the candidate of least mean.

The draws are the counter-based stream the configuration states: Philox-
4x32-10 (Salmon et al., SC'11) keyed on the plan's seed (low, high 32-bit
words), counter ``(slot // 4, rep, candidate, 0)``, word ``slot % 4`` of
the output picking observation ``(word * n) >> 32`` of the class's ``n``.
The round arithmetic is a copy of ``src/repro_torch/kernels/philox.py``'s
(32-bit words in int64, products split in 16-bit halves); nothing of the
program is imported.  The cover is taken in ``dtype`` (float32, as the
configuration states; bfloat16 is the control) and the statistics in
float64.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox_words(seed: int, cand: int, n_reps: int, n_counters: int, device) -> torch.Tensor:
    """``(n_reps, 4 * n_counters)`` output words of candidate ``cand``'s counters."""
    seed = int(seed) & (2**64 - 1)
    k0, k1 = seed & _MASK, seed >> 32
    q = torch.arange(n_counters, dtype=torch.int64, device=device)[None, :]
    k = torch.arange(n_reps, dtype=torch.int64, device=device)[:, None]
    c0, c1 = q.expand(n_reps, n_counters), k.expand(n_reps, n_counters)
    c2 = torch.full_like(c0, cand)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.stack((c0, c1, c2, c3), dim=-1).reshape(n_reps, 4 * n_counters)


def frontier_rows(observations, n_workers: int, n_reps: int, seed: int,
                  dtype=torch.float32, device="cpu") -> tuple[list, torch.Tensor]:
    """``(candidates, rows)``: every B dividing ``n_workers``, and the
    ``(C, n_reps)`` job times of each, computed in ``dtype``."""
    cands = [b for b in range(1, n_workers + 1) if n_workers % b == 0]
    table = torch.as_tensor(np.asarray(observations, dtype=np.float64)).to(device, dtype)
    n = table.numel()
    rows = torch.empty((len(cands), n_reps), dtype=dtype, device=device)
    for c, b in enumerate(cands):
        r = n_workers // b
        words = philox_words(seed, c, n_reps, -(-(b * r) // 4), device)[:, : b * r]
        draws = table[(words * n) >> 32]
        scale = torch.tensor(n_workers / b, dtype=torch.float64).to(device, dtype)
        rows[c] = (draws * scale).reshape(n_reps, b, r).amin(-1).amax(-1)
    return cands, rows


def plan(observations, n_workers: int, n_reps: int, seed: int, dtype=torch.float32,
         device="cpu") -> dict:
    """The reference's plan: candidates, float64 means and CoVs, and B*."""
    cands, rows = frontier_rows(observations, n_workers, n_reps, seed, dtype, device)
    t = rows.double().cpu().numpy()
    means = t.mean(axis=1)
    covs = t.std(axis=1) / means
    return {"B": cands, "mean": means, "cov": covs, "B_star": cands[int(np.argmin(means))]}


def compare(program: list, reference: list) -> dict:
    """The numbers compared over pairs of plans (the program's, the reference's):

    * ``mean_gap``: the largest relative gap of a frontier mean from the
      reference's, over every candidate of every plan, and of the
      reference's mean at the program's B* from the reference's least mean
      (a B* that is not the reference's best, up to a tie, reads as a gap);
    * ``cov_gap``: the largest relative gap of a frontier CoV from the reference's.
    """
    mean_gap = cov_gap = 0.0
    for got, want in zip(program, reference):
        if list(got["B"]) != list(want["B"]):  # another frontier: nothing lines up
            return {"mean_gap": 1.0, "cov_gap": 1.0}
        m, c = np.asarray(got["mean"], np.float64), np.asarray(got["cov"], np.float64)
        best = float(np.min(want["mean"]))
        at = float(want["mean"][list(want["B"]).index(got["B_star"])])
        mean_gap = max(mean_gap, float(np.max(np.abs(m - want["mean"]) / want["mean"])),
                       (at - best) / best)
        cov_gap = max(cov_gap, float(np.max(np.abs(c - want["cov"]) / want["cov"])))
    return {"mean_gap": mean_gap, "cov_gap": cov_gap}
