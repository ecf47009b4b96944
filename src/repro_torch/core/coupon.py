"""Lemma 1: batch-coverage probability of *random* batch-to-worker assignment.

A numpy copy of ``repro.core.coupon``: the port never imports the JAX
package, and these values must stay bit-exact to it.

With N workers each drawing one of B batches uniformly at random (the coupon
collector model of [72]), the probability that all B batches are covered is

    P(n <= N) = B! / B^N * S(N, B)                              (Eq. 6)

with S the Stirling number of the second kind.  The paper uses this to argue
random assignment is unsafe (Fig. 3); our data pipeline turns it into a
startup invariant (deterministic balanced placement + coverage check).

The alternating Stirling sum overflows float64 well before the N=100..1000
range that matters, so we evaluate it with a signed log-sum-exp.
"""
from __future__ import annotations

import math

import numpy as np


def log_binom(n: int, k: int) -> float:
    """Log of the binomial coefficient C(n, k), via lgamma."""
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def coverage_probability(n_workers: int, n_batches: int) -> float:
    """P{all B batches covered by N uniform draws}  (Lemma 1, exact).

    Direct inclusion-exclusion in log domain:
        P = sum_{k=0}^{B} (-1)^k C(B,k) (1 - k/B)^N
    (equivalent to B! S(N,B) / B^N, but numerically stable).
    """
    b, n = n_batches, n_workers
    if b <= 0 or n <= 0:
        raise ValueError("need positive N and B")
    if n < b:
        return 0.0
    if b == 1:
        return 1.0
    # signed log-sum-exp of terms t_k = (-1)^k C(B,k) ((B-k)/B)^N, k = 0..B-1
    logs = np.empty(b)
    signs = np.empty(b)
    for k in range(b):
        logs[k] = log_binom(b, k) + n * (math.log(b - k) - math.log(b))
        signs[k] = 1.0 if k % 2 == 0 else -1.0
    m = logs.max()
    s = float(np.sum(signs * np.exp(logs - m)))
    if s <= 0.0:  # pure roundoff at extreme N/B; probability is ~0 or ~1
        return 0.0
    return float(min(1.0, math.exp(m + math.log(s))))


def coverage_probability_mc(
    n_workers: int, n_batches: int, n_samples: int, seed: int = 0
) -> float:
    """Monte-Carlo estimate of the same probability (test oracle)."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n_batches, size=(n_samples, n_workers))
    # covered iff every batch id appears in the row
    counts = np.zeros((n_samples, n_batches), dtype=np.int64)
    rows = np.repeat(np.arange(n_samples), n_workers)
    np.add.at(counts, (rows, draws.ravel()), 1)
    return float((counts > 0).all(axis=1).mean())


def min_workers_for_coverage(n_batches: int, confidence: float = 0.99) -> int:
    """Smallest N with coverage probability >= confidence (planner helper)."""
    n = n_batches
    while coverage_probability(n, n_batches) < confidence:
        n = max(n + 1, int(n * 1.1))
        if n > 10_000_000:
            raise RuntimeError("coverage target unreachable")
    # binary search down to the exact threshold
    lo, hi = n_batches, n
    while lo < hi:
        mid = (lo + hi) // 2
        if coverage_probability(mid, n_batches) >= confidence:
            hi = mid
        else:
            lo = mid + 1
    return lo
