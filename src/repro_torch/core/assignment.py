"""Batch-to-worker assignment and majorization machinery (§IV, Lemmas 2-3).

A numpy copy of ``repro.core.assignment``: count vectors are host data,
and the port never imports the JAX package.

An assignment of B non-overlapping batches to N workers is summarized by the
vector Nbar = (N_1, ..., N_B) of per-batch host counts, sum N_i = N.  The
paper's result: if batch service times are stochastically decreasing-convex,
E[T(Nbar1)] >= E[T(Nbar2)] whenever Nbar1 majorizes Nbar2 -- so the balanced
vector (N/B, .., N/B), majorized by everything (Lemma 3), is optimal (Thm 1-2).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "balanced_counts",
    "counts_from_membership",
    "majorizes",
    "is_balanced",
    "assignment_from_counts",
    "random_counts",
]


def balanced_counts(n_workers: int, n_batches: int) -> np.ndarray:
    """Lemma 3's vector: (N/B, ..., N/B).  Requires B | N like the paper."""
    if n_workers % n_batches:
        raise ValueError(f"B={n_batches} must divide N={n_workers}")
    return np.full(n_batches, n_workers // n_batches, dtype=np.int64)


def counts_from_membership(membership: np.ndarray) -> np.ndarray:
    """Per-batch host counts from a non-overlapping membership matrix.

    Workers with identical rows host the same batch.
    """
    _, inverse = np.unique(membership, axis=0, return_inverse=True)
    return np.bincount(inverse)


def majorizes(v: np.ndarray, w: np.ndarray) -> bool:
    """True iff v majorizes w (Definition 4)."""
    v = np.sort(np.asarray(v))[::-1]
    w = np.sort(np.asarray(w))[::-1]
    if v.shape != w.shape or v.sum() != w.sum():
        return False
    return bool(np.all(np.cumsum(v) >= np.cumsum(w)))


def is_balanced(counts: np.ndarray) -> bool:
    """Whether every batch landed on the same number of workers."""
    counts = np.asarray(counts)
    return bool(counts.min() == counts.max())


def assignment_from_counts(counts: np.ndarray) -> np.ndarray:
    """Worker -> batch id map realizing a host-count vector."""
    out = np.concatenate([np.full(c, i, dtype=np.int64) for i, c in enumerate(counts)])
    return out


def random_counts(n_workers: int, n_batches: int, rng: np.random.Generator) -> np.ndarray:
    """Host-count vector of the coupon-collector assignment (may have zeros)."""
    draws = rng.integers(0, n_batches, size=n_workers)
    return np.bincount(draws, minlength=n_batches)
