"""Task batching schemes (§III and Fig. 5 of the paper).

A numpy copy of ``repro.core.batching``: membership matrices are host
data, and the port never imports the JAX package.

A *batching* for (N tasks, batch size s = N/B) is a boolean membership matrix
``M[w, t] = True`` iff worker w's batch contains task t.  The paper's schemes:

  * ``non_overlapping``  -- N tasks chopped into B contiguous batches, each
    replicated on r = N/B workers (scheme 3 in Fig. 5).  Optimal (Thms 1-2).
  * ``cyclic``           -- N overlapping batches, batch w = tasks
    {w, w+1, .., w+s-1} mod N (scheme 1 in Fig. 5; the gradient-coding
    placement of Tandon et al. [41]).
  * ``hybrid``           -- the Fig. 5 scheme 2 middle point: one subset of
    workers gets cyclic-overlapped windows, the rest non-overlapping chops.
  * ``random``           -- each worker draws one of the B non-overlapping
    batches uniformly at random (coupon collector placement of [72]).

All schemes keep the batch size equal (the paper's comparability constraint)
and, except ``random``, give every task equal replication (fairness
assumption of §III-B).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "non_overlapping",
    "cyclic",
    "hybrid",
    "random_nonoverlapping",
    "membership_from_batches",
    "validate_scheme",
    "replication_counts",
]


def _check(n_tasks: int, n_batches: int) -> int:
    if n_tasks % n_batches:
        raise ValueError(f"B={n_batches} must divide N={n_tasks} (paper §II-C)")
    return n_tasks // n_batches


def membership_from_batches(batches: list, n_tasks: int) -> np.ndarray:
    """Boolean (worker, task) membership matrix from per-worker batch sets."""
    m = np.zeros((len(batches), n_tasks), dtype=bool)
    for w, batch in enumerate(batches):
        m[w, list(batch)] = True
    return m


def non_overlapping(n_tasks: int, n_batches: int, n_workers: int | None = None) -> np.ndarray:
    """Balanced replication of B contiguous batches over N workers.

    Worker w hosts batch (w % B) -- i.e. batches are dealt round-robin, which
    for n_workers = N gives each batch exactly r = N/B hosts (balanced,
    Lemma 3's majorization-minimal vector).
    """
    size = _check(n_tasks, n_batches)
    n_workers = n_tasks if n_workers is None else n_workers
    batches = [range(i * size, (i + 1) * size) for i in range(n_batches)]
    return membership_from_batches([batches[w % n_batches] for w in range(n_workers)], n_tasks)


def cyclic(n_tasks: int, n_batches: int) -> np.ndarray:
    """Scheme 1: worker w hosts the cyclic window starting at task w."""
    size = _check(n_tasks, n_batches)
    batches = [[(w + j) % n_tasks for j in range(size)] for w in range(n_tasks)]
    return membership_from_batches(batches, n_tasks)


def hybrid(n_tasks: int, n_batches: int) -> np.ndarray:
    """Scheme 2 of Fig. 5, generalized.

    The N workers are split into r = N/B subsets, each subset covering every
    task exactly once.  The first r-1 subsets use shifted cyclic-style chops
    (offset by one task per subset, wrapping), the last subset uses the plain
    non-overlapping chop.  For (N=6, B=3) this reproduces the paper's scheme 2
    batch multiset {12, 23, 34, 45, 56, 56}-style middle point: batches overlap
    across subsets but fewer pairs share tasks than full cyclic.
    """
    size = _check(n_tasks, n_batches)
    r = n_tasks // n_batches
    batches = []
    for subset in range(r):
        off = subset  # subset 0 = aligned chop; later subsets shifted by 1 task each
        for i in range(n_batches):
            batches.append([(off + i * size + j) % n_tasks for j in range(size)])
    return membership_from_batches(batches, n_tasks)


def random_nonoverlapping(
    n_tasks: int, n_batches: int, rng: np.random.Generator, n_workers: int | None = None
) -> np.ndarray:
    """Coupon-collector placement: each worker draws a batch uniformly."""
    size = _check(n_tasks, n_batches)
    n_workers = n_tasks if n_workers is None else n_workers
    batches = [range(i * size, (i + 1) * size) for i in range(n_batches)]
    draws = rng.integers(0, n_batches, size=n_workers)
    return membership_from_batches([batches[d] for d in draws], n_tasks)


def replication_counts(membership: np.ndarray) -> np.ndarray:
    """How many workers host each task (fairness diagnostics)."""
    return membership.sum(axis=0)


def validate_scheme(membership: np.ndarray, equal_batch_size: bool = True) -> dict:
    """Runtime invariants (the coverage guard of DESIGN §3.3).

    Returns diagnostics; raises if a task is uncovered (Lemma 1's failure mode).
    """
    per_task = replication_counts(membership)
    if (per_task == 0).any():
        missing = np.flatnonzero(per_task == 0).tolist()
        raise ValueError(f"uncovered tasks {missing}: job result would be incorrect")
    sizes = membership.sum(axis=1)
    if equal_batch_size and len(set(sizes.tolist())) != 1:
        raise ValueError(f"unequal batch sizes {sorted(set(sizes.tolist()))}")
    return {
        "n_workers": int(membership.shape[0]),
        "n_tasks": int(membership.shape[1]),
        "batch_size": int(sizes[0]),
        "min_replication": int(per_task.min()),
        "max_replication": int(per_task.max()),
        "balanced": bool(per_task.min() == per_task.max()),
    }
