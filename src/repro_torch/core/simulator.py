"""Monte-Carlo job compute-time simulator (port of ``repro.core.simulator``).

Semantics: every worker w computes its batch and delivers at time ``T_w``;
the job completes at the earliest time when the union of delivered batches
covers all N tasks.  For balanced non-overlapping batches this reduces to the
paper's ``T = max_i min_j T_ij`` -- :func:`gang_cover_times`, which on a CUDA
tensor runs the hand-written cover kernel (:mod:`repro_torch.kernels.cover`).

``simulate_membership`` (overlapping schemes) comes with the
batching/assignment slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..kernels.cover import masked_cover_times
from .service_time import ServiceTime

__all__ = [
    "gang_cover_times",
    "simulate_balanced",
    "simulate_counts",
    "JobTimeStats",
    "stats_from_samples",
]


@dataclasses.dataclass(frozen=True)
class JobTimeStats:
    """Summary statistics of a job-time sample (mean, spread, tail quantiles)."""

    mean: float
    std: float
    cov: float  # coefficient of variation -- the paper's predictability metric
    p50: float
    p95: float
    p99: float
    n_samples: int

    @staticmethod
    def empty() -> "JobTimeStats":
        """The all-NaN stats object for an empty sample."""
        return JobTimeStats(np.nan, np.nan, np.nan, np.nan, np.nan, np.nan, 0)


def stats_from_samples(samples: np.ndarray) -> JobTimeStats:
    """Fold a sample of job times into :class:`JobTimeStats`."""
    s = np.asarray(samples, dtype=np.float64)
    m = float(s.mean())
    sd = float(s.std())
    return JobTimeStats(
        mean=m,
        std=sd,
        cov=sd / m if m > 0 else np.inf,
        p50=float(np.percentile(s, 50)),
        p95=float(np.percentile(s, 95)),
        p99=float(np.percentile(s, 99)),
        n_samples=int(s.size),
    )


def gang_cover_times(
    draws: torch.Tensor,
    n_batches: int | None = None,
    replication: int | None = None,
) -> torch.Tensor:
    """Earliest-cover completion of a balanced gang dispatch: ``max_b min_r``.

    ``draws`` carries replica durations on its last two axes, shaped
    ``(..., B_pad, r_pad)``.  With ``n_batches`` / ``replication`` given,
    slots beyond them are masked out, so one padded grid serves any (B, r)
    that fits in it.  On a CUDA tensor this is one launch of the cover
    kernel; on the CPU it is the kernel's plain PyTorch version.
    """
    b_pad, r_pad = draws.shape[-2], draws.shape[-1]
    lead = draws.shape[:-2]
    out = masked_cover_times(
        draws.reshape(-1, b_pad, r_pad).contiguous(),
        b_pad if n_batches is None else n_batches,
        r_pad if replication is None else replication,
    )
    return out.reshape(lead)


def simulate_balanced(
    generator: torch.Generator,
    dist: ServiceTime,
    n_workers: int,
    n_batches: int,
    n_samples: int,
    size_dependent: bool = True,
    *,
    device=None,
    dtype="float32",
) -> np.ndarray:
    """Job times under the balanced non-overlapping policy.

    size_dependent=True uses the §VI model (batch time = (N/B) * tau);
    False uses the §IV model (batch times drawn from ``dist`` directly).
    ``generator`` must live on ``device``.
    """
    if n_workers % n_batches:
        raise ValueError("B must divide N")
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    r = n_workers // n_batches
    scale = n_workers / n_batches if size_dependent else 1.0
    draws = dist.sample(generator, (n_samples, n_batches, r), dev, dt) * scale
    return gang_cover_times(draws).cpu().numpy()


def simulate_counts(
    generator: torch.Generator,
    dist: ServiceTime,
    counts: np.ndarray,
    n_samples: int,
    size_dependent: bool = False,
    n_tasks: int | None = None,
    *,
    device=None,
    dtype="float32",
) -> np.ndarray:
    """T = max_i min over N_i hosts, for an arbitrary host-count vector.

    Batches with zero hosts make the job incomplete; we return inf for those
    samples (the paper's "inaccurate result" failure of random assignment).
    """
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    counts = np.asarray(counts)
    n_batches = counts.shape[0]
    max_c = int(counts.max())
    if max_c == 0:
        # All batches hostless: the masked path below would sample a
        # zero-width axis and a min over it is undefined -- guard explicitly.
        return np.full(n_samples, np.inf)
    scale = 1.0
    if size_dependent:
        if n_tasks is None:
            raise ValueError("size_dependent requires n_tasks")
        scale = n_tasks / n_batches
    draws = dist.sample(generator, (n_samples, n_batches, max_c), dev, dt) * scale
    # mask out slots beyond each batch's host count
    slots = torch.arange(max_c, device=dev)[None, :]
    mask = slots < torch.as_tensor(counts, device=dev)[:, None]  # (B, max_c)
    draws = torch.where(mask[None], draws, torch.inf)
    return gang_cover_times(draws).cpu().numpy()  # inf where a count is 0
