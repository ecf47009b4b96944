"""Monte-Carlo job compute-time simulator (port of ``repro.core.simulator``).

Semantics: every worker w computes its batch and delivers at time ``T_w``;
the job completes at the earliest time when the union of delivered batches
covers all N tasks.  For balanced non-overlapping batches this reduces to the
paper's ``T = max_i min_j T_ij`` -- :func:`gang_cover_times`, which on a CUDA
tensor runs the hand-written cover kernel (:mod:`repro_torch.kernels.cover`).

For any membership matrix (the overlapping schemes of Fig. 5, random
placement) the earliest cover is the max over tasks of the earliest time any
of the task's hosts delivers, ``T = max_t min_{w : M[w, t]} T_w`` (``inf``
when a task has no host): :func:`membership_cover_times` gathers each task's
host times into a padded ``(S, T, k_max)`` grid and reduces it with the same
kernel, where the reference sorts each sample and scans a ``cumsum`` of
membership rows.
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
    "simulate_membership",
    "membership_cover_times",
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


# --------------------------------------------------------------------------
# general membership matrix (overlapping schemes; earliest-cover semantics)
# --------------------------------------------------------------------------

# elements of one gathered (chunk, T, k_max) grid: 2**28 is 1 GiB in float32
_MEMBERSHIP_CHUNK_ELEMENTS = 2**28


def _host_lists(membership: np.ndarray) -> np.ndarray:
    """``(T, k_max)`` worker ids hosting each task, padded with ``W`` (an
    index past the last worker, which the caller points at ``+inf``)."""
    n_workers, n_tasks = membership.shape
    hosts = [np.flatnonzero(membership[:, t]) for t in range(n_tasks)]
    k_max = max((h.size for h in hosts), default=0)
    idx = np.full((n_tasks, max(k_max, 1)), n_workers, dtype=np.int64)
    for t, h in enumerate(hosts):
        idx[t, : h.size] = h
    return idx


def membership_cover_times(times: torch.Tensor, membership) -> torch.Tensor:
    """``(S, W)`` worker delivery times and a ``(W, T)`` membership -> ``(S,)``.

    Sample ``s`` completes at ``max_t min_{w : M[w, t]} times[s, w]``, ``inf``
    when some task has no host: the reference's ``_cover_times`` (the first
    sorted time at which the delivered batches cover every task), as a masked
    ``max min``.  Each task's hosts are gathered into a ``(chunk, T, k_max)``
    grid, padding slots at ``+inf``, and reduced by :func:`gang_cover_times`:
    one launch of the cover kernel per chunk of samples on CUDA, its plain
    version on the CPU.  Only min and max touch the values, so the result is
    bitwise the reference's on the same times.
    """
    membership = np.asarray(membership, dtype=bool)
    if (membership.ndim != 2 or membership.shape[1] == 0 or times.dim() != 2
            or times.shape[1] != membership.shape[0]):
        raise ValueError("need (S, W) times and a (W, T) membership matrix with T >= 1")
    n_samples = times.shape[0]
    idx = torch.as_tensor(_host_lists(membership), device=times.device)
    pad = torch.full((n_samples, 1), torch.inf, dtype=times.dtype, device=times.device)
    padded = torch.cat([times, pad], dim=1)  # column W is the padding slot
    chunk = max(1, _MEMBERSHIP_CHUNK_ELEMENTS // idx.numel())
    out = torch.empty(n_samples, dtype=times.dtype, device=times.device)
    for lo in range(0, n_samples, chunk):
        grid = padded[lo : lo + chunk][:, idx]  # (chunk, T, k_max)
        out[lo : lo + chunk] = gang_cover_times(grid)
    return out


def simulate_membership(
    generator: torch.Generator,
    dist: ServiceTime,
    membership: np.ndarray,
    n_samples: int,
    size_dependent: bool = True,
    *,
    device=None,
    dtype="float32",
) -> np.ndarray:
    """Job times for any batching scheme (Fig. 5 schemes 1/2/3, random, ...).

    Worker ``w`` delivers at ``tau_w * |batch_w|`` (``size_dependent``) or
    ``tau_w``, with ``tau`` drawn from ``dist``; the job completes at the
    earliest cover (:func:`membership_cover_times`).  ``generator`` must
    live on ``device``.
    """
    membership = np.asarray(membership, dtype=bool)
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    n_workers = membership.shape[0]
    draws = dist.sample(generator, (int(n_samples), n_workers), dev, dt)
    if size_dependent:
        draws = draws * torch.as_tensor(membership.sum(axis=1), dtype=dt, device=dev)
    return membership_cover_times(draws, membership).cpu().numpy()
