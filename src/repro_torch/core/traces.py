"""Synthetic Google-cluster-trace-like workloads (§VII stand-in).

A numpy copy of the parts of ``repro.core.traces`` that the port's planning
loop uses: :class:`TraceJob`, :func:`synthetic_google_jobs` (the §VII
Empirical fixtures), :class:`TraceStream` and :func:`poisson_stream`.  Draws
are host numpy, so equal seeds give bit-identical jobs and slabs in both
packages.

The paper extracts per-task service times (finish - schedule timestamps) for
several jobs from the 2011 Google cluster traces [91] and observes two
families (Fig. 11): exponential-tail (jobs 1-4, shift ~ 10..1000) and
heavy-tail with near-linear log-CCDF decay (jobs 5-10).  The generator makes
statistically matched stand-ins: SExp jobs with large shifts for the
exponential family and Pareto mixtures for the heavy-tail family.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = [
    "TraceJob",
    "TraceStream",
    "STREAM_VERSION",
    "synthetic_google_jobs",
    "poisson_stream",
]


@dataclasses.dataclass(frozen=True)
class TraceJob:
    """One trace-derived job: a named bag of per-task service times."""

    name: str
    family: str  # 'exponential' | 'heavy'
    task_times: np.ndarray  # per-task service times (seconds)

    @property
    def n_tasks(self) -> int:
        """How many tasks the trace recorded for this job."""
        return int(self.task_times.size)


def synthetic_google_jobs(seed: int = 2020) -> List[TraceJob]:
    """Ten jobs mirroring the paper's Fig. 11 families.

    Jobs 1-4: exponential tail (SExp with shifts 10, 10, 10, 1000 -- the shift
    values the paper quotes for its Fig. 12 jobs).  Job 5 is the paper's
    borderline case (linear tail decay).  Jobs 6-10: heavy tail (Pareto with
    alpha in ~1.3..2.5, plus a slowdown mixture to mimic stragglers).
    """
    rng = np.random.default_rng(seed)
    jobs: List[TraceJob] = []

    sexp_params = [(10.0, 1 / 3.0), (10.0, 1 / 8.0), (10.0, 1 / 20.0), (1000.0, 1 / 150.0)]
    for i, (delta, mu) in enumerate(sexp_params, start=1):
        n = int(rng.integers(400, 1200))
        x = delta + rng.exponential(scale=1.0 / mu, size=n)
        jobs.append(TraceJob(name=f"job{i}", family="exponential", task_times=x))

    # job 5: borderline (the paper notes its optimum lands at B=50)
    n = int(rng.integers(400, 1200))
    sigma, alpha = 12.0, 3.0
    u = rng.uniform(size=n)
    x = sigma * u ** (-1.0 / alpha)
    jobs.append(TraceJob(name="job5", family="heavy", task_times=x))

    heavy_params = [(8.0, 1.4), (15.0, 1.8), (6.0, 1.3), (20.0, 2.2), (10.0, 1.6)]
    for i, (sigma, alpha) in enumerate(heavy_params, start=6):
        n = int(rng.integers(400, 1200))
        u = rng.uniform(size=n)
        x = sigma * u ** (-1.0 / alpha)
        # straggler mixture: 3% of tasks hit a 10-30x slowdown (trace artifact)
        mask = rng.uniform(size=n) < 0.03
        x = np.where(mask, x * rng.uniform(10.0, 30.0, size=n), x)
        jobs.append(TraceJob(name=f"job{i}", family="heavy", task_times=x))
    return jobs


# --------------------------------------------------------------------------
# trace-scale streams: thousands of jobs resampled from per-job ECDFs
# --------------------------------------------------------------------------

# Bump when the stream construction (arrival law, source assignment, ECDF
# inverse) changes incompatibly: the version is folded into every seed
# derivation, so old and new code can never silently produce the same draws.
STREAM_VERSION = 1


@dataclasses.dataclass(frozen=True, eq=False)
class TraceStream:
    """A cluster-scale workload: many arrivals resampling a few trace jobs.

    The paper's trace section evaluates tens of jobs; a cluster-*day* is
    thousands.  A stream keeps only what that scale needs -- sorted arrival
    times, a source-job id per arrival, and one concatenated sorted-sample
    buffer over the source jobs -- and resamples service times *per slab* via
    the ECDF inverse (``sorted_samples[floor(u * m)]``), so no caller ever
    materializes the full (reps x jobs x batches) draw tensor.

    Draws are seeded and versioned: ``sample_slab`` consumes a caller-owned
    ``numpy.random.Generator`` strictly left-to-right along the job axis, so
    the draws for jobs ``[lo, hi)`` are a prefix-stable function of the
    generator state -- any slab partition of the same stream yields the same
    numbers bit for bit.
    """

    arrivals: np.ndarray  # (n_jobs,) float64, sorted ascending
    job_ids: np.ndarray  # (n_jobs,) index into sources
    sources: tuple  # tuple[TraceJob, ...]
    seed: int
    version: int = STREAM_VERSION

    def __post_init__(self):
        arr = np.ascontiguousarray(np.asarray(self.arrivals, dtype=np.float64))
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("TraceStream needs a non-empty 1-D arrival vector")
        if np.any(np.diff(arr) < 0):
            raise ValueError("TraceStream arrivals must be sorted ascending")
        jid = np.ascontiguousarray(np.asarray(self.job_ids, dtype=np.int64))
        if jid.shape != arr.shape:
            raise ValueError("TraceStream job_ids must match arrivals in shape")
        if not self.sources:
            raise ValueError("TraceStream needs at least one source TraceJob")
        if jid.min() < 0 or jid.max() >= len(self.sources):
            raise ValueError("TraceStream job_ids index outside sources")
        object.__setattr__(self, "arrivals", arr)
        object.__setattr__(self, "job_ids", jid)
        # concatenated per-source sorted samples + offsets: one gather serves
        # every ECDF inverse draw of a slab
        sizes = np.array([s.n_tasks for s in self.sources], dtype=np.int64)
        off = np.zeros(len(self.sources), dtype=np.int64)
        np.cumsum(sizes[:-1], out=off[1:])
        flat = np.concatenate(
            [np.sort(np.asarray(s.task_times, dtype=np.float64)) for s in self.sources]
        )
        object.__setattr__(self, "_sizes", sizes)
        object.__setattr__(self, "_off", off)
        object.__setattr__(self, "_flat", flat)

    @property
    def n_jobs(self) -> int:
        """Stream length in jobs."""
        return int(self.arrivals.size)

    @property
    def n_tasks(self) -> np.ndarray:
        """Per-arrival task count: the source job's recorded task count."""
        return self._sizes[self.job_ids]

    def slabs(self, slab: int | None):
        """Yield ``(lo, hi)`` index ranges covering the stream in order."""
        n = self.n_jobs
        slab = n if slab is None else int(slab)
        if slab <= 0:
            raise ValueError(f"slab must be positive, got {slab}")
        for lo in range(0, n, slab):
            yield lo, min(lo + slab, n)

    def make_rng(self, rep: int) -> np.random.Generator:
        """The rep's draw stream, derived from (seed, version, rep)."""
        return np.random.default_rng(
            np.random.SeedSequence((int(self.seed), int(self.version), int(rep)))
        )

    def sample_slab(self, rng: np.random.Generator, lo: int, hi: int, n_slots: int):
        """ECDF-inverse service draws for jobs ``[lo, hi)``: (hi-lo, n_slots).

        Row ``i`` draws ``n_slots`` iid samples from the empirical
        distribution of source job ``job_ids[lo + i]`` -- the inverse-CDF
        transform on its sorted task times.  Exactly ``(hi-lo) * n_slots``
        uniforms are consumed, row-major, so slab partitioning never changes
        which uniform lands on which (job, slot) pair.
        """
        jid = self.job_ids[lo:hi]
        u = rng.random((hi - lo, int(n_slots)))
        m = self._sizes[jid][:, None]
        idx = np.minimum((u * m).astype(np.int64), m - 1)
        return self._flat[self._off[jid][:, None] + idx]


def poisson_stream(
    sources,
    arrival_rate: float,
    n_jobs: int,
    seed: int = 0,
) -> TraceStream:
    """A Poisson-arrival :class:`TraceStream` over the given source jobs.

    Inter-arrival gaps are iid Exponential(``arrival_rate``) and each
    arrival resamples one source job chosen uniformly -- the offered-load
    model :meth:`repro.core.planner.RedundancyPlanner.plan_slo` evaluates
    SLO candidates under.  Fully determined by ``(seed, STREAM_VERSION)``
    and the sources, like every stream.

    ``sources`` are :class:`TraceJob` objects; wrap a parametric
    service-time model via its sampled task times, e.g.
    ``TraceJob("exp", "exponential", dist.sample_np(rng, (4000,)))``.
    """
    sources = tuple(sources)
    if not sources:
        raise ValueError("poisson_stream needs at least one source TraceJob")
    if not (arrival_rate > 0.0):
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    rng = np.random.default_rng(
        np.random.SeedSequence((int(seed), STREAM_VERSION, 0x510))
    )
    gaps = rng.exponential(scale=1.0 / float(arrival_rate), size=int(n_jobs))
    arrivals = np.cumsum(gaps)
    job_ids = rng.integers(0, len(sources), size=int(n_jobs))
    return TraceStream(arrivals=arrivals, job_ids=job_ids, sources=sources, seed=seed)

