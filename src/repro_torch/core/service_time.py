"""Service-time models from §II-D of the paper (port of ``repro.core.service_time``).

Three families, all "stochastically decreasing and convex" in the sense the
paper needs for the majorization results:

  * ``Exp(mu)``              -- memoryless baseline (Eq. 3)
  * ``SExp(delta, mu)``      -- shifted exponential, minimum service time delta (Eq. 4)
  * ``Pareto(sigma, alpha)`` -- heavy tail, scale sigma / shape alpha (Eq. 5)

plus ``Empirical`` (resampling trace observations, §VII).

The closed forms (``ccdf``, ``mean``, ``var``, ``scaled_by``, :func:`min_of`)
and the host sampler ``sample_np`` are numpy and bit-exact to the reference
given the same ``numpy.random.Generator``.  ``sample`` draws on a torch device
from an explicit ``torch.Generator``; torch cannot reproduce ``jax.random``
streams, so the device samplers agree with the reference in law only.
``philox_law`` names the law to the frontier's counter-based stream
(:mod:`repro_torch.kernels.philox`), which the cover kernel draws itself.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import philox

__all__ = [
    "ServiceTime",
    "Exponential",
    "ShiftedExponential",
    "Pareto",
    "Empirical",
    "min_of",
    "from_spec",
]


@dataclasses.dataclass(frozen=True)
class ServiceTime:
    """Base class: a positive random variable with a CCDF and samplers."""

    def ccdf(self, t):
        """Survival function ``P[tau > t]``."""
        raise NotImplementedError

    def mean(self) -> float:
        """Expected service time ``E[tau]``."""
        raise NotImplementedError

    def var(self) -> float:
        """Service-time variance ``Var[tau]``."""
        raise NotImplementedError

    def sample(
        self, generator: torch.Generator, shape: tuple, device, dtype: torch.dtype
    ) -> torch.Tensor:
        """Draw ``shape`` service times on ``device`` from ``generator``."""
        raise NotImplementedError

    def sample_np(self, rng: np.random.Generator, shape: tuple) -> np.ndarray:
        """Draw ``shape`` service times on host (planning paths)."""
        raise NotImplementedError

    def scaled_by(self, s: float) -> "ServiceTime":
        """Distribution of ``s * tau`` (size-dependent batch model, §VI)."""
        raise NotImplementedError

    def philox_law(self) -> tuple[int, tuple[float, float], tuple | None]:
        """``(code, (a, b), table)``: the law as the Philox sampler draws it.

        ``code`` is one of :mod:`repro_torch.kernels.philox`'s law codes,
        ``(a, b)`` the constants of its transform of a uniform ``u`` and
        ``table`` the entries an empirical law resamples (else ``None``).
        """
        raise NotImplementedError

    def cov(self) -> float:
        """Coefficient of variation ``sqrt(Var)/E`` -- the §V spread metric."""
        m = self.mean()
        return math.sqrt(self.var()) / m


def _uniform(generator, shape, device, dtype) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def _exponential(generator, shape, device, dtype, rate: float) -> torch.Tensor:
    """Exponential draws ``-log1p(-u) / rate`` with ``u ~ U[0, 1)``.

    The construction of ``jax.random.exponential``, computed in place: a
    frontier's draws are gigabytes, and every sampler below transforms its
    one buffer rather than allocating a tensor per arithmetic step.  Dividing
    by ``-rate`` folds the negation into the division, bit for bit.
    """
    return _uniform(generator, shape, device, dtype).neg_().log1p_().div_(-rate)


@dataclasses.dataclass(frozen=True)
class Exponential(ServiceTime):
    """Exponential service times ``Exp(mu)`` -- the paper's light-tail model."""

    mu: float  # rate

    def ccdf(self, t):
        """Survival function ``P[tau > t]``."""
        t = np.asarray(t)
        return np.where(t >= 0.0, np.exp(-self.mu * t), 1.0)

    def mean(self):
        """Expected service time ``E[tau]``."""
        return 1.0 / self.mu

    def var(self):
        """Service-time variance ``Var[tau]``."""
        return 1.0 / self.mu**2

    def sample(self, generator, shape, device, dtype):
        """Draw ``shape`` service times on ``device`` from ``generator``."""
        return _exponential(generator, shape, device, dtype, self.mu)

    def sample_np(self, rng, shape):
        """Draw ``shape`` service times on host (planning paths)."""
        return rng.exponential(scale=1.0 / self.mu, size=shape)

    def scaled_by(self, s):
        """Distribution of ``s * tau`` (size-dependent batch model, §VI)."""
        # s * Exp(mu) ~ Exp(mu / s)
        return Exponential(mu=self.mu / s)

    def philox_law(self):
        """``log1p(-u) / (-mu)``, as :meth:`sample` computes it."""
        return philox.EXPONENTIAL, (-self.mu, 0.0), None


@dataclasses.dataclass(frozen=True)
class ShiftedExponential(ServiceTime):
    """Shifted exponential ``delta + Exp(mu)``: a hard floor plus memoryless tail."""

    delta: float  # minimum service time (shift)
    mu: float  # rate of the random part

    def ccdf(self, t):
        """Survival function ``P[tau > t]``."""
        t = np.asarray(t)
        return np.where(t >= self.delta, np.exp(-self.mu * (t - self.delta)), 1.0)

    def mean(self):
        """Expected service time ``E[tau]``."""
        return self.delta + 1.0 / self.mu

    def var(self):
        """Service-time variance ``Var[tau]``."""
        return 1.0 / self.mu**2

    def sample(self, generator, shape, device, dtype):
        """Draw ``shape`` service times on ``device`` from ``generator``."""
        return _exponential(generator, shape, device, dtype, self.mu).add_(self.delta)

    def sample_np(self, rng, shape):
        """Draw ``shape`` service times on host (planning paths)."""
        return self.delta + rng.exponential(scale=1.0 / self.mu, size=shape)

    def scaled_by(self, s):
        """Distribution of ``s * tau`` (size-dependent batch model, §VI)."""
        # s * SExp(delta, mu) ~ SExp(s * delta, mu / s)
        return ShiftedExponential(delta=self.delta * s, mu=self.mu / s)

    def philox_law(self):
        """``log1p(-u) / (-mu) + delta``, as :meth:`sample` computes it."""
        return philox.SHIFTED_EXPONENTIAL, (-self.mu, self.delta), None


@dataclasses.dataclass(frozen=True)
class Pareto(ServiceTime):
    """Pareto service times -- the paper's heavy-tail straggler model."""

    sigma: float  # scale (minimum value)
    alpha: float  # shape (tail index); mean finite iff alpha > 1

    def ccdf(self, t):
        """Survival function ``P[tau > t]``."""
        t = np.asarray(t)
        return np.where(t >= self.sigma, (t / self.sigma) ** (-self.alpha), 1.0)

    def mean(self):
        """Expected service time ``E[tau]``."""
        if self.alpha <= 1.0:
            return math.inf
        return self.alpha * self.sigma / (self.alpha - 1.0)

    def var(self):
        """Service-time variance ``Var[tau]``."""
        if self.alpha <= 2.0:
            return math.inf
        a = self.alpha
        return self.sigma**2 * a / ((a - 1.0) ** 2 * (a - 2.0))

    def sample(self, generator, shape, device, dtype):
        """Draw ``shape`` service times on ``device`` from ``generator``."""
        # torch.rand is [0, 1); 1 - u lies in (0, 1] (its least value is one
        # ulp of 1, far above finfo.tiny), so u ** (-1/alpha) stays finite
        u = _uniform(generator, shape, device, dtype).neg_().add_(1.0)
        return u.pow_(-1.0 / self.alpha).mul_(self.sigma)

    def sample_np(self, rng, shape):
        """Draw ``shape`` service times on host (planning paths)."""
        u = rng.uniform(low=np.finfo(np.float64).tiny, high=1.0, size=shape)
        return self.sigma * u ** (-1.0 / self.alpha)

    def scaled_by(self, s):
        """Distribution of ``s * tau`` (size-dependent batch model, §VI)."""
        # s * Pareto(sigma, alpha) ~ Pareto(s * sigma, alpha)  (alpha unchanged)
        return Pareto(sigma=self.sigma * s, alpha=self.alpha)

    def philox_law(self):
        """``(1 - u) ** (-1 / alpha) * sigma``, as :meth:`sample` computes it."""
        return philox.PARETO, (-1.0 / self.alpha, self.sigma), None


@dataclasses.dataclass(frozen=True)
class Empirical(ServiceTime):
    """Trace-driven service time: resample (with replacement) from observations.

    ``samples`` is a tuple so the dataclass stays hashable; the paper's §VII
    experiments draw task service times straight from the Google-trace-derived
    per-job datasets, which is exactly this.
    """

    samples: tuple

    def _arr(self):
        return np.asarray(self.samples, dtype=np.float64)

    def ccdf(self, t):
        """Survival function ``P[tau > t]``."""
        s = self._arr()
        t = np.asarray(t, dtype=np.float64)
        # P(X > t) estimated from the empirical distribution.
        return (s[None, ...] > np.expand_dims(t, -1)).mean(axis=-1)

    def mean(self):
        """Expected service time ``E[tau]``."""
        return float(self._arr().mean())

    def var(self):
        """Service-time variance ``Var[tau]``."""
        return float(self._arr().var())

    def sample(self, generator, shape, device, dtype):
        """Draw ``shape`` service times on ``device`` from ``generator``."""
        s = torch.as_tensor(self._arr(), dtype=dtype, device=device)
        # int32 indices: half the bytes of the default int64 for the same draw
        idx = torch.randint(
            0, s.shape[0], (math.prod(shape),), generator=generator, device=device,
            dtype=torch.int32,
        )
        return s.index_select(0, idx).view(shape)

    def sample_np(self, rng, shape):
        """Draw ``shape`` service times on host (planning paths)."""
        s = self._arr()
        return rng.choice(s, size=shape, replace=True)

    def scaled_by(self, s):
        """Distribution of ``s * tau`` (size-dependent batch model, §VI)."""
        return Empirical(samples=tuple(float(x) * s for x in self.samples))

    def philox_law(self):
        """The observations, resampled by index."""
        return philox.EMPIRICAL, (0.0, 0.0), tuple(float(x) for x in self.samples)


def min_of(dist: ServiceTime, n: int) -> ServiceTime:
    """Distribution of min of n i.i.d. draws, where closed under the family.

    Used in §IV: the compute time of a batch hosted by n workers is the first
    order statistic.  Exp(mu) -> Exp(n mu); SExp(d, mu) -> SExp(d, n mu);
    Pareto(s, a) -> Pareto(s, n a).
    """
    if isinstance(dist, Exponential):
        return Exponential(mu=dist.mu * n)
    if isinstance(dist, ShiftedExponential):
        return ShiftedExponential(delta=dist.delta, mu=dist.mu * n)
    if isinstance(dist, Pareto):
        return Pareto(sigma=dist.sigma, alpha=dist.alpha * n)
    raise TypeError(f"min_of not closed for {type(dist).__name__}")


DISTRIBUTIONS = {
    cls.__name__: cls for cls in (Exponential, ShiftedExponential, Pareto, Empirical)
}


def from_spec(kind: str, fields: dict) -> ServiceTime:
    """Rebuild a distribution from its class name and dataclass fields.

    ``from_spec(type(d).__name__, dataclasses.asdict(d))`` carries a
    distribution of either package across to this one (``samples`` may
    arrive as a list, as it does from JSON).
    """
    if kind not in DISTRIBUTIONS:
        raise ValueError(
            f"unknown distribution kind {kind!r} (expected one of {sorted(DISTRIBUTIONS)})"
        )
    fields = dict(fields)
    if "samples" in fields:
        fields["samples"] = tuple(fields["samples"])
    return DISTRIBUTIONS[kind](**fields)
