"""Closed-form compute-time analysis (§IV and §VI of the paper).

A numpy copy of ``repro.core.analysis``: the port never imports the JAX
package, and these formulas must stay bit-exact to it.

All formulas are for the *balanced assignment of non-overlapping batches*
(shown optimal in Thms 1-2), under the size-dependent service model of §VI:
a batch of ``N/B`` tasks at one worker takes ``(N/B) * tau``, each of the
``N/B`` workers hosting a batch is i.i.d., and the job time is

    T = max_{i in 1..B} min_{j in 1..N/B} T_ij.

Implemented results:

  * ``H(B)``, ``H2(B)``          -- harmonic numbers (first / second order)
  * Exponential:      E[T] (Thm 3, Eq. 26), CoV (Lemma 4, Eq. 18)
  * Shifted-Exp:      E[T] (Thm 5, Eq. 19/33), CoV (Lemma 5, Eq. 21),
                      regime boundaries (Thm 6), B* approx (Cor 2),
                      CoV end-point rules (Thm 7 / Cor 3)
  * Pareto:           E[T] (Thm 8, Eq. 22/61), CoV (Lemma 6, Eq. 24),
                      alpha* root of Eq. (23) (Thm 9), CoV monotone (Thm 10)

Everything is scalar/numpy math (the planner calls these thousands of times;
no jit needed).  Gamma ratios use ``math.lgamma`` for stability at large B.
"""
from __future__ import annotations

import math
from typing import Iterable, List

import numpy as np

from .service_time import Exponential, Pareto, ServiceTime, ShiftedExponential

# --------------------------------------------------------------------------
# harmonic numbers
# --------------------------------------------------------------------------


def harmonic(n: int, order: int = 1) -> float:
    """H_{(n,order)} = sum_{k=1..n} 1/k^order  (paper's H_{(B,1)}, H_{(B,2)})."""
    if n < 0:
        raise ValueError("n must be >= 0")
    return float(sum(1.0 / k**order for k in range(1, n + 1)))


def feasible_B(n_workers: int) -> List[int]:
    """F_B: the feasible redundancy levels, B | N (paper §II-C)."""
    return [b for b in range(1, n_workers + 1) if n_workers % b == 0]


def divisor_table(n: int) -> np.ndarray:
    """Rows m = 0..n of ``feasible_B(m)``, zero-padded to a rectangle.

    The in-scan replanner of ``repro.cluster.epoch_scan`` indexes this by the
    (traced) alive-worker count to re-pick B without leaving the device.
    """
    divs = [feasible_B(m) for m in range(n + 1)]
    width = max((len(d) for d in divs), default=1)
    tab = np.zeros((n + 1, max(width, 1)), dtype=np.int32)
    for m, d in enumerate(divs):
        tab[m, : len(d)] = d
    return tab


def harmonic_tables(n: int) -> tuple:
    """(H_{(k,1)}, H_{(k,2)}) for k = 0..n as arrays (closed forms on device)."""
    h1 = np.zeros(n + 1)
    h2 = np.zeros(n + 1)
    for k in range(1, n + 1):
        h1[k] = h1[k - 1] + 1.0 / k
        h2[k] = h2[k - 1] + 1.0 / k**2
    return h1, h2


# --------------------------------------------------------------------------
# Exponential tasks  (§VI-A)
# --------------------------------------------------------------------------


def exp_mean_T(n: int, b: int, mu: float) -> float:
    """E[T] = H_B / mu  (Eq. 26).  Independent of N under the size model."""
    del n
    return harmonic(b) / mu


def exp_cov_T(b: int) -> float:
    """CoV[T] = sqrt(H_{B,2}) / H_{B,1}  (Lemma 4, Eq. 18)."""
    return math.sqrt(harmonic(b, 2)) / harmonic(b)


# --------------------------------------------------------------------------
# Shifted-exponential tasks  (§VI-B)
# --------------------------------------------------------------------------


def sexp_mean_T(n: int, b: int, delta: float, mu: float) -> float:
    """E[T] = N*delta/B + H_B/mu  (Thm 5, Eq. 33)."""
    return n * delta / b + harmonic(b) / mu


def sexp_cov_T(n: int, b: int, delta: float, mu: float) -> float:
    """CoV[T] = sqrt(H_{B,2}) / (N*delta*mu/B + H_{B,1})  (Lemma 5, Eq. 21)."""
    return math.sqrt(harmonic(b, 2)) / (n * delta * mu / b + harmonic(b))


def sexp_mean_regime(n: int, delta: float, mu: float) -> str:
    """Thm 6 regimes for the E[T]-optimal operating point.

    Returns one of 'full_diversity' | 'middle' | 'full_parallelism'.
    """
    dm = delta * mu
    lo = 1.0 / n
    hi = harmonic(n) - harmonic(n // 2)  # sum_{k=N/2+1}^{N} 1/k
    if dm < lo:
        return "full_diversity"
    if dm > hi:
        return "full_parallelism"
    return "middle"


def sexp_B_star_approx(n: int, delta: float, mu: float) -> float:
    """Cor 2: in the middle regime the continuous optimum is B ~= N*delta*mu."""
    return n * delta * mu


def sexp_cov_regime(n: int, delta: float, mu: float) -> str:
    """Thm 7 / Cor 3 regimes for the CoV-optimal operating point."""
    dm = delta * mu
    lo = 3.0 / ((math.sqrt(5.0) - 1.0) * n)
    h_n1, h_n2 = harmonic(n), harmonic(n, 2)
    h_h1, h_h2 = harmonic(n // 2), harmonic(n // 2, 2)
    hi = (h_n1 * math.sqrt(h_h2) - h_h1 * math.sqrt(h_n2)) / (
        2.0 * math.sqrt(h_n2) - math.sqrt(h_h2)
    )
    if dm < lo:
        return "full_parallelism"
    if dm > hi:
        return "full_diversity"
    # Middle band: minimum at one of the two ends (Thm 7); Cor 3 tie-break.
    # NOTE the paper prints the threshold with ambiguous parenthesization and
    # its Fig.-8 commentary swaps the directions; deriving from the Thm 7
    # proof (CoV(B=1)=1/(N d mu) vs CoV(B=N)) gives
    #     dm* = H_{N,1} / (N sqrt(H_{N,2}) - 1)
    # with full *parallelism* below dm* and full *diversity* above -- this
    # matches exact evaluation of Lemma 5 (see tests + EXPERIMENTS.md note).
    thr = h_n1 / (n * math.sqrt(h_n2) - 1.0)
    return "full_parallelism" if dm < thr else "full_diversity"


# --------------------------------------------------------------------------
# Pareto tasks  (§VI-C)
# --------------------------------------------------------------------------


def _lgamma_ratio(a: float, b: float) -> float:
    """log( Gamma(a) / Gamma(b) )."""
    return math.lgamma(a) - math.lgamma(b)


def pareto_mean_T(n: int, b: int, sigma: float, alpha: float) -> float:
    """E[T] = (N sigma / B) * Gamma(B+1) Gamma(1 - B/(N alpha)) / Gamma(B+1 - B/(N alpha)).

    (Thm 8, Eq. 22/61.)  Finite iff B/(N alpha) < 1, i.e. the max order
    statistic of Pareto(N sigma/B, N alpha/B) has a mean.
    """
    x = b / (n * alpha)
    if x >= 1.0:
        return math.inf
    lg = _lgamma_ratio(b + 1.0, b + 1.0 - x) + math.lgamma(1.0 - x)
    return (n * sigma / b) * math.exp(lg)


def pareto_var_T(n: int, b: int, sigma: float, alpha: float) -> float:
    """Var[T] from Eq. (76)."""
    x = b / (n * alpha)
    if 2.0 * x >= 1.0:
        return math.inf
    s = n * sigma / b
    e2 = s**2 * math.exp(_lgamma_ratio(b + 1.0, b + 1.0 - 2.0 * x) + math.lgamma(1.0 - 2.0 * x))
    m = pareto_mean_T(n, b, sigma, alpha)
    return e2 - m**2


def pareto_cov_T(n: int, b: int, alpha: float) -> float:
    """CoV[T] for Pareto tasks -- scale-free (sigma drops out).

    NOTE: the paper's printed Lemma 6 (Eq. 24) drops a Gamma(B+1) factor and a
    power of Gamma(1-x): at B=1 it disagrees with the CoV of a plain Pareto
    maximum (and with Monte-Carlo).  Re-deriving from the paper's own Eq. (75)
    gives, with x = B/(N alpha):

        CoV^2 = Gamma(1-2x) Gamma(B+1-x)^2
                / ( Gamma(B+1) Gamma(B+1-2x) Gamma(1-x)^2 )  -  1

    which reduces to Var/E^2 of Pareto(N sigma/B, N alpha/B) at B=1 and
    matches MC for all B (see tests).  Thm 10's conclusion (CoV minimized at
    full diversity) still holds for the corrected form.
    """
    x = b / (n * alpha)
    if 2.0 * x >= 1.0:
        return math.inf
    log_q = (
        math.lgamma(1.0 - 2.0 * x)
        + 2.0 * math.lgamma(b + 1.0 - x)
        - math.lgamma(b + 1.0)
        - math.lgamma(b + 1.0 - 2.0 * x)
        - 2.0 * math.lgamma(1.0 - x)
    )
    ratio = math.exp(log_q)
    # numerical guard: ratio >= 1 mathematically
    return math.sqrt(max(ratio - 1.0, 0.0))


def pareto_alpha_star(n: int) -> float:
    """alpha*: the root of Eq. (23); full parallelism is E[T]-optimal iff alpha >= alpha*.

        (4a^2 + (a-1)^2)/(2a(a-1)) - sqrt(pi) N^{-1/2a} 2^{1+1/2a} - 0.58 = 0
    """

    def f(a: float) -> float:
        lhs = (4.0 * a**2 + (a - 1.0) ** 2) / (2.0 * a * (a - 1.0))
        rhs = math.sqrt(math.pi) * n ** (-1.0 / (2.0 * a)) * 2.0 ** (1.0 + 1.0 / (2.0 * a))
        return lhs - rhs - 0.58

    # f is decreasing-then... : paper shows LHS increasing, RHS decreasing in
    # alpha for alpha > 1, so f has a single sign change; bisect on (1+eps, 64).
    lo, hi = 1.0 + 1e-6, 64.0
    flo, fhi = f(lo), f(hi)
    if flo > 0.0 and fhi > 0.0:
        return lo  # always-parallel regime
    if flo < 0.0 and fhi < 0.0:
        return hi
    # f(lo) may be huge positive (pole at a=1): the equation's relevant root has
    # f < 0 below alpha* and f > 0 above it in the paper's convention -- detect
    # orientation from which end is negative.
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if (f(mid) > 0.0) == (fhi > 0.0):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


# --------------------------------------------------------------------------
# generic dispatch + argmin over feasible B
# --------------------------------------------------------------------------


def mean_T(dist: ServiceTime, n: int, b: int) -> float:
    """Closed-form E[T] for balanced non-overlapping batches, size model (§VI)."""
    if isinstance(dist, Exponential):
        return exp_mean_T(n, b, dist.mu)
    if isinstance(dist, ShiftedExponential):
        return sexp_mean_T(n, b, dist.delta, dist.mu)
    if isinstance(dist, Pareto):
        return pareto_mean_T(n, b, dist.sigma, dist.alpha)
    raise TypeError(f"no closed form for {type(dist).__name__}")


def cov_T(dist: ServiceTime, n: int, b: int) -> float:
    """Closed-form CoV of job time T(n, b) for the parametric families."""
    if isinstance(dist, Exponential):
        return exp_cov_T(b)
    if isinstance(dist, ShiftedExponential):
        return sexp_cov_T(n, b, dist.delta, dist.mu)
    if isinstance(dist, Pareto):
        return pareto_cov_T(n, b, dist.alpha)
    raise TypeError(f"no closed form for {type(dist).__name__}")


def argmin_B(
    dist: ServiceTime, n: int, metric: str = "mean", candidates: Iterable[int] | None = None
) -> int:
    """Discrete argmin over feasible B of E[T] or CoV[T] (Thms 5/8 optimizations)."""
    cands = list(candidates) if candidates is not None else feasible_B(n)
    fn = mean_T if metric == "mean" else cov_T
    vals = [fn(dist, n, b) for b in cands]
    return int(cands[int(np.argmin(vals))])


# --------------------------------------------------------------------------
# §IV batch-level model (no size scaling): sanity forms used in tests
# --------------------------------------------------------------------------


def batch_model_exp_mean_T(assignment_counts: Iterable[int], mu: float, n_mc: int = 0) -> float:
    """E[max_i Exp(N_i mu)] for a general assignment vector (used to verify
    Lemma 2/3 orderings).  Uses the exact inclusion-exclusion for the max of
    independent (non-identical) exponentials.
    """
    counts = list(assignment_counts)
    rates = [c * mu for c in counts]
    bsz = len(rates)
    # E[max] = sum over non-empty subsets S of (-1)^{|S|+1} / sum_{i in S} rate_i
    total = 0.0
    for mask in range(1, 1 << bsz):
        rsum = 0.0
        bits = 0
        for i in range(bsz):
            if mask >> i & 1:
                rsum += rates[i]
                bits += 1
        total += (-1.0) ** (bits + 1) / rsum
    return total
