"""The port's service-time laws against the reference.

Closed forms and the host sampler ``sample_np`` are numpy in both packages
and must agree exactly; the torch samplers cannot reproduce ``jax.random``
streams, so they are held to the law itself at 3 sigma.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.service_time as ref  # noqa: E402
import repro_torch.core.service_time as port  # noqa: E402

SPECS = [
    ("Exponential", {"mu": 1.7}),
    ("ShiftedExponential", {"delta": 0.4, "mu": 2.5}),
    ("Pareto", {"sigma": 1.3, "alpha": 1.8}),
    ("Empirical", {"samples": (0.5, 1.25, 1.25, 3.0, 9.5)}),
]
IDS = [kind for kind, _ in SPECS]


def _pair(kind, fields):
    return getattr(ref, kind)(**fields), getattr(port, kind)(**fields)


@pytest.mark.parametrize("kind,fields", SPECS, ids=IDS)
def test_closed_forms_exact(kind, fields):
    r, p = _pair(kind, fields)
    t = np.array([-1.0, 0.0, 0.3, 0.4, 1.0, 1.3, 2.0, 9.5, 50.0])
    np.testing.assert_array_equal(p.ccdf(t), np.asarray(r.ccdf(t)))
    assert (p.mean(), p.var(), p.cov()) == (r.mean(), r.var(), r.cov())
    assert dataclasses.asdict(p.scaled_by(2.5)) == dataclasses.asdict(r.scaled_by(2.5))
    if kind == "Empirical":
        with pytest.raises(TypeError):
            port.min_of(p, 3)
    else:
        assert dataclasses.asdict(port.min_of(p, 3)) == dataclasses.asdict(ref.min_of(r, 3))


@pytest.mark.parametrize("kind,fields", SPECS, ids=IDS)
def test_sample_np_exact(kind, fields):
    r, p = _pair(kind, fields)
    got = p.sample_np(np.random.default_rng(11), (64, 3))
    want = r.sample_np(np.random.default_rng(11), (64, 3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,fields", SPECS, ids=IDS)
def test_from_spec_round_trips(kind, fields):
    r, p = _pair(kind, fields)
    got = port.from_spec(type(r).__name__, dataclasses.asdict(r))
    assert got == p and type(got) is type(p)
    assert port.from_spec(kind, dataclasses.asdict(got)) == got
    with pytest.raises(ValueError, match="unknown distribution"):
        port.from_spec("Weibull", {})


def _draw(dist, n=200_000, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return dist.sample(gen, (n,), "cpu", dtype).double().numpy()


@pytest.mark.parametrize(
    "dist",
    [
        port.Exponential(mu=2.0),
        port.ShiftedExponential(delta=1.5, mu=0.5),
        port.Pareto(sigma=1.0, alpha=4.5),
        port.Empirical(samples=(0.5, 1.25, 1.25, 3.0, 9.5)),
    ],
    ids=["exp", "sexp", "pareto-4.5", "empirical"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_torch_sampler_moments_3_sigma(dist, dtype):
    x = _draw(dist, dtype=dtype)
    n = x.size
    assert x.dtype == np.float64 and np.isfinite(x).all()
    assert abs(x.mean() - dist.mean()) <= 3 * math.sqrt(dist.var() / n)
    # the sample variance's own spread: sqrt((mu4 - sigma^4) / n), mu4 estimated
    mu4 = float(((x - x.mean()) ** 4).mean())
    assert abs(x.var() - dist.var()) <= 3 * math.sqrt((mu4 - x.var() ** 2) / n)


@pytest.mark.parametrize("alpha", [0.8, 1.5, 2.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_torch_pareto_quantiles_3_sigma(alpha, dtype):
    """Infinite variance (alpha <= 2): hold the median and p90 instead of moments.

    The share of draws below the true p-quantile is binomial, so it lies
    within 3 * sqrt(p (1 - p) / n) of p.
    """
    dist = port.Pareto(sigma=2.0, alpha=alpha)
    x = _draw(dist, dtype=dtype, seed=1)
    assert np.isfinite(x).all() and (x >= dist.sigma * (1 - 1e-6)).all()
    for p in (0.5, 0.9):
        q = dist.sigma * (1.0 - p) ** (-1.0 / alpha)
        assert abs((x <= q).mean() - p) <= 3 * math.sqrt(p * (1 - p) / x.size)


def test_torch_empirical_draws_only_observed_values():
    dist = port.Empirical(samples=(0.5, 1.25, 3.0))
    x = _draw(dist, n=1000)
    assert set(np.unique(x)) == {0.5, 1.25, 3.0}
