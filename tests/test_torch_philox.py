"""The frontier's counter-based Philox stream and the plain version of the
fused sample-and-cover kernel, on the CPU.

``repro_torch.kernels.philox`` is the plain version of ``csrc/philox.cuh``;
Random123's known-answer vectors pin the generator, and the tests below pin
what is built on it: the uniforms, each law's transform in the order the
torch samplers compute it, the counter layout (a rep's row does not depend on
the range of reps a call covers) and ``frontier_sample_cover_ref`` as
``frontier_cover_ref`` of the plain Philox draws.  Run alone with:

    PYTHONPATH=src python -m pytest tests/test_torch_philox.py -q
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

from repro_torch.core import service_time as st  # noqa: E402
from repro_torch.core import traces  # noqa: E402
from repro_torch.kernels import cover, philox  # noqa: E402

JOB6 = next(j for j in traces.synthetic_google_jobs() if j.name == "job6").task_times
LAWS = {
    "exp": st.Exponential(mu=1.3),
    "sexp": st.ShiftedExponential(delta=0.2, mu=0.8),
    "pareto": st.Pareto(sigma=1.0, alpha=1.5),
    "job6": st.Empirical(samples=tuple(JOB6)),
}
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zero", "ones", "pi"],
)
def test_philox4x32_10_known_answers(ctr, key, want):
    got = philox.philox4x32_10(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_is_the_exact_64_bit_product():
    rng = np.random.default_rng(0)
    a = np.concatenate([[0, 1, 0xFFFFFFFF, 0x80000000], rng.integers(0, 2**32, 1000)])
    for m in (philox._M0, philox._M1, 0xFFFFFFFF, 1):
        hi, lo = philox._mulhilo(torch.as_tensor(a, dtype=torch.int64), m)
        want = [int(x) * m for x in a]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & 0xFFFFFFFF for w in want]


def test_key_splits_the_seed_into_two_words():
    assert philox.key_of(0) == (0, 0)
    assert philox.key_of(2**32 + 5) == (5, 1)
    assert philox.key_of(-1) == (0xFFFFFFFF, 0xFFFFFFFF)


def test_stream_words_are_the_counter_layout():
    words = philox.stream_words(seed=2**33 + 7, n_cand=3, rep0=10, n_reps=4, n_counters=5)
    assert all(w.shape == (3, 4, 5) for w in words)
    for c, s, q in [(0, 0, 0), (2, 3, 4), (1, 2, 3)]:
        want = philox.philox4x32_10((q, 10 + s, c, 0), (7, 2))
        assert [int(w[c, s, q]) for w in words] == [int(w) for w in want]
    with pytest.raises(ValueError):
        philox.stream_words(0, 1, 2**32 - 1, 2, 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_uniform_construction_lies_in_unit_interval(dtype):
    edge = tuple(torch.tensor([[0, 0xFFFFFFFF, 0x1FF, 0x200]]) for _ in range(4))
    u = philox.uniforms(edge, dtype, 16 if dtype == torch.float32 else 8)
    assert u.dtype == dtype and float(u.min()) == 0.0 and float(u.max()) < 1.0
    top = 1.0 - 2.0**-23 if dtype == torch.float32 else 1.0 - 2.0**-52
    assert float(u.max()) == top
    # the float32 bits are jax.random.uniform's: 23 mantissa bits under 1.0
    w = np.array([0, 1 << 9, 0xDEADBEEF], dtype=np.uint32)
    want = ((w >> 9) | 0x3F800000).view(np.float32) - np.float32(1.0)
    got = philox.uniforms(tuple(torch.as_tensor(w.astype(np.int64)) for _ in range(4)),
                          torch.float32, 12)
    np.testing.assert_array_equal(got.numpy()[0::4], want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_uniforms_pass_a_ks_test(dtype):
    words = philox.stream_words(seed=11, n_cand=1, rep0=0, n_reps=100, n_counters=250)
    per = philox.draws_per_counter(philox.EXPONENTIAL, dtype)
    u = philox.uniforms(words, dtype, 250 * per).flatten().numpy()
    u = u[:100_000] if u.size >= 100_000 else u
    assert u.size >= 50_000
    assert stats.kstest(u, "uniform").pvalue > 1e-3
    assert u.min() >= 0.0 and u.max() < 1.0


@pytest.mark.parametrize("name", sorted(LAWS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_transform_is_the_torch_samplers_arithmetic(name, dtype):
    dist = LAWS[name]
    code, consts, table = dist.philox_law()
    words = philox.stream_words(seed=3, n_cand=1, rep0=0, n_reps=64, n_counters=16)
    if code == philox.EMPIRICAL:
        w = torch.stack(words, -1).flatten(-2)
        got = philox.transform(code, consts, table, w, dtype)
        tab = torch.as_tensor(dist.samples, dtype=dtype)
        assert torch.equal(got, tab[(w * len(dist.samples)) >> 32])
        assert bool(torch.isin(got, tab).all())
        return
    u = philox.uniforms(words, dtype, 16 * philox.draws_per_counter(code, dtype))
    got = philox.transform(code, consts, table, u, dtype)
    if name == "exp":
        want = u.neg().log1p().div(-dist.mu)
    elif name == "sexp":
        want = u.neg().log1p().div(-dist.mu).add(dist.delta)
    else:
        want = u.neg().add_(1.0).pow_(-1.0 / dist.alpha).mul_(dist.sigma)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())


def test_empirical_index_covers_the_table():
    w = torch.tensor([0, 0xFFFFFFFF, 2**31], dtype=torch.int64)
    got = philox.transform(philox.EMPIRICAL, (0.0, 0.0), (1.0, 2.0, 3.0), w, torch.float64)
    assert got.tolist() == [1.0, 3.0, 2.0]


def test_philox_law_names_each_law():
    assert LAWS["exp"].philox_law() == (philox.EXPONENTIAL, (-1.3, 0.0), None)
    assert LAWS["sexp"].philox_law() == (philox.SHIFTED_EXPONENTIAL, (-0.8, 0.2), None)
    assert LAWS["pareto"].philox_law() == (philox.PARETO, (-1.0 / 1.5, 1.0), None)
    code, _, table = LAWS["job6"].philox_law()
    assert code == philox.EMPIRICAL and table == tuple(JOB6)


@pytest.mark.parametrize("name", ["exp", "sexp", "pareto"])
def test_single_draws_follow_the_law_3_sigma(name):
    """b = r = 1 with scale 1 writes the draws themselves."""
    dist = LAWS[name]
    x = cover.frontier_sample_cover_ref(dist, [1], [1], [1.0], 60_000, seed=4,
                                        dtype=torch.float64, device="cpu")[0].numpy()
    if name == "pareto":  # infinite variance: test the median and the tail probability
        med = dist.sigma * 2.0 ** (1.0 / dist.alpha)
        p = (x <= med).mean()
        assert abs(p - 0.5) / math.sqrt(0.25 / x.size) < 3.0
        q = dist.sigma * 10.0 ** (1.0 / dist.alpha)  # P[X > q] = 0.1
        p = (x > q).mean()
        assert abs(p - 0.1) / math.sqrt(0.09 / x.size) < 3.0
    else:
        assert abs(x.mean() - dist.mean()) / math.sqrt(dist.var() / x.size) < 3.0


@pytest.mark.parametrize("name", sorted(LAWS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_sample_cover_ref_is_cover_of_the_plain_draws(name, dtype):
    dist = LAWS[name]
    bs, rs = np.array([1, 2, 3, 6, 4]), np.array([6, 3, 2, 1, 1])
    scales = 6.0 / bs
    got = cover.frontier_sample_cover_ref(dist, bs, rs, scales, 50, seed=9, rep0=3,
                                          dtype=dtype, device="cpu")
    x = philox.draws(dist.philox_law(), 9, len(bs), 3, 50, 6, dtype)
    want = cover.frontier_cover_ref(x, bs, rs, torch.as_tensor(scales, dtype=dtype))
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(LAWS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_rep0_rows_are_the_slice_of_the_full_run(name, dtype):
    dist = LAWS[name]
    bs, rs, sc = [1, 2, 5, 10], [10, 5, 2, 1], [10.0, 5.0, 2.0, 1.0]
    full = cover.frontier_sample_cover(dist, bs, rs, sc, 40, seed=13, dtype=dtype, device="cpu")
    for lo, hi in [(0, 1), (7, 23), (39, 40), (0, 40)]:
        part = cover.frontier_sample_cover(dist, bs, rs, sc, hi - lo, seed=13, rep0=lo,
                                           dtype=dtype, device="cpu")
        assert torch.equal(part, full[:, lo:hi]), (lo, hi)
    other = cover.frontier_sample_cover(dist, bs, rs, sc, 40, seed=14, dtype=dtype, device="cpu")
    assert not torch.equal(other, full)


def test_sample_cover_wrapper_on_the_cpu_counts_nothing_and_checks_its_arguments():
    d = LAWS["exp"]
    before = (cover.launches, cover.philox_launches, cover.draws_launches)
    got = cover.frontier_sample_cover(d, [2], [3], [1.0], 5, seed=1, dtype="float64",
                                      device="cpu")
    assert got.shape == (1, 5) and got.dtype == torch.float64
    assert (cover.launches, cover.philox_launches, cover.draws_launches) == before
    assert cover.frontier_sample_cover(d, [1], [1], [1.0], 0, seed=1, device="cpu").shape == (1, 0)
    for kw in (
        {"bs": [0], "rs": [1]},
        {"bs": [1, 2], "rs": [1]},
        {"scales": [1.0, 2.0]},
        {"rep0": 2**32 - 2},
        {"rep0": -1},
        {"dtype": "float16"},
    ):
        args = {"bs": [1], "rs": [1], "scales": [1.0], "rep0": 0, "dtype": torch.float32} | kw
        with pytest.raises(ValueError):
            cover.frontier_sample_cover(d, args["bs"], args["rs"], args["scales"], 5, seed=1,
                                        rep0=args["rep0"], dtype=args["dtype"], device="cpu")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_frontier_uniforms_on_the_cpu_are_the_plain_stream(dtype):
    got = cover.frontier_uniforms(5, 2, 7, 9, rep0=4, dtype=dtype, device="cpu")
    per = philox.draws_per_counter(philox.EXPONENTIAL, dtype)
    words = philox.stream_words(5, 2, 4, 7, -(-9 // per))
    assert got.shape == (2, 7, 9) and torch.equal(got, philox.uniforms(words, dtype, 9))
