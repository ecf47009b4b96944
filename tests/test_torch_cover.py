"""The port's cover reduction against the reference, bitwise, on injected draws.

Identical numpy draws go through the reference (the Pallas
``masked_cover_times`` in interpret mode, ``gang_cover_times`` and the
vmapped ``_frontier_cover``) and through the port's plain PyTorch versions,
which are what the port's wrappers run on the CPU and what the CUDA kernel is
held against on the card.  The reductions are min/max only and each element
is scaled before the min, so the results must match bit for bit (NaN matched
by position), in float32 and float64.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.cluster.vectorized import _frontier_cover  # noqa: E402
from repro.core.simulator import gang_cover_times as ref_gang  # noqa: E402
from repro.kernels.cover import masked_cover_times as ref_masked  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.kernels import cover  # noqa: E402

DTYPES = ["float32", "float64"]
# (b, r) masks over a padded (6, 4) grid: unmasked, padded, b = 1 and r = 1
MASKS = [(6, 4), (3, 2), (2, 4), (6, 1), (1, 1), (1, 4)]


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got[~nan].view(bits), want[~nan].view(bits))


def _draws(shape, dtype, seed=3, inject=True):
    x = np.random.default_rng(seed).exponential(size=shape).astype(dtype)
    if inject:
        # NaN and inf inside every mask, inside only the widest masks, and
        # in slots every narrow mask excludes
        x[3, 0, 0] = np.nan
        x[5, 5, 3] = np.nan
        x[7, 1, 1] = np.inf
        x[9, :, 0] = np.inf
        x[11, 2, :] = np.inf
        x[13, 4, 2] = -np.inf
    return x


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_cover_matches_pallas_and_gang_bitwise(dtype, x64):
    # 37 reps with block_rows=16: the rep count does not divide the block
    x = _draws((37, 6, 4), dtype)
    for b, r in MASKS:
        want_pallas = ref_masked(jnp.asarray(x), jnp.int32(b), jnp.int32(r), block_rows=16)
        want_gang = ref_gang(jnp.asarray(x), b, r)
        got = cover.masked_cover_times(torch.from_numpy(x), b, r)
        assert_bitwise(got.numpy(), np.asarray(want_pallas))
        assert_bitwise(got.numpy(), np.asarray(want_gang))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gang_cover_times_matches_reference_on_leading_axes(dtype, x64):
    x = _draws((2, 37, 6, 4), dtype, seed=4, inject=False)
    x[1, 3, 2, 1] = np.nan
    for b, r in [(None, None), (4, 3), (1, 1)]:
        got = simulator.gang_cover_times(torch.from_numpy(x), b, r)
        want = ref_gang(jnp.asarray(x), b, r)
        assert got.shape == (2, 37)
        assert_bitwise(got.numpy(), np.asarray(want))


def _frontier_inputs(n_workers, candidates, n_reps, dtype, seed):
    bs = np.asarray(candidates, dtype=np.int32)
    rs = (n_workers // bs).astype(np.int32)
    n_slots = int((bs * rs).max())
    flat = np.random.default_rng(seed).pareto(1.7, size=(len(bs), n_reps, n_slots)) + 1.0
    flat = flat.astype(dtype)
    scales = (n_workers / bs).astype(dtype)
    # the reference's padded gather map (repro/cluster/vectorized.py)
    idx = np.zeros((len(bs), int(bs.max()), int(rs.max())), dtype=np.int32)
    for c, (b, r) in enumerate(zip(bs, rs)):
        idx[c, :b, :r] = np.arange(b * r, dtype=np.int32).reshape(b, r)
    return flat, idx, bs, rs, scales


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "n_workers,candidates",
    [(12, [1, 2, 3, 4, 6, 12]), (10, [1, 3, 4, 10]), (7, [7]), (5, [1])],
    ids=["divisors", "padded-slots", "r1", "b1"],
)
def test_frontier_cover_matches_reference_bitwise(dtype, n_workers, candidates, x64):
    flat, idx, bs, rs, scales = _frontier_inputs(n_workers, candidates, 41, dtype, seed=5)
    flat[0, 2, 0] = np.nan
    flat[-1, 6, -1] = np.inf
    want = _frontier_cover(
        jnp.asarray(flat), jnp.asarray(idx), jnp.asarray(bs), jnp.asarray(rs),
        jnp.asarray(scales),
    )
    got = cover.frontier_cover(torch.from_numpy(flat), bs, rs, torch.from_numpy(scales))
    assert_bitwise(got.numpy(), np.asarray(want))


def test_wrappers_use_plain_version_only_on_cpu():
    """The CPU path launches nothing; any device other than CPU or CUDA raises."""
    before = cover.launches
    x = torch.from_numpy(_draws((37, 6, 4), "float32", inject=False))
    cover.masked_cover_times(x, 3, 2)
    cover.frontier_cover(x[:2].contiguous(), [1, 2], [4, 2], torch.ones(2))
    assert cover.launches == before
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        cover.masked_cover_times(torch.empty((4, 2, 2), device="meta"), 1, 1)


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda x: cover.masked_cover_times(x.int(), 1, 1), "float32 or float64"),
        (lambda x: cover.masked_cover_times(x.transpose(1, 2), 1, 1), "contiguous"),
        (lambda x: cover.masked_cover_times(x, 0, 1), "n_batches"),
        (lambda x: cover.masked_cover_times(x, 1, 5), "replication"),
        (lambda x: cover.masked_cover_times(x[0], 1, 1), "3-D"),
        (lambda x: cover.frontier_cover(x, [1] * 8, [4] * 8, torch.ones(8)), "b=1, r=4"),
        (lambda x: cover.frontier_cover(x, [1], [1], torch.ones(8)), "one \\(b, r\\)"),
        (lambda x: cover.frontier_cover(x, [1] * 8, [1] * 8, torch.ones(7)), "scales"),
    ],
)
def test_wrappers_reject_what_the_kernel_does_not_take(call, match):
    x = torch.ones((8, 3, 3))
    with pytest.raises(ValueError, match=match):
        call(x)


def test_simulate_counts_zero_hosts_and_guard():
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core.service_time import Exponential

    t = simulator.simulate_counts(gen, Exponential(1.0), [2, 0, 1], 50, device="cpu")
    assert t.shape == (50,) and np.isinf(t).all()
    t = simulator.simulate_counts(gen, Exponential(1.0), [0, 0], 7, device="cpu")
    assert t.shape == (7,) and np.isinf(t).all()
    t = simulator.simulate_counts(gen, Exponential(1.0), [2, 3, 1], 50, device="cpu")
    assert np.isfinite(t).all() and (t > 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_frontier_sample_cover_is_the_reference_cover_of_the_philox_draws(dtype, x64):
    """Kernel B's plain version scores the plain Philox draws exactly as the
    reference's ``_frontier_cover`` scores them."""
    from repro_torch.core.service_time import Pareto
    from repro_torch.kernels import philox

    dist = Pareto(sigma=1.0, alpha=1.5)
    n_workers, cands = 12, [1, 2, 3, 4, 6, 12]
    bs = np.asarray(cands)
    rs = n_workers // bs
    tdt = getattr(torch, dtype)
    got = cover.frontier_sample_cover(dist, bs, rs, n_workers / bs, 64, seed=21, rep0=100,
                                      dtype=tdt, device="cpu")
    x = philox.draws(dist.philox_law(), 21, len(bs), 100, 64, 12, tdt).numpy()
    idx = np.zeros((len(bs), int(bs.max()), int(rs.max())), dtype=np.int32)
    for c, (b, r) in enumerate(zip(bs, rs)):
        idx[c, :b, :r] = np.arange(b * r, dtype=np.int32).reshape(b, r)
    want = _frontier_cover(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(bs), jnp.asarray(rs),
        jnp.asarray(n_workers / bs, dtype=x.dtype),
    )
    assert_bitwise(got.numpy(), want)
