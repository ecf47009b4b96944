"""The CUDA cover kernel against its plain PyTorch version, on the card.

The kernel has no CPU mode, so these tests skip where no NVIDIA card is
present.  They import neither jax nor the reference package, so they also run
on a machine that has only the port installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cover_cuda.py -m cuda -q

The plain versions are what ``tests/test_torch_cover.py`` and
``tests/test_torch_philox.py`` hold to the reference; here the kernels are
held to them.  Kernel A (draws in) is bitwise equal in float32 and float64 on
the same kinds of draws (padded slots, a rep count that fills no whole block,
``b = 1`` / ``r = 1`` / ``r = n_slots``, a masked ``ld > r`` grid, rows that
start off a 16-byte boundary, batches wider than its shared-memory buffer,
NaN and inf).  Kernel B (Philox sample-and-cover) draws the plain version's
uniforms bit for bit; its cover times are bitwise equal for an empirical law
(gather, scale and min/max only) and within a relative 2e-6 (float32) /
1e-14 (float64) for the others, whose ``log1p`` / ``pow`` may differ by a
few ulp between the kernel's libdevice call and torch's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.cluster.vectorized import frontier_job_times  # noqa: E402
from repro_torch.core import service_time as st  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.kernels import cover  # noqa: E402

DTYPES = [torch.float32, torch.float64]
MASKS = [(6, 4), (3, 2), (2, 4), (6, 1), (1, 1), (1, 4)]
FRONTIERS = [(12, [1, 2, 3, 4, 6, 12]), (10, [1, 3, 4, 10]), (7, [7]), (5, [1])]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA cover kernel has no CPU mode")
    return torch.device("cuda")


def assert_bitwise(got: torch.Tensor, want: torch.Tensor):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got[~nan].view(bits), want[~nan].view(bits))


def _draws(dtype, dev):
    x = np.random.default_rng(3).exponential(size=(300, 6, 4))
    x[3, 0, 0] = x[5, 5, 3] = np.nan
    x[7, 1, 1] = np.inf
    x[9, :, 0] = np.inf
    x[13, 4, 2] = -np.inf
    return torch.as_tensor(x, dtype=dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_masked_cover_kernel_matches_plain_bitwise(dtype, card):
    x = _draws(dtype, card)
    before = cover.launches
    for b, r in MASKS:
        assert_bitwise(cover.masked_cover_times(x, b, r), cover.masked_cover_times_ref(x, b, r))
        got = simulator.gang_cover_times(x.view(3, 100, 6, 4), b, r)
        assert got.shape == (3, 100)
        assert_bitwise(got.view(300), cover.masked_cover_times_ref(x, b, r))
    torch.cuda.synchronize()
    assert cover.launches == before + 2 * len(MASKS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n_workers,candidates", FRONTIERS, ids=["div", "pad", "r1", "b1"])
def test_frontier_cover_kernel_matches_plain_bitwise(dtype, n_workers, candidates, card):
    bs = np.asarray(candidates)
    rs = n_workers // bs
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.rand((len(bs), 300, int((bs * rs).max())), generator=gen, device=card, dtype=dtype)
    x[0, 2, 0] = float("nan")
    x[-1, 6, -1] = float("inf")
    scales = torch.as_tensor(n_workers / bs, dtype=dtype, device=card)
    got = cover.frontier_cover(x, bs, rs, scales)
    torch.cuda.synchronize()
    assert_bitwise(got, cover.frontier_cover_ref(x, bs, rs, scales))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize(
    "bs,rs,n_slots",
    [
        ([720, 1, 24, 5], [1, 720, 30, 144], 720),  # r = 1, r = n_slots, both paths of w
        ([41, 1, 3], [1, 41, 13], 41),  # rows 164 / 328 bytes apart: off 16-byte boundaries
        ([1, 2], [1500, 700], 1500),  # batches wider than the shared-memory buffer
        ([3, 7], [33, 9], 100),  # r just past a warp; a partial last step
    ],
    ids=["n720", "n41", "wide", "odd"],
)
def test_frontier_cover_kernel_edge_geometries(dtype, bs, rs, n_slots, card):
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.rand((len(bs), 77, n_slots), generator=gen, device=card, dtype=dtype)
    x[0, 3, 0] = float("nan")
    x[-1, 5, n_slots - 1] = float("inf")
    x[1, 9, :] = float("inf")
    scales = torch.as_tensor([2.0 + c for c in range(len(bs))], dtype=dtype, device=card)
    before = cover.draws_launches
    got = cover.frontier_cover(x, bs, rs, scales)
    torch.cuda.synchronize()
    assert cover.draws_launches == before + 1
    assert_bitwise(got, cover.frontier_cover_ref(x, bs, rs, scales))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_masked_cover_kernel_on_offset_rows_and_wide_pads(dtype, card):
    gen = torch.Generator(device=card).manual_seed(8)
    base = torch.rand((1 + 200 * 5 * 7 + 3,), generator=gen, device=card, dtype=dtype)
    x = base[1:1 + 200 * 5 * 7].view(200, 5, 7)  # starts one element past the allocation
    x[4, 0, 0] = float("nan")
    x[8, 2, 6] = float("nan")  # masked out below r = 6
    for b, r in [(5, 7), (5, 6), (2, 1), (1, 7), (4, 3)]:
        assert_bitwise(cover.masked_cover_times(x, b, r), cover.masked_cover_times_ref(x, b, r))
    wide = torch.rand((40, 3, 1100), generator=gen, device=card, dtype=dtype)  # ld > buffer
    for b, r in [(3, 1100), (2, 1), (3, 37)]:
        assert_bitwise(cover.masked_cover_times(wide, b, r),
                       cover.masked_cover_times_ref(wide, b, r))


JOB6 = tuple(float(v) for v in np.random.default_rng(0).pareto(1.2, 978) + 1.0)
LAWS = {
    "exp": st.Exponential(mu=1.0),
    "sexp": st.ShiftedExponential(delta=0.05, mu=1.0),
    "pareto": st.Pareto(sigma=1.0, alpha=1.5),
    "empirical": st.Empirical(samples=JOB6),
}
RTOL = {torch.float32: 2e-6, torch.float64: 1e-14}


def assert_sample_cover_close(got, want, exact):
    if exact:
        assert_bitwise(got, want)
        return
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    rtol = RTOL[torch.float32 if got.dtype == np.float32 else torch.float64]
    assert (np.abs(got - want) <= rtol * np.abs(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_philox_uniforms_match_plain_bitwise(dtype, card):
    got = cover.frontier_uniforms(17, 3, 300, 101, rep0=2**32 - 300, dtype=dtype, device=card)
    want = cover.frontier_uniforms(17, 3, 300, 101, rep0=2**32 - 300, dtype=dtype,
                                   device="cpu")
    torch.cuda.synchronize()
    assert_bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("n_workers", [12, 100, 30])
def test_sample_cover_kernel_matches_plain(law, dtype, n_workers, card):
    dist = LAWS[law]
    bs = np.array([b for b in range(1, n_workers + 1) if n_workers % b == 0])
    rs = n_workers // bs
    scales = n_workers / bs
    for rep0, n_reps in [(0, 301), (5000, 257)]:
        before = cover.philox_launches
        got = cover.frontier_sample_cover(dist, bs, rs, scales, n_reps, seed=23, rep0=rep0,
                                          dtype=dtype, device=card)
        torch.cuda.synchronize()
        assert cover.philox_launches == before + 1
        want = cover.frontier_sample_cover_ref(dist, bs, rs, scales, n_reps, seed=23, rep0=rep0,
                                               dtype=dtype, device=card)
        assert_sample_cover_close(got, want, exact=law == "empirical")


@pytest.mark.cuda
def test_sample_cover_kernel_reads_a_table_too_large_for_shared_memory(card):
    dist = st.Empirical(samples=tuple(float(v) for v in np.arange(1.0, 14001.0)))  # 112 KB f64
    for dtype in DTYPES:
        args = (dist, [1, 4], [8, 2], [1.0, 3.0], 200)
        got = cover.frontier_sample_cover(*args, seed=2, dtype=dtype, device=card)
        want = cover.frontier_sample_cover_ref(*args, seed=2, dtype=dtype, device=card)
        assert_bitwise(got, want)


@pytest.mark.cuda
def test_frontier_job_times_rep_chunk_bit_identical_on_the_card(card):
    d = st.Pareto(1.0, 2.0)
    full = frontier_job_times(d, 8, [1, 2, 4, 8], 5000, seed=5, device=card)
    for chunk in (1000, 4096, 5000):
        part = frontier_job_times(d, 8, [1, 2, 4, 8], 5000, seed=5, rep_chunk=chunk,
                                  device=card)
        assert np.array_equal(full, part), chunk
