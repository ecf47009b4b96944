"""The CUDA cover kernel against its plain PyTorch version, on the card.

The kernel has no CPU mode, so these tests skip where no NVIDIA card is
present.  They import neither jax nor the reference package, so they also run
on a machine that has only the port installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cover_cuda.py -m cuda -q

The plain versions are what ``tests/test_torch_cover.py`` holds bitwise equal
to the reference; here the kernel is held bitwise equal to them, in float32
and float64, on the same kinds of draws (padded slots, a rep count that fills
no whole block, ``b = 1`` / ``r = 1``, NaN and inf).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

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
