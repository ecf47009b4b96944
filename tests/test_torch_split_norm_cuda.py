"""The split-row RMSNorm kernels and the recurrent families' TP ranks on the card.

``rmsnorm_sumsq`` and ``rmsnorm_scaled`` (``kernels/csrc/rmsnorm.cu``, the
row of a rank's columns normalised by the whole row's sum of squares)
against their plain versions on the card: every path of ``dispatch`` (16-byte
vectors at each register budget, and the scalar path: a width not a
multiple of the vector, a row start off a 16-byte boundary), float32 and
bf16 rows, float32 and bf16 weights, plain and ``plus_one``; a group of one
takes the fused kernel, bitwise.  And mamba2 / recurrentgemma smoke at TP 2
on thread ranks on the card against the same model's plain path there.
Tolerance: ``tests/test_kernels.py``'s ``TOL``.  The kernels have no CPU
mode, so these tests skip where no card is present; they import no jax:

    PYTHONPATH=src python -m pytest tests/test_torch_split_norm_cuda.py -m cuda -q
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_tp_threads import rank_params, run_ranks  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,offset", [(512, 0), (1024, 0), (1280, 0), (2560, 0), (8192, 0),
                                      (1283, 0), (1280, 1)])
def test_split_row_kernels_match_plain_versions(card, d, offset, dtype, w_dtype, plus_one):
    """Rows of ``d`` columns (a rank's chunk of a row of ``4 d``), at each
    register budget of the vector path, and on the scalar path: rows wider
    than the registers hold, an odd width, a start off a 16-byte boundary."""
    rows = 37
    if offset:  # a view one element into its buffer
        x = _randn((rows * d + offset,), DTYPES[dtype], card, 1)[offset:].view(rows, d)
    else:
        x = _randn((rows, d), DTYPES[dtype], card, 1)
    w = _randn((d,), DTYPES[w_dtype], card, 3, 0.1)
    total = rmsnorm.row_sumsq(x)
    want_total = rmsnorm.row_sumsq_ref(x)
    _close(total, want_total, dict(atol=0, rtol=2e-5))
    whole = total + 3.0 * float(d)  # the other ranks' share of a 4 d row
    got = rmsnorm.rms_norm_scaled(x, w, whole, 4 * d, plus_one=plus_one)
    want = rmsnorm.rms_norm_split_ref(x, w, whole, 4 * d, plus_one=plus_one)
    _close(got, want, TOL[dtype])


@pytest.mark.cuda
def test_split_row_launch_counts_and_group_of_one(card):
    """``rms_norm_split`` over a group of one is the fused kernel (one launch,
    bitwise ``rms_norm_fused``); the split pair counts one launch each."""
    x = _randn((64, 2560), torch.bfloat16, card, 4)
    w = _randn((2560,), torch.bfloat16, card, 5, 0.1)
    before = (rmsnorm.launches, rmsnorm.sumsq_launches, rmsnorm.scaled_launches)
    got = rmsnorm.rms_norm_split(x, w, tp.SINGLE)
    assert torch.equal(got, rmsnorm.rms_norm_fused(x, w))
    after = (rmsnorm.launches, rmsnorm.sumsq_launches, rmsnorm.scaled_launches)
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (2, 0, 0)
    rmsnorm.rms_norm_scaled(x, w, rmsnorm.row_sumsq(x), 2560)
    assert (rmsnorm.sumsq_launches - after[1], rmsnorm.scaled_launches - after[2]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_tp_ranks_on_the_card_match_the_plain_path(card, arch):
    """Smoke models at TP 2, the ranks threads on the card: a
    prefill and two decode steps within 1e-4 of the card's plain path."""
    cfg = get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), device=card, dtype=torch.int32,
                           generator=torch.Generator(device=card).manual_seed(1))

    def serve(p):
        with torch.no_grad():
            logits, cache, t = model.prefill(p, {"tokens": tokens[:, :8]}, 10)
            out = [logits]
            for i in (8, 9):
                logits, cache, t = model.decode_step(p, cache, tokens[:, i:i + 1], t)
                out.append(logits)
        torch.cuda.synchronize()
        return out

    want = serve(params)
    for outs in run_ranks(2, lambda r, g: serve(rank_params(params, 2, r))):
        for a, b in zip(outs, want):
            _close(a, b, dict(atol=1e-4, rtol=1e-4))
