"""The RMSNorm and flash-attention CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so these tests skip where no NVIDIA card is
present.  They import neither jax nor the reference package, so they run on
a machine that has only the port:

    PYTHONPATH=src python -m pytest tests/test_torch_model_cuda.py -m cuda -q

The plain versions are what ``tests/test_torch_rmsnorm.py`` and
``tests/test_torch_flash_attention.py`` hold to the reference.  Tolerance is
``tests/test_kernels.py``'s ``TOL``: float32 2e-5 (summation order), bfloat16
3e-2 (a bf16 rounding of the output).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


def _randn(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 96, 64), (3, 128), (1, 7, 33), (1024, 1536), (2, 3072)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_kernel_matches_plain(dtype, shape, plus_one, card):
    x = _randn(shape, dtype, card, 0)
    w = _randn(shape[-1:], dtype, card, 1) * 0.1
    before = rmsnorm.launches
    got = rmsnorm.rms_norm_fused(x, w, plus_one=plus_one)
    assert rmsnorm.launches == before + 1
    _close(got, rmsnorm.rms_norm_ref(x, w, plus_one=plus_one), dtype)
    # a float32 weight on a bf16 activation, as the final norm of a served model
    _close(rmsnorm.rms_norm_fused(x, w.float(), plus_one=plus_one),
           rmsnorm.rms_norm_ref(x, w.float(), plus_one=plus_one), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "b,h,kh,sq,sk,hd,causal,window",
    [
        (1, 4, 4, 128, 128, 64, True, None),    # MHA
        (2, 4, 2, 256, 256, 64, False, None),   # GQA 2:1
        (1, 8, 1, 192, 192, 128, True, None),   # MQA, ragged
        (1, 2, 2, 64, 64, 256, True, None),     # gemma head_dim 256
        (1, 2, 2, 70, 70, 256, False, None),    # head_dim 256, ragged
        (1, 4, 2, 96, 96, 32, True, None),      # head_dim 32
        (1, 2, 1, 256, 256, 64, True, 96),      # sliding window
        (1, 2, 2, 64, 192, 64, False, None),    # Sq != Sk
        (1, 12, 2, 1024, 1024, 128, True, None),  # qwen2-1.5b prefill
    ],
)
def test_flash_fwd_kernel_matches_plain(dtype, b, h, kh, sq, sk, hd, causal, window, card):
    q = _randn((b, h, sq, hd), dtype, card, 2)
    k = _randn((b, kh, sk, hd), dtype, card, 3)
    v = _randn((b, kh, sk, hd), dtype, card, 4)
    before = flash.launches
    got = flash.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash.launches == before + 1
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    qpos = torch.arange(sq, dtype=torch.int32, device=card).expand(b, sq)
    kpos = torch.arange(sk, dtype=torch.int32, device=card).expand(b, sk)
    want = flash.attention_ref(qm, km, vm, qpos, kpos, causal, window).transpose(1, 2)
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kh,g,hd,w,t,n_written,window", [
    (2, 6, 128, 1056, 1030, 1031, None),  # qwen2-1.5b decode: -1 in the tail slots
    (2, 6, 128, 40, 57, 40, None),        # a wrapped ring: positions out of order
    (16, 1, 256, 300, 299, 300, None),    # gemma-7b head_dim 256
    (4, 1, 64, 64, 100, 64, 16),          # sliding window over a wrapped ring
])
def test_decode_attention_kernel_matches_plain(dtype, kh, g, hd, w, t, n_written, window, card):
    b = 2
    q = _randn((b, 1, kh * g, hd), dtype, card, 5)
    k = _randn((b, w, kh, hd), dtype, card, 6)
    v = _randn((b, w, kh, hd), dtype, card, 7)
    pos = torch.full((w,), -1, dtype=torch.int32)
    for p in range(t - n_written + 1, t + 1):
        pos[p % w] = p
    kv_pos = pos.to(card).expand(b, w).contiguous()
    q_pos = torch.full((b, 1), t, dtype=torch.int32, device=card)
    got = flash.attention(q, k, v, q_pos, kv_pos, causal=True, window=window)
    _close(got, flash.attention_ref(q, k, v, q_pos, kv_pos, True, window), dtype)


def _path_counts():
    return flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches


def _path_of(before):
    after = _path_counts()
    assert sum(a - b for a, b in zip(after, before)) == 1  # one kernel, one launch
    return ("splitkv", "wgmma", "simt")[[a != b for a, b in zip(after, before)].index(True)]


def _ring(w, t, n_written, b, dev):
    pos = torch.full((w,), -1, dtype=torch.int32)
    for p in range(t - n_written + 1, t + 1):
        pos[p % w] = p
    return pos.to(dev).expand(b, w).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("b,kh,g,w,t,n_written,window", [
    (1, 2, 6, 1056, 1030, 1031, None),  # qwen2-1.5b decode at B = 1, -1 in the tail
    (1, 2, 6, 1056, 0, 1, None),        # only slot 0 written
    (2, 2, 6, 10, 9, 10, None),         # fewer slots than one split
    (2, 2, 6, 1, 0, 1, None),           # one slot
    (1, 4, 2, 64, 100, 64, 16),         # a wrapped ring with a window
])
def test_splitkv_decode_matches_plain(dtype, hd, b, kh, g, w, t, n_written, window, card):
    q = _randn((b, 1, kh * g, hd), dtype, card, 8)
    k = _randn((b, w, kh, hd), dtype, card, 9)
    v = _randn((b, w, kh, hd), dtype, card, 10)
    kv_pos = _ring(w, t, n_written, b, card)
    q_pos = torch.full((b, 1), t, dtype=torch.int32, device=card)
    before = _path_counts()
    got = flash.attention(q, k, v, q_pos, kv_pos, causal=True, window=window)
    assert _path_of(before) == "splitkv"
    _close(got, flash.attention_ref(q, k, v, q_pos, kv_pos, True, window), dtype)
    # a second launch on the same stream finds its tickets back at zero
    _close(flash.attention(q, k, v, q_pos, kv_pos, causal=True, window=window),
           flash.attention_ref(q, k, v, q_pos, kv_pos, True, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,h,kh", [(2, 16, 2), (16, 4, 4), (3, 12, 2), (17, 4, 4)])
def test_routing_threshold_from_both_sides(dtype, sq, h, kh, card):
    # Sq * g query rows per kv head: 16 take the split-KV kernel, 17 and 18 do not
    b, sk, hd = 2, 300, 128
    q = _randn((b, sq, h, hd), dtype, card, 11)
    k = _randn((b, sk, kh, hd), dtype, card, 12)
    v = _randn((b, sk, kh, hd), dtype, card, 13)
    kv_pos = _ring(sk, 250, 251, b, card)
    q_pos = torch.arange(251 - sq, 251, dtype=torch.int32, device=card).expand(b, sq).contiguous()
    before = _path_counts()
    got = flash.attention(q, k, v, q_pos, kv_pos, causal=True)
    rows = sq * (h // kh)
    want_path = "splitkv" if rows <= flash.SPLITKV_MAX_ROWS else (
        "wgmma" if dtype == "bf16" else "simt")
    assert _path_of(before) == want_path
    _close(got, flash.attention_ref(q, k, v, q_pos, kv_pos, True, None), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("sq,sk,n_written,window", [
    (70, 70, 70, None),     # ragged Sq: no whole 64-row tile
    (192, 192, 192, None),  # three whole tiles
    (96, 160, 96, None),    # Sk > Sq with an unwritten tail (a prompt in a larger cache)
    (128, 128, 128, 48),    # sliding window
])
def test_prefill_matches_plain_on_every_head_dim(dtype, hd, sq, sk, n_written, window, card):
    b, h, kh = 1, 4, 2
    q = _randn((b, sq, h, hd), dtype, card, 14)
    k = _randn((b, sk, kh, hd), dtype, card, 15)
    v = _randn((b, sk, kh, hd), dtype, card, 16)
    kv_pos = _ring(sk, n_written - 1, n_written, b, card)
    q_pos = torch.arange(n_written - sq, n_written, dtype=torch.int32,
                         device=card).expand(b, sq).contiguous()
    before = _path_counts()
    got = flash.attention(q, k, v, q_pos, kv_pos, causal=True, window=window)
    assert _path_of(before) == ("wgmma" if dtype == "bf16" else "simt")
    _close(got, flash.attention_ref(q, k, v, q_pos, kv_pos, True, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_misaligned_rows_take_the_cuda_core_kernel(dtype, card):
    # a view one element off a 16-byte boundary: neither vector kernel can read it
    b, sq, sk, h, kh, hd = 1, 1, 40, 4, 2, 64
    flat = _randn((b * sq * h * hd + 1,), dtype, card, 17)
    q = flat[1:].view(b, sq, h, hd)
    k = _randn((b, sk, kh, hd), dtype, card, 18)
    v = _randn((b, sk, kh, hd), dtype, card, 19)
    kv_pos = _ring(sk, 30, 31, b, card)
    q_pos = torch.full((b, sq), 30, dtype=torch.int32, device=card)
    before = _path_counts()
    got = flash.attention(q, k, v, q_pos, kv_pos, causal=True)
    assert _path_of(before) == "simt"
    _close(got, flash.attention_ref(q, k, v, q_pos, kv_pos, True, None), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [100, 1536, 4100])
def test_rmsnorm_kernel_takes_misaligned_views_and_odd_widths(dtype, d, card):
    # d = 100 is no multiple of 8 (bf16 takes the scalar path, float32 not);
    # 4100 is wider than the vector path holds; the view starts off a 16-byte
    # boundary, so every width takes the scalar path there
    rows = 5
    x = _randn((rows, d), dtype, card, 20)
    w = _randn((d,), dtype, card, 21) * 0.1
    flat = torch.empty(rows * d + 1, dtype=DTYPES[dtype], device=card)
    flat[1:].copy_(x.reshape(-1))
    view = flat[1:].view(rows, d)
    for xx in (x, view):
        before = rmsnorm.launches
        got = rmsnorm.rms_norm_fused(xx, w, plus_one=True)
        assert rmsnorm.launches == before + 1
        _close(got, rmsnorm.rms_norm_ref(xx, w, plus_one=True), dtype)


@pytest.mark.cuda
def test_smoke_model_on_card_matches_cpu(card):
    # float32 compute with TF32 off: the card's kernels against the CPU's plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("qwen2-1.5b", "gemma-7b"):
        cfg = get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 11), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        want, _, _ = transformer.forward(params, cfg, tokens=tokens)
        params_c = params.to(card)
        rms0, att0 = rmsnorm.launches, flash.launches
        got, _, _ = transformer.forward(params_c, cfg, tokens=tokens.to(card))
        assert rmsnorm.launches - rms0 == 2 * cfg.n_layers + 1
        assert flash.launches - att0 == cfg.n_layers
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
        logits, cache, t = model.prefill(params_c, {"tokens": tokens[:, :7].to(card)}, 11)
        for i in range(4):
            logits, cache, t = model.decode_step(params_c, cache, tokens[:, 7 + i: 8 + i].to(card), t)
            np.testing.assert_allclose(logits.cpu().numpy(), want[:, 7 + i].numpy(),
                                       atol=2e-3, rtol=2e-3)
