"""The port's flash attention against the reference's Pallas kernel and layer.

Identical numpy inputs go through the reference (the Pallas
``flash_attention_fwd`` in interpret mode, ``kernels.ops.attention`` and the
model's ``layers.flash_attention``) and through the port's wrappers, which on
a CPU tensor run the kernel's plain version (what the CUDA kernel is held to
on the card).  Shapes are ``tests/test_kernels.py``'s: MHA, GQA 2:1, MQA with
a sequence that fills no whole block, head_dim 256; causal and not, and a
sliding window.  Tolerance is ``tests/test_kernels.py``'s ``TOL``: float32
2e-5 (the reference's blockwise online softmax and the plain version's
one-pass softmax sum in other orders), bfloat16 3e-2 (a bf16 rounding of
the output).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd  # noqa: E402
from repro.kernels.ops import attention as jax_ops_attention  # noqa: E402
from repro.models.layers import flash_attention as jax_layer_flash  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _qkv(b, h, kh, sq, sk, hd, dtype, seed=0, layout="bhsd"):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = [(b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd)]
    else:
        shapes = [(b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)]
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "b,h,kh,s,hd",
    [
        (1, 4, 4, 128, 64),   # MHA, one block
        (2, 4, 2, 256, 64),   # GQA 2:1, multiple blocks
        (1, 8, 1, 192, 128),  # MQA, ragged seq vs block
        (1, 2, 2, 64, 256),   # gemma-style head_dim 256
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_pallas(dtype, b, h, kh, s, hd, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, h, kh, s, s, hd, dtype)
    got = flash.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = pallas_fwd(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_fwd_window_matches_pallas(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 1, 256, 256, 64, dtype, seed=1)
    got = flash.flash_attention_fwd(tq, tk, tv, causal=True, window=96)
    want = pallas_fwd(jq, jk, jv, causal=True, window=96, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_flash_fwd_cross_attention_lengths_match_pallas():
    # Sq != Sk (a chunked prefill append), hd 32 as the gemma smoke config
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 2, 64, 192, 32, "f32", seed=2)
    got = flash.flash_attention_fwd(tq, tk, tv, causal=False)
    want = pallas_fwd(jq, jk, jv, causal=False, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["f32"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_attention_model_layout_matches_reference(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 4, 2, 96, 96, 32, dtype, seed=3, layout="bshd")
    got = ops.attention(tq, tk, tv, causal=True)
    want = jax_ops_attention(jq, jk, jv, causal=True, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _ring_cache(b, w, kh, hd, t, n_written, seed):
    """A ring buffer of w slots holding positions t - n_written + 1 .. t at
    pos % w, -1 in the slots never written."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, w, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, w, kh, hd)).astype(np.float32)
    pos = np.full((w,), -1, np.int32)
    for p in range(t - n_written + 1, t + 1):
        pos[p % w] = p
    return k, v, np.broadcast_to(pos, (b, w)).copy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "kh,g,hd,w,t,n_written,window",
    [
        (2, 6, 128, 40, 29, 30, None),   # qwen2's GQA 12:2, cache not yet full
        (2, 6, 128, 40, 57, 40, None),   # the ring wrapped: positions out of order
        (4, 1, 32, 24, 50, 24, 16),      # gemma-smoke hd 32 with a sliding window
        (1, 2, 256, 33, 12, 13, None),   # hd 256, a slot count that fills no tile
    ],
)
def test_layer_flash_attention_decode_matches_reference(dtype, kh, g, hd, w, t, n_written,
                                                         window):
    b = 2
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, 1, kh * g, hd)).astype(np.float32)
    k, v, kv_pos = _ring_cache(b, w, kh, hd, t, n_written, seed=8)
    q_pos = np.full((b, 1), t, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = layers.flash_attention(tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                                 causal=True, window=window)
    want = jax_layer_flash(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                           window=window, block_k=16)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_layer_flash_attention_prefill_offset_positions_match_reference():
    # a prefill chunk at positions 40..71 over keys at 0..71, GQA 4:2, windowed
    b, sq, sk, h, kh, hd = 1, 32, 72, 4, 2, 64
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    q_pos = (40 + np.arange(sq, dtype=np.int32))[None]
    kv_pos = np.arange(sk, dtype=np.int32)[None]
    for window in (None, 20):
        got = layers.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
                                     causal=True, window=window)
        want = jax_layer_flash(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
                               causal=True, window=window, block_k=16)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL["f32"])


def test_attention_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 3, 16)
    k = torch.zeros(1, 4, 2, 16)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash.attention(q, k, k, pos, pos)
    with pytest.raises(ValueError, match="int32"):
        flash.attention(q, q, q, pos.long(), pos)
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        flash.attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3), pos, pos)
    with pytest.raises(ValueError, match="window"):
        flash.attention(q, q, q, pos, pos, window=0)
    before = flash.launches
    flash.attention(q, q, q, pos, pos)
    assert flash.launches == before  # the plain version is no launch


# The split-KV decode kernel's arithmetic (per-split partials and their merge)
# in plain PyTorch, held to the one-pass plain version, the reference's model
# layer and the Pallas kernel in interpret mode.  Cases: (kh, g, hd, slots,
# position of the new token t, slots written, window).
_SPLITKV_CASES = {
    "unwritten tail": (2, 6, 64, 40, 29, 30, None),
    "all-unwritten split": (2, 3, 32, 48, 9, 10, None),
    "wrapped ring": (2, 6, 64, 40, 57, 40, None),
    "window over a ring": (4, 1, 32, 24, 50, 24, 16),
    "only slot 0": (1, 4, 32, 33, 0, 1, None),
    "one slot": (2, 2, 32, 1, 5, 1, None),
}


@pytest.mark.parametrize("case", list(_SPLITKV_CASES))
def test_splitkv_ref_matches_plain_and_reference_for_every_split_count(case):
    kh, g, hd, w, t, n_written, window = _SPLITKV_CASES[case]
    b = 2
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, 1, kh * g, hd)).astype(np.float32)
    k, v, kv_pos = _ring_cache(b, w, kh, hd, t, n_written, seed=12)
    q_pos = np.full((b, 1), t, np.int32)
    tq, tk, tv, tqp, tkp = (torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos))
    want = flash.attention_ref(tq, tk, tv, tqp, tkp, True, window)
    jax_want = jax_layer_flash(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), causal=True,
                               window=window, block_k=16)
    np.testing.assert_allclose(want.numpy(), _f32(jax_want), **TOL["f32"])
    for n_split in range(1, w + 1):
        got = flash.attention_splitkv_ref(tq, tk, tv, tqp, tkp, True, window, n_split=n_split)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["f32"],
                                   err_msg=f"n_split={n_split}")


def test_splitkv_ref_skips_a_split_that_no_query_can_see():
    # slots 0..15 hold positions past the query (invisible by causality) and
    # 16..31 are unwritten: a split within them is skipped (m = NEG_INF,
    # l = 0) and the merge gives it weight 0
    b, kh, g, hd, w = 1, 1, 2, 16, 40
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((b, 1, kh * g, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, w, kh, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, w, kh, hd)).astype(np.float32))
    pos = np.full((b, w), -1, np.int32)
    pos[0, :16] = np.arange(100, 116)   # future positions: masked by causality
    pos[0, 32:] = np.arange(10, 18)     # the only visible keys
    kv_pos, q_pos = torch.from_numpy(pos), torch.tensor([[20]], dtype=torch.int32)
    want = flash.attention_ref(q, k, v, q_pos, kv_pos, True, None)
    for n_split in (1, 2, 5, 40):
        got = flash.attention_splitkv_ref(q, k, v, q_pos, kv_pos, True, None, n_split=n_split)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["f32"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_split", [1, 3, 8, 64])
def test_splitkv_ref_matches_pallas(dtype, n_split):
    # arange positions, causal, GQA 4:2: the Pallas kernel in interpret mode
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 4, 2, 64, 64, 32, dtype, seed=14)
    pos = torch.arange(64, dtype=torch.int32)[None]
    got = flash.attention_splitkv_ref(*(t.transpose(1, 2) for t in (tq, tk, tv)), pos, pos,
                                      True, None, n_split=n_split).transpose(1, 2)
    want = pallas_fwd(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_splitkv_ref_rejects_a_split_count_out_of_range():
    q = torch.zeros(1, 1, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    for n_split in (0, 5):
        with pytest.raises(ValueError, match="n_split"):
            flash.attention_splitkv_ref(q, k, k, pos[:, :1], pos, n_split=n_split)


@pytest.mark.parametrize("sq,h,kh,dtype,aligned,want", [
    (1, 12, 2, torch.bfloat16, True, "splitkv"),     # qwen2-1.5b decode: 6 rows
    (1, 12, 2, torch.float32, True, "splitkv"),
    (2, 16, 2, torch.bfloat16, True, "splitkv"),     # 16 rows: the threshold itself
    (3, 12, 2, torch.bfloat16, True, "splitkv"),     # 18 rows: past it
    (1024, 12, 2, torch.bfloat16, True, "wgmma"),    # qwen2-1.5b prefill
    (17, 1, 1, torch.bfloat16, True, "wgmma"),       # 17 rows, MHA
    (1024, 12, 2, torch.float32, True, "simt"),      # float32 prefill: CUDA cores
    (1, 12, 2, torch.bfloat16, False, "simt"),       # rows off 16-byte boundaries
    (1024, 12, 2, torch.bfloat16, False, "simt"),
])
def test_route_picks_the_kernel_by_rows_dtype_and_alignment(sq, h, kh, dtype, aligned, want):
    rows = sq * (h // kh)
    if rows > flash.SPLITKV_MAX_ROWS and want == "splitkv":
        want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash.route(dtype, sq, h, kh, 128, 1056, aligned) == want


def test_route_keeps_long_caches_and_odd_head_dims_off_the_wgmma_kernel():
    assert flash.route(torch.bfloat16, 64, 8, 8, 128, flash.WGMMA_MAX_KEYS, True) == "wgmma"
    assert flash.route(torch.bfloat16, 64, 8, 8, 128, flash.WGMMA_MAX_KEYS + 1, True) == "simt"
    assert flash.route(torch.bfloat16, 64, 8, 8, 36, 64, True) == "simt"


@pytest.mark.parametrize("b,kh,sk,n_sms", [(1, 2, 1056, 132), (1, 16, 300, 132), (2, 2, 1, 132),
                                           (4, 8, 32768, 132), (1, 1, 100000, 132),
                                           (1, 2, 17, 132), (64, 4, 2048, 132)])
def test_splitkv_plan_fills_the_card_with_non_empty_splits(b, kh, sk, n_sms):
    n_split, chunk = flash.splitkv_plan(b, kh, sk, n_sms)
    assert 1 <= n_split <= flash.SPLITKV_MAX_SPLITS
    assert (n_split - 1) * chunk < sk <= n_split * chunk  # every split holds a slot
    assert chunk >= min(sk, flash.SPLITKV_MIN_KEYS)
    if sk >= flash.SPLITKV_MIN_KEYS * n_sms:  # enough slots: the blocks cover the SMs
        assert b * kh * n_split >= min(n_sms, b * kh * flash.SPLITKV_MAX_SPLITS)
    if (b, kh, sk) == (1, 2, 1056):
        assert (n_split, chunk) == (66, 16)  # qwen2-1.5b decode: 132 blocks of 16 slots


def test_rows_aligned_sees_a_misaligned_view_and_odd_strides():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert flash._rows_aligned(x, x.transpose(1, 2).transpose(1, 2))
    assert not flash._rows_aligned(torch.zeros(1 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
                                   .view(1, 8, 2, 64))
    assert not flash._rows_aligned(torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64])
    assert flash._rows_aligned(torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)[:, :, :1])
