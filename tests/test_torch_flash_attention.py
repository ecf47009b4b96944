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
