"""The kernels' backward: the two ``torch.autograd.Function``s against ``jax.grad``.

The reference has no backward kernel: its model trains through the jnp
``rms_norm`` and ``flash_attention`` of ``repro/models/layers.py``, which XLA
differentiates.  The port's ``RMSNormFunction`` and ``AttentionFunction``
run the kernel forward (its plain version on the CPU) and a closed-form
backward (``rms_norm_bwd``, ``attention_bwd``) in plain torch; here their
gradients for one seeded output gradient are held to ``jax.grad`` of the
reference's layers on the same numpy inputs, and to ``torch.autograd``
through the kernels' plain versions (``rms_norm_ref``, ``attention_ref``).

Tolerances, each relative to the largest gradient of its tensor
(``max |got - want| <= tol * max |want|``):

* float32: 2e-5, ``tests/test_kernels.py``'s ``TOL`` (the two sides sum the
  same terms in other orders);
* bfloat16 inputs: 2**-6, four units in the last place of bf16's 8-bit
  significand.  Both sides compute in float32 from the same bf16 inputs and
  round each gradient to bf16 once, but attention's ``rowsum(dO O)`` reads
  the saved output, which the forward rounded to bf16, where autodiff (the
  reference's, or torch's through the plain version) reads its float32
  value: dq and dk then differ by up to 7.2e-3 of their largest element in
  these cases, dv and RMSNorm's gradients by under 2e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
GRAD_RTOL = {"f32": 2e-5, "bf16": 2.0**-6}


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in arrays])


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= GRAD_RTOL[dtype] * scale, \
        f"{what}: max |err| {err:.3e}, max |want| {scale:.3e}"


def _torch_grads(fn, args, g):
    out = fn(*args)
    return out, torch.autograd.grad(out, args, g)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("w_f32", [False, True])  # the final norm keeps a float32 weight
def test_rms_norm_backward_matches_jax_grad(dtype, plus_one, w_f32):
    d = 96
    (jx, jw, jg), (x, w, g) = _inputs([(3, 5, d), (d,), (3, 5, d)], dtype, seed=4)
    if w_f32:
        jw, w = jw.astype(jnp.float32), w.detach().float().requires_grad_(True)
    g = g.detach()

    def ref(x_, w_):
        return jnp.sum(jax_layers.rms_norm(x_, w_, plus_one=plus_one).astype(jnp.float32)
                       * jg.astype(jnp.float32))

    want_dx, want_dw = jax.grad(ref, argnums=(0, 1))(jx, jw)
    out, (dx, dw) = _torch_grads(lambda a, b: rmsnorm.RMSNormFunction.apply(a, b, 1e-6, plus_one),
                                 (x, w), g)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close(dx, want_dx, dtype, "dx")
    _close(dw, want_dw, dtype, "dw")
    # the same backward against autograd through the plain version
    out_ref, (rx, rw) = _torch_grads(lambda a, b: rmsnorm.rms_norm_ref(a, b, 1e-6, plus_one),
                                     (x, w), g)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    _close(dx, rx, dtype, "dx vs autograd")
    _close(dw, rw, dtype, "dw vs autograd")
    # the model's layer takes the Function when autograd records
    out_layer, (lx, lw) = _torch_grads(lambda a, b: layers.rms_norm(a, b, plus_one=plus_one),
                                       (x, w), g)
    assert out_layer.grad_fn.name().startswith("RMSNormFunction")
    torch.testing.assert_close(lx, dx, rtol=0, atol=0)


# (B, S, H, KH, hd, causal, window): causal, windowed (window shorter than S),
# non-causal, GQA 4/2 and 4/1
ATTENTION_CASES = [
    (2, 24, 4, 4, 16, True, None),
    (2, 24, 4, 2, 16, True, 7),
    (1, 20, 4, 2, 32, False, None),
    (2, 17, 4, 2, 16, True, None),
    (1, 24, 4, 1, 16, True, None),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kh,hd,causal,window", ATTENTION_CASES)
def test_attention_backward_matches_jax_grad(dtype, b, s, h, kh, hd, causal, window):
    shapes = [(b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd), (b, s, h, hd)]
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(shapes, dtype, seed=5)
    g = g.detach()
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)

    def ref(q_, k_, v_):
        o = jax_layers.flash_attention(q_, k_, v_, jpos, jpos, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(ref, argnums=(0, 1, 2))(jq, jk, jv)
    out, got = _torch_grads(
        lambda a, b_, c: flash.AttentionFunction.apply(a, b_, c, tpos, tpos, causal, window, None),
        (q, k, v), g)
    for name, x, gx, wx in zip("qkv", (q, k, v), got, want):
        assert gx.dtype == x.dtype and gx.shape == x.shape
        _close(gx, wx, dtype, f"d{name}")
    out_ref, plain = _torch_grads(
        lambda a, b_, c: flash.attention_ref(a, b_, c, tpos, tpos, causal, window), (q, k, v), g)
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    for name, gx, px in zip("qkv", got, plain):
        _close(gx, px, dtype, f"d{name} vs autograd")
    out_layer, lg = _torch_grads(
        lambda a, b_, c: layers.flash_attention(a, b_, c, tpos, tpos, causal, window), (q, k, v), g)
    assert out_layer.grad_fn.name().startswith("AttentionFunction")
    for gx, lx in zip(got, lg):
        torch.testing.assert_close(lx, gx, rtol=0, atol=0)


def test_attention_backward_hides_fully_masked_rows():
    # a query that sees no key (every slot -1 for one batch row) averages V
    # uniformly in the forward, as the reference's finite NEG_INF does; its
    # scores' gradient must stay zero, so dq there is zero and dk gets nothing
    (jq, jk, jv, jg), (q, k, v, g) = _inputs([(2, 6, 2, 8), (2, 6, 1, 8), (2, 6, 1, 8),
                                              (2, 6, 2, 8)], "f32", seed=6)
    qpos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    kvpos = qpos.copy()
    kvpos[1] = -1

    def ref(q_, k_, v_):
        o = jax_layers.flash_attention(q_, k_, v_, jnp.asarray(qpos), jnp.asarray(kvpos))
        return jnp.sum(o * jg)

    want = jax.grad(ref, argnums=(0, 1, 2))(jq, jk, jv)
    _, got = _torch_grads(lambda a, b_, c: flash.AttentionFunction.apply(
        a, b_, c, torch.from_numpy(qpos), torch.from_numpy(kvpos), True, None, None),
        (q, k, v), g.detach())
    assert not got[0][1].any() and not got[1][1].any()
    for name, gx, wx in zip("qkv", got, want):
        _close(gx, wx, "f32", f"d{name}")
