"""The port's RMSNorm against the reference's Pallas kernel and its oracle.

Identical numpy inputs go through the Pallas ``rms_norm_fused`` in interpret
mode, the reference's ``rms_norm_ref``, and the port's ``rms_norm_fused``,
which on a CPU tensor runs its plain version (the yardstick the CUDA kernel
is held to on the card).  Tolerance is ``tests/test_kernels.py``'s ``TOL``:
float32 2e-5 (summation order), bfloat16 3e-2 (one bf16 rounding of the
output may land on the other side).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import rms_norm_ref as jax_rms_norm_ref  # noqa: E402
from repro.kernels.rmsnorm import rms_norm_fused as pallas_rms_norm  # noqa: E402
from repro.models.layers import rms_norm as jax_layer_rms_norm  # noqa: E402
from repro_torch.kernels import ops, rmsnorm  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 96, 64), (3, 128), (1, 7, 33)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_pallas_and_oracle(dtype, shape, plus_one):
    jx, jw, tx, tw = _inputs(shape, dtype)
    got = rmsnorm.rms_norm_fused(tx, tw, plus_one=plus_one)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = pallas_rms_norm(jx, jw, plus_one=plus_one, block_rows=32, interpret=True)
    oracle = jax_rms_norm_ref(jx, jw, plus_one=plus_one)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])
    np.testing.assert_allclose(_f32(ops.rmsnorm(tx, tw, plus_one=plus_one)), _f32(got), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_layer_matches_reference_layer(dtype):
    jx, jw, tx, tw = _inputs((4, 17, 48), dtype, seed=2)
    for plus_one in (False, True):
        got = layers.rms_norm(tx, tw, plus_one=plus_one)
        want = jax_layer_rms_norm(jx, jw, plus_one=plus_one)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_rmsnorm_weight_dtype_may_differ_from_x():
    # the reference upcasts the weight on its own: a float32 weight on bf16 x
    jx, _, tx, _ = _inputs((5, 40), "bf16", seed=4)
    w = np.linspace(0.5, 1.5, 40, dtype=np.float32)
    got = rmsnorm.rms_norm_fused(tx, torch.from_numpy(w))
    want = jax_rms_norm_ref(jx, jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bf16"])


def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones(3, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm.rms_norm_fused(x.double(), torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="weight must be"):
        rmsnorm.rms_norm_fused(x, torch.ones(7))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rms_norm_fused(torch.ones(8, 3).T, torch.ones(8))
    before = rmsnorm.launches
    rmsnorm.rms_norm_fused(x, torch.ones(8))
    assert rmsnorm.launches == before  # the plain version is no launch
