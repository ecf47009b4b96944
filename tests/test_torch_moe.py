"""The port's MoE FFN and MoE models against the reference's, on the reference's weights.

``repro_torch.models.moe`` against ``repro.models.moe`` at the fixtures of
``tests/test_model_numerics.py`` (d 16, d_ff 32, 2 rows of 12 tokens, and
the decode case of 4 rows of 1): float32 on both sides, outputs within the
reference's own 1e-5 absolute / 1e-4 relative (the expert products sum in
other orders), the aux loss within 1e-6.  The dispatch is integer
bookkeeping, so its metadata (``slot``, ``keep``, ``token_of``, ``order``)
and the gathered block are held exactly, drops included, at
``capacity_factor = 1.0``.  The two MoE models (dbrx-132b, qwen3-moe) at
smoke size: forward, prefill and every decode step within 1e-4, as
``tests/test_torch_model.py`` holds the dense ones.  The models run on the
CPU, so every norm and attention is the kernels' plain version.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, convert, moe, transformer  # noqa: E402

FFN_TOL = dict(atol=1e-5, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b"]
B, S_PRE, S_DEC = 2, 7, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _fixture(e, d=16, f=32, shape=(2, 12)):
    jparams = jax_moe.init_moe(jax.random.key(0), d, f, e, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (*shape, d))
    return jparams, {k: _t(v) for k, v in jparams.items()}, x, _t(x)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (8, 4)])
def test_moe_ffn_matches_reference(e, k):
    jparams, params, jx, x = _fixture(e)
    want, want_aux = jax_moe.moe_ffn(jparams, jx, k, capacity_factor=float(e))
    got, aux = moe.moe_ffn(params, x, k, capacity_factor=float(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    # the dense oracles agree, and with nothing dropped the FFN equals its oracle
    oracle = moe.moe_ffn_reference(params, x, k)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(jax_moe.moe_ffn_reference(jparams, jx, k)),
                               **FFN_TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **FFN_TOL)


def test_moe_decode_path_single_token():
    e, k = 8, 2
    jparams, params, jx, x = _fixture(e, d=8, f=16, shape=(4, 1))
    assert max(1, int(np.ceil(k * 1 / e * 1.25))) == 1  # decode capacity at the default
    for cf in (float(e), 1.25):
        want, want_aux = jax_moe.moe_ffn(jparams, jx, k, capacity_factor=cf)
        got, aux = moe.moe_ffn(params, x, k, capacity_factor=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    np.testing.assert_allclose(moe.moe_ffn(params, x, k, capacity_factor=float(e))[0].numpy(),
                               moe.moe_ffn_reference(params, x, k).numpy(), **FFN_TOL)


@pytest.mark.parametrize("e,k,d,f,s", [(4, 2, 8, 16, 64), (8, 4, 16, 32, 12), (8, 2, 16, 32, 1)])
def test_dispatch_metadata_exact_at_capacity_one(e, k, d, f, s):
    jparams, params, jx, x = _fixture(e, d=d, f=f, shape=(2, s))
    capacity = max(1, int(np.ceil(k * s / e * 1.0)))
    jlogits = jx.astype(jnp.float32) @ jparams["router"]
    jids, jw = jax_moe._route(jlogits, k)
    ids, w = moe._route(_t(jlogits), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7, rtol=1e-6)
    jxg, jmeta = jax.vmap(
        lambda xr, er, wr: jax_moe._dispatch_row(xr, er, wr, e, capacity))(jx, jids, jw)
    xg, meta = moe._dispatch_rows(x, ids, e, capacity)
    for name, got, want in zip(("token_of", "slot", "order", "keep"), meta, jmeta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))
    if s > 1:
        assert not bool(meta[3].all()), "the fixture should drop some assignments"
    want, want_aux = jax_moe.moe_ffn(jparams, jx, k, capacity_factor=1.0)
    got, aux = moe.moe_ffn(params, x, k, capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)


def test_route_tie_picks_the_lower_expert_id():
    # ties everywhere: equal logits, and a pair tied below a clear winner
    logits = np.array([[[0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                        [0.1, 0.9, 0.3, 0.9, 0.3, 0.0],
                        [2.0, -1.0, 2.0, 2.0, -1.0, 3.0]]], dtype=np.float32)
    for k in (1, 2, 3, 4):
        want_ids, want_w = jax_moe._route(jnp.asarray(logits), k)
        ids, w = moe._route(_t(logits), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids), err_msg=f"k={k}")
        np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-7, rtol=1e-6)
    assert moe._route(_t(logits), 2)[0][0, 0].tolist() == [0, 1]


def test_combine_sums_in_sorted_assignment_order():
    # bf16 rounds each add: the port's combine must add a token's k rows in
    # ascending expert id from zeros, as the reference's scatter-add does
    e, k, s, d = 8, 4, 6, 16
    gen = torch.Generator().manual_seed(0)
    ids = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(s)])[None]
    weights = torch.softmax(torch.randn((1, s, k), generator=gen), dim=-1)
    x = torch.randn((1, s, d), generator=gen).bfloat16()
    xg, meta = moe._dispatch_rows(x, ids, e, s)
    y = (torch.randn(xg.shape, generator=gen) * 3).bfloat16()
    got = moe._combine_rows(y, meta, weights, s)
    jmeta = tuple(jnp.asarray(m[0].numpy()) for m in meta)
    want = jax_moe._combine_row(jnp.asarray(y[0].float().numpy()).astype(jnp.bfloat16), jmeta,
                                jnp.asarray(weights[0].numpy()), s, d)
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want.astype(jnp.float32)))


def _pair(arch, **overrides):
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32", **overrides)
    jcfg = jax_get_config(arch, **kw)
    cfg = configs.get_config(arch, **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S_PRE + S_DEC))
    return jcfg, jparams, cfg, params, tokens.astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_matches_reference(arch):
    jcfg, jparams, cfg, params, tokens = _pair(arch)
    want, _, want_aux = jax_transformer.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, _, aux = transformer.forward(params, cfg, tokens=_t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    assert "moe" in params["layers"][0] and "mlp" not in params["layers"][0]

    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    max_len = S_PRE + S_DEC
    jl, jcache, jt = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S_PRE])}, max_len)
    tl, cache, t = model.prefill(params, {"tokens": _t(tokens[:, :S_PRE])}, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(S_DEC):
        tok = tokens[:, S_PRE + i: S_PRE + i + 1]
        jl, jcache, jt = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), jt)
        tl, cache, t = model.decode_step(params, cache, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"{arch} step {i}", **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_teacher_forcing(arch):
    # capacity high enough that the forward drops nothing, as the reference's test
    cfg = configs.get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32",
                             capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S_PRE + S_DEC),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    full, _, _ = transformer.forward(params, cfg, tokens=tokens)
    logits, cache, t = model.prefill(params, {"tokens": tokens[:, :S_PRE]}, S_PRE + S_DEC)
    np.testing.assert_allclose(logits, full[:, S_PRE - 1], atol=2e-3, rtol=2e-3)
    for i in range(S_DEC):
        logits, cache, t = model.decode_step(params, cache, tokens[:, S_PRE + i: S_PRE + i + 1], t)
        np.testing.assert_allclose(logits, full[:, S_PRE + i], atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} step {i}")
