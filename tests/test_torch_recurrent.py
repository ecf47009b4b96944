"""The port's RG-LRU blocks and hybrid model against the reference's.

``repro_torch.models.rglru`` / ``hybrid`` against ``repro.models.rglru`` /
``hybrid`` on the reference's weights, float32 on both sides.  The scan is a
log-depth Hillis-Steele scan where the reference uses
``jax.lax.associative_scan``: the same combine in another tree, so it is
held to the reference's scan and its sequential loop within the reference's
own 1e-5 (``tests/test_model_numerics.py``).  The recurrentgemma-2b smoke
model (one (R, R, A) group and an (R, R) tail, window 8) within 1e-4, as the
dense models.  A prompt longer than the window is held to the reference's
cache-free ``forward``: the reference's own prefill attends every prompt
query over the ring alone and is wrong there (``ROADMAP.md`` §3), and the
port repairs it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, convert, hybrid, rglru  # noqa: E402

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "recurrentgemma-2b"
B, S_PRE, S_DEC = 2, 7, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(d, seed, d_model=None):
    jparams = jax_rglru.init_rglru_block(jax.random.key(seed), d_model or d, d, 4, jnp.float32)
    return jparams, {k: _t(v) for k, v in jparams.items()}


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference_scan_and_loop(with_h0):
    jparams, params = _block(16, 0)
    jx = jax.random.normal(jax.random.key(1), (2, 20, 16))
    jh0 = jax.random.normal(jax.random.key(2), (2, 16)) if with_h0 else None
    h0 = None if jh0 is None else _t(jh0)
    y, h = rglru.rglru_scan(params, _t(jx), 8.0, h0)
    for name, fn in (("scan", jax_rglru.rglru_scan), ("loop", jax_rglru.rglru_reference)):
        want_y, want_h = fn(jparams, jx, 8.0, jh0)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), err_msg=name, **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), err_msg=name, **SCAN_TOL)
    # and the port's own loop oracle
    ly, lh = rglru.rglru_reference(params, _t(jx), 8.0, h0)
    np.testing.assert_allclose(y.numpy(), ly.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), lh.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 9, 33])
def test_rglru_scan_at_every_depth(s):
    # lengths around powers of two: the last Hillis-Steele step is partial
    jparams, params = _block(8, 4)
    jx = jax.random.normal(jax.random.key(5), (1, s, 8))
    want_y, want_h = jax_rglru.rglru_reference(jparams, jx, 8.0)
    y, h = rglru.rglru_scan(params, _t(jx), 8.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_rglru_step_continues_scan():
    jparams, params = _block(8, 2)
    x = _t(jax.random.normal(jax.random.key(3), (1, 9, 8)))
    y_full, h_full = rglru.rglru_scan(params, x, 8.0)
    _, h8 = rglru.rglru_scan(params, x[:, :8], 8.0)
    y_step, h9 = rglru.rglru_step(params, x[:, 8], h8, 8.0)
    np.testing.assert_allclose(y_step.numpy(), y_full[:, 8].numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h9.numpy(), h_full.numpy(), **SCAN_TOL)
    want_y, want_h = jax_rglru.rglru_step(jparams, jnp.asarray(x[:, 8].numpy()),
                                          jnp.asarray(h8.numpy()), 8.0)
    np.testing.assert_allclose(y_step.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h9.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_recurrent_block_apply_and_step_match_reference():
    # the whole temporal-mixing block, its conv tail and state carried into a step
    # (the tail is x @ w_x: a product summed in another order, so not bitwise)
    jparams, params = _block(32, 6, d_model=24)
    jx = jax.random.normal(jax.random.key(7), (2, 10, 24))
    want, (want_tail, want_h) = jax_rglru.recurrent_block_apply(jparams, jx, 8.0,
                                                                return_state=True)
    got, (tail, h) = rglru.recurrent_block_apply(params, _t(jx), 8.0, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(want_tail), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)
    jx1 = jax.random.normal(jax.random.key(8), (2, 1, 24))
    want_o, want_t, want_h1 = jax_rglru.recurrent_block_step(jparams, jx1, 8.0, want_tail, want_h)
    got_o, got_t, got_h1 = rglru.recurrent_block_step(params, _t(jx1), 8.0, tail, h)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **SCAN_TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **SCAN_TOL)
    np.testing.assert_allclose(got_h1.numpy(), np.asarray(want_h1), **SCAN_TOL)


def _pair(**overrides):
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32", **overrides)
    jcfg = jax_get_config(ARCH, **kw)
    cfg = configs.get_config(ARCH, **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, n):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)


def test_hybrid_model_matches_reference():
    jcfg, jparams, cfg, params = _pair()
    assert len(params["groups"]) == 1 and len(params["tail"]) == 2
    assert sorted(params["groups"][0].keys()) == ["attn_2", "rglru_0", "rglru_1"]
    tokens = _tokens(cfg, S_PRE + S_DEC)
    want, _ = jax_hybrid.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = hybrid.forward(params, cfg, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # prompt 7 <= window 8: the reference's prefill is right, and the port equals it
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    max_len = S_PRE + S_DEC
    jl, jcache, jt = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S_PRE])}, max_len)
    tl, cache, t = model.prefill(params, {"tokens": _t(tokens[:, :S_PRE])}, max_len)
    assert t == int(jt) == S_PRE
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(S_DEC):
        tok = tokens[:, S_PRE + i: S_PRE + i + 1]
        jl, jcache, jt = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), jt)
        tl, cache, t = model.decode_step(params, cache, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
    # the caches agree: conv tails and states of the tail's RG-LRU, the ring's positions
    np.testing.assert_allclose(cache["tail"][1]["h"].numpy(), np.asarray(jcache["tail"][1]["h"]),
                               **TOL)
    np.testing.assert_allclose(cache["tail"][0]["conv"].numpy(),
                               np.asarray(jcache["tail"][0]["conv"]), **TOL)
    np.testing.assert_array_equal(cache["groups"][0]["attn_2"]["pos"].numpy(),
                                  np.asarray(jcache["groups"]["attn_2"]["pos"][0]))


def test_prompt_longer_than_window_matches_cache_free_forward():
    # window 8, prompt 20: the port's prefill and decode equal the reference's
    # cache-free forward; the reference's own prefill does not
    jcfg, jparams, cfg, params = _pair()
    n_pre, n_dec = 20, 4
    tokens = _tokens(cfg, n_pre + n_dec)
    full, _ = jax_hybrid.forward(jparams, jcfg, jnp.asarray(tokens))
    full = np.asarray(full)
    model = build_model(cfg)
    logits, cache, t = model.prefill(params, {"tokens": _t(tokens[:, :n_pre])}, n_pre + n_dec)
    assert cache["groups"][0]["attn_2"]["k"].shape[1] == cfg.window < n_pre
    np.testing.assert_allclose(logits.numpy(), full[:, n_pre - 1], **TOL)
    for i in range(n_dec):
        logits, cache, t = model.decode_step(params, cache,
                                             _t(tokens[:, n_pre + i: n_pre + i + 1]), t)
        np.testing.assert_allclose(logits.numpy(), full[:, n_pre + i], err_msg=f"step {i}",
                                   **TOL)
    jl, _, _ = jax_build_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :n_pre])}, n_pre + n_dec)
    assert np.abs(np.asarray(jl) - full[:, n_pre - 1]).max() > 1e-2, \
        "the reference's windowed prefill fault is gone: revisit ROADMAP.md §3"


def test_hybrid_decode_matches_teacher_forcing():
    cfg = configs.get_config(ARCH, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    n_pre, n_dec = 11, 6  # the prompt outgrows the window, decode wraps the ring
    tokens = torch.randint(0, cfg.vocab_size, (B, n_pre + n_dec),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    full, _ = hybrid.forward(params, cfg, tokens)
    logits, cache, t = model.prefill(params, {"tokens": tokens[:, :n_pre]}, n_pre + n_dec)
    np.testing.assert_allclose(logits, full[:, n_pre - 1], atol=2e-3, rtol=2e-3)
    for i in range(n_dec):
        logits, cache, t = model.decode_step(params, cache, tokens[:, n_pre + i: n_pre + i + 1], t)
        np.testing.assert_allclose(logits, full[:, n_pre + i], atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {i}")


def test_hybrid_init_matches_reference_layout():
    from repro.models import common as jax_common
    from repro_torch.models import common

    _, jparams, cfg, params = _pair()
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert common.count_params(own) == common.count_params(params) \
        == jax_common.count_params(jparams)
    assert sorted(n for n, _ in own.named_parameters()) == \
        sorted(n for n, _ in params.named_parameters())
    lam = own["groups"][0]["rglru_0"]["rglru"]["lam"]
    a_c = torch.exp(-torch.nn.functional.softplus(lam))  # a^c at r = 1, c = 1
    assert lam.dtype == torch.float32 and bool(((a_c > 0.9) & (a_c < 0.999)).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg).train_loss(own, {})
