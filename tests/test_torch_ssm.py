"""The port's SSD blocks and Mamba-2 model against the reference's.

``repro_torch.models.ssm`` / ``mamba`` against ``repro.models.ssm`` /
``mamba`` on the reference's weights and inputs, float32 on both sides.  The
chunk loop is a Python loop where the reference scans, and its
three-operand ``einsum``s may contract in another order than XLA's, so the
chunked scan is held to the reference's chunked scan and its sequential
oracle within the reference's own 1e-4 (``tests/test_model_numerics.py``),
at chunks that pad the sequence and chunks that do not.  The mamba2-2.7b
smoke model within 1e-4, as the dense models.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import build_model, convert, mamba, ssm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-2.7b"
B, S_PRE, S_DEC = 2, 7, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, s, nh, hp, n, d_skip=1.0):
    ks = jax.random.split(jax.random.key(seed), 5)
    x = jax.random.normal(ks[0], (b, s, nh, hp))
    dt = jax.nn.softplus(jax.random.normal(ks[1], (b, s, nh)))
    a_neg = -jnp.exp(jax.random.normal(ks[2], (nh,)) * 0.3)
    bmat = jax.random.normal(ks[3], (b, s, n))
    cmat = jax.random.normal(ks[4], (b, s, n))
    return x, dt, a_neg, bmat, cmat, jnp.full((nh,), d_skip)


@pytest.mark.parametrize("s", [12, 24])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk, s):
    # S = 12 pads at chunk 8, S = 24 at chunk 16; chunk 16 over S = 12 is one chunk of 12
    jin = _inputs(0, 2, s, 3, 8, 4)
    tin = [_t(a) for a in jin]
    y, h = ssm.ssd_chunked(*tin, chunk)
    for name, (want_y, want_h) in (("chunked", jax_ssm.ssd_chunked(*jin, chunk)),
                                   ("sequential", jax_ssm.ssd_reference(*jin))):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), err_msg=name, **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), err_msg=name, **TOL)
    ry, rh = ssm.ssd_reference(*tin)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), rh.numpy(), **TOL)


def test_ssd_carried_state():
    """Splitting a sequence in two with carried state == one pass, as the reference's."""
    x, dt, a_neg, bm, cm, d_skip = (_t(a) for a in _inputs(1, 1, 16, 2, 4, 4, d_skip=0.0))
    y_full, h_full = ssm.ssd_chunked(x, dt, a_neg, bm, cm, d_skip, 4)
    half = 8
    y1, h1 = ssm.ssd_chunked(x[:, :half], dt[:, :half], a_neg, bm[:, :half], cm[:, :half],
                             d_skip, 4)
    y2, h2 = ssm.ssd_chunked(x[:, half:], dt[:, half:], a_neg, bm[:, half:], cm[:, half:],
                             d_skip, 4, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), **TOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), **TOL)
    jin = [jnp.asarray(a.numpy()) for a in (x, dt, a_neg, bm, cm, d_skip)]
    want_y, want_h = jax_ssm.ssd_chunked(*(a[:, half:] if a.ndim > 1 else a for a in jin), 4,
                                         h0=jnp.asarray(h1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(want_h), **TOL)


def _layer(seed=0):
    cfg = configs.get_config(ARCH, smoke=True)
    dims = ssm.SSMDims.from_config(cfg)
    jdims = jax_ssm.SSMDims.from_config(jax_get_config(ARCH, smoke=True))
    assert tuple(dims) == tuple(jdims)
    jparams = jax_ssm.init_ssm_layer(jax.random.key(seed), jdims, jnp.float32)
    return dims, jdims, jparams, {k: _t(v) for k, v in jparams.items()}


def test_mixer_and_decode_step_match_reference():
    dims, jdims, jparams, params = _layer()
    jx = jax.random.normal(jax.random.key(3), (2, 13, dims.d_model))
    want, (wtx, wtbc, wh) = jax_ssm.ssm_layer_apply(jparams, jdims, jx, return_state=True)
    got, (tx, tbc, h) = ssm.ssm_layer_apply(params, dims, _t(jx), return_state=True)
    for name, a, b in (("y", got, want), ("tail_x", tx, wtx), ("tail_bc", tbc, wtbc),
                       ("h", h, wh)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    jx1 = jax.random.normal(jax.random.key(4), (2, 1, dims.d_model))
    want = jax_ssm.ssm_decode_step(jparams, jdims, jx1, wtx, wtbc, wh)
    got = ssm.ssm_decode_step(params, dims, _t(jx1), tx, tbc, h)
    for name, a, b in zip(("y", "tail_x", "tail_bc", "h"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_causal_conv_matches_reference():
    gen = np.random.default_rng(5)
    x, w, b = (gen.standard_normal(s).astype(np.float32) for s in ((2, 6, 10), (4, 10), (10,)))
    tail = gen.standard_normal((2, 3, 10)).astype(np.float32)
    for t in (None, tail):
        want, want_tail = jax_ssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                               None if t is None else jnp.asarray(t))
        got, got_tail = ssm._causal_conv(_t(x), _t(w), _t(b), None if t is None else _t(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


def _pair():
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32")
    jcfg = jax_get_config(ARCH, **kw)
    cfg = configs.get_config(ARCH, **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def test_mamba_model_matches_reference():
    jcfg, jparams, cfg, params = _pair()
    assert len(params["layers"]) == cfg.n_layers
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               size=(B, S_PRE + S_DEC)).astype(np.int32)
    want, _ = jax_mamba.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = mamba.forward(params, cfg, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

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
    for name in ("conv_x", "conv_bc", "h"):
        np.testing.assert_allclose(cache[1][name].numpy(), np.asarray(jcache[name][1]),
                                   err_msg=name, **TOL)


def test_mamba_decode_matches_teacher_forcing():
    cfg = configs.get_config(ARCH, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    n_pre, n_dec = 11, 5  # the prompt pads its last chunk of 8
    tokens = torch.randint(0, cfg.vocab_size, (B, n_pre + n_dec),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    full, _ = mamba.forward(params, cfg, tokens)
    logits, cache, t = model.prefill(params, {"tokens": tokens[:, :n_pre]}, n_pre + n_dec)
    np.testing.assert_allclose(logits, full[:, n_pre - 1], atol=2e-3, rtol=2e-3)
    for i in range(n_dec):
        logits, cache, t = model.decode_step(params, cache, tokens[:, n_pre + i: n_pre + i + 1], t)
        np.testing.assert_allclose(logits, full[:, n_pre + i], atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {i}")


def test_mamba_init_matches_reference_layout():
    from repro.models import common as jax_common
    from repro_torch.models import common

    jcfg, jparams, cfg, params = _pair()
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert common.count_params(own) == common.count_params(params) \
        == jax_common.count_params(jparams)
    assert sorted(n for n, _ in own.named_parameters()) == \
        sorted(n for n, _ in params.named_parameters())
    mixer = own["layers"][0]["mixer"]
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt > 0.999e-3) & (dt < 1.001e-1)).all())
    a = torch.exp(mixer["A_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    served = build_model(configs.get_config(ARCH, smoke=True)).for_serving(own)
    assert served["layers"][0]["mixer"]["w_x"].dtype == torch.bfloat16
    assert served["layers"][0]["mixer"]["A_log"].dtype == torch.float32
    # the training path is ported: the loss on the reference's weights is the reference's
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(B, 12)).astype(np.int32)
             for k in ("tokens", "labels")}
    want, _ = jax_build_model(jcfg).train_loss(jparams, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    got, metrics = build_model(cfg).train_loss(params, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    assert set(metrics) == {"loss"}
    np.testing.assert_allclose(got.item(), float(want), atol=1e-4, rtol=1e-4)
