"""The port's AdamW and schedules against the reference's (``repro.optim``).

Ports of the four optimizer tests of ``tests/test_substrates.py``, each also
held to the reference on the same inputs: the schedules' values at every
step 0..N (float32, within 4 units in the last place, 2**-21 relative: the
same expressions, but torch's and XLA's float32 ``cos`` differ by up to 2
ulps, which a cosine schedule reaches), and AdamW's updates, moments and
metrics on equal gradients over several steps (float32, 1e-6).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro_torch.optim import (AdamW, apply_updates, constant, cosine_with_warmup,  # noqa: E402
                               global_norm, linear_with_warmup)

TOL = dict(atol=1e-6, rtol=1e-6)


def test_adamw_reduces_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {k: 2 * p for k, p in params.items()}  # d/dp of sum(p ** 2)
        updates, state, metrics = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    assert float(sum((p**2).sum() for p in params.values())) < 1e-3
    assert np.isfinite(float(metrics["grad_norm"]))


def test_adamw_clip_norm():
    opt = AdamW(learning_rate=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    updates, state, metrics = opt.update({"w": torch.tensor([100.0, 0.0, 0.0])},
                                         opt.init(params), params)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)
    # post-clip step magnitude bounded by lr * 1/sqrt(...) scale ~ lr
    assert float(updates["w"].abs().max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("name,args", [
    ("cosine_with_warmup", (1.0, 10, 100)),
    ("cosine_with_warmup", (3e-3, 5, 40, 0.2)),
    ("linear_with_warmup", (2.0, 7, 50)),
    ("linear_with_warmup", (1.0, 0, 30, 0.1)),
    ("constant", (3e-3,)),
])
def test_schedules_match_reference(name, args):
    fn = {"cosine_with_warmup": cosine_with_warmup, "linear_with_warmup": linear_with_warmup,
          "constant": constant}[name](*args)
    jfn = getattr(jax_optim, name)(*args)
    steps = np.arange(0, 121, dtype=np.int32)
    got = np.array([float(fn(torch.tensor(s, dtype=torch.int32))) for s in steps])
    want = np.array([float(jfn(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2.0**-21, atol=0)
    if name == "cosine_with_warmup" and args == (1.0, 10, 100):  # test_cosine_schedule_shape
        xs = got[[0, 5, 10, 50, 100]]
        assert xs[0] == 0.0 and xs[1] == pytest.approx(0.5)
        assert xs[2] == pytest.approx(1.0)
        assert xs[2] > xs[3] > xs[4]
        assert xs[4] == pytest.approx(0.1, rel=1e-3)


def test_weight_decay_only_on_matrices():
    opt = AdamW(learning_rate=1.0, weight_decay=0.5)
    params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    updates, _, _ = opt.update(grads, opt.init(params), params)
    assert float(updates["w"].abs().sum()) > 0  # decay applied
    assert float(updates["b"].abs().sum()) == 0  # biases not decayed


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_updates_match_reference(clip_norm):
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "k": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sched = (cosine_with_warmup(1e-2, 2, 10), jax_optim.cosine_with_warmup(1e-2, 2, 10))
    opt = AdamW(sched[0], clip_norm=clip_norm)
    jopt = jax_optim.AdamW(sched[1], clip_norm=clip_norm)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = opt.init(p), jopt.init(jp)
    for step in range(5):
        grads = {k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        upd, state, metrics = opt.update({k: torch.from_numpy(g) for k, g in grads.items()},
                                         state, p)
        jupd, jstate, jmetrics = jopt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                             jstate, jp)
        for k in shapes:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), err_msg=k, **TOL)
            np.testing.assert_allclose(state.m[k].numpy(), np.asarray(jstate.m[k]), **TOL)
            np.testing.assert_allclose(state.v[k].numpy(), np.asarray(jstate.v[k]), **TOL)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), **TOL)
        assert int(state.count) == int(jstate.count) == step + 1
        p, jp = apply_updates(p, upd), jax_optim.apply_updates(jp, jupd)
        for k in shapes:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(float(global_norm(p)), float(jax_optim.global_norm(jp)), **TOL)
