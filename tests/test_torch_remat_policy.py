"""``remat_policy="block_outs"`` at TP 2 on thread ranks, against ``"full"`` and the reference.

The reference names each block's two post-sum outputs ``"block_out"``
(``repro/models/transformer.py:366``, ``:376``) and, under ``"block_outs"``,
saves only them (``:444-449``), so the backward's recompute re-runs no
collective.  The port keeps them from the forward on a ``SavedSums`` of the
block's checkpoint and hands them back to the recompute
(``tensor_parallel.saving_sums``).  Every model rank is a thread of this
process (``tests/torch_tp_threads.py``), on the same seeded numpy batch.

* The backward's recompute runs no sum over the model group under
  ``"block_outs"``.  Under ``"full"`` it runs one a layer: the attention's.
  The MLP's sum comes after the block's last saved tensor, so the
  non-reentrant checkpoint's recompute stops before it (where XLA's remat
  of the reference re-runs both).  Sequence parallelism's sums (the
  reduce-scatters out of a region) are counted the same way.
* Loss and every gradient are bitwise ``"full"``'s, in float32.
* Every gradient, assembled from the rank shards, is within 1e-4 of the
  reference's ``jax.value_and_grad`` under ``remat_policy="block_outs"``
  (of each leaf's largest reference gradient, as
  ``tests/test_torch_train_grads.py`` holds them), the reference's weights
  carried across with ``params_from_jax``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, convert  # noqa: E402
from test_torch_dryrun_cuda import remat_sums  # noqa: E402
from torch_tp_threads import assemble, sharded_dims  # noqa: E402

KW = dict(smoke=True, param_dtype="float32", compute_dtype="float32")
GRAD_RTOL = 1e-4  # of each leaf's largest reference gradient
SIZE = 2


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _run(arch: str, policy: str, **overrides):
    cfg = get_config(arch, remat_policy=policy, **KW, **overrides)
    jcfg = jax_get_config(arch, remat_policy=policy, **KW, **overrides)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    batch = _batch(cfg)
    ranks = remat_sums(build_model(cfg), params, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()}, SIZE)
    return cfg, jcfg, jparams, params, batch, ranks


@pytest.mark.parametrize("arch,overrides", [("qwen2-1.5b", {}),
                                            ("qwen2-1.5b", {"sequence_parallel": True}),
                                            ("starcoder2-3b", {})])
def test_block_outs_recompute_runs_no_sum_and_is_bitwise_full(arch, overrides):
    cfg, *_, full = _run(arch, "full", **overrides)
    *_, saved = _run(arch, "block_outs", **overrides)
    for r in range(SIZE):
        f_fwd, f_rec, f_loss, f_grads = full[r]
        s_fwd, s_rec, s_loss, s_grads = saved[r]
        # the embedding's, each block's two and the vocab-parallel cross-entropy's two
        assert f_fwd == s_fwd == 2 * cfg.n_layers + 3
        assert f_rec == cfg.n_layers, "full: the attention's sum a layer"
        assert s_rec == 0, "block_outs: no sum in the recompute"
        assert torch.equal(f_loss, s_loss)
        assert f_grads.keys() == s_grads.keys()
        for k in f_grads:
            assert torch.equal(f_grads[k], s_grads[k]), k


def test_block_outs_gradients_match_reference():
    cfg, jcfg, jparams, params, batch, ranks = _run("qwen2-1.5b", "block_outs")
    jmodel = jax_build_model(jcfg)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ranks[0][2]), float(jloss), atol=1e-4, rtol=1e-4)
    got = assemble([r[3] for r in ranks], sharded_dims(params.leaves(), SIZE))
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, device="cpu").leaves()
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = w.detach().numpy().astype(np.float64)
        g = got[k].detach().numpy().astype(np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_RTOL * scale, k



@pytest.mark.parametrize("policy", ["full", "block_outs"])
def test_recompute_on_another_thread_keeps_the_model_group(policy):
    """Autograd may run a backward on a thread of its own (a CUDA device's):
    the recompute runs under the forward's ``logical_axes`` context there
    too, so a TP 2 backward started on fresh threads, with no context, gives
    the gradients of one started inside it, bitwise."""
    import threading

    import torch_tp_threads as th

    cfg = get_config("qwen2-1.5b", remat_policy=policy, **KW)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    want = [r[3] for r in remat_sums(model, params, batch, SIZE)]
    losses = th.run_ranks(SIZE, lambda r, g: (lambda p: (model.train_loss(p, batch)[0], p))(
        th.rank_params(params, SIZE, r, trainable=True)))
    got, errors = [None] * SIZE, []

    def backward(r):  # a thread with no logical_axes context
        try:
            with torch.autograd.set_multithreading_enabled(False):
                loss, p = losses[r]
                leaves = p.leaves()
                got[r] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=backward, args=(r,)) for r in range(SIZE)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and all(not t.is_alive() for t in threads), errors
    for r in range(SIZE):
        for k, g in want[r].items():
            assert torch.equal(got[r][k], g), (r, k)
