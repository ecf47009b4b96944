"""Every family's ``train_loss`` and its gradients against the reference's ``jax.value_and_grad``.

Each of the 10 configurations in its smoke size, float32 weights and compute,
the reference's weights carried across with ``params_from_jax``.  The batch
is ``tests/test_arch_smoke.py::_make_batch``'s (B 2, S 16: tokens, or
embeddings for the VLM and the encoder with arange M-RoPE ids for the VLM;
labels; a mask of ones), drawn with numpy so both packages read one batch.
The loss and its metrics agree to 1e-4 (atol and rtol), as the logits do in
``tests/test_torch_model.py``; every leaf's gradient agrees to 1e-4 of that
leaf's largest reference gradient (``max |got - want| <= 1e-4 * max |want|``),
since a gradient's scale varies by orders of magnitude from leaf to leaf.
Both sides remat by default: the port's per-block checkpoint must give the
gradient the reference's ``jax.checkpoint`` gives.

Every leaf the forward reads gets a gradient (not ``None``): a cast for
compute must keep its autograd edge to the master weight.  Only the
embedding table of a model fed embeddings (the VLM, the encoder), which no
forward reads, has none; the reference's gradient there is zero.  The models
run on the CPU, so every norm and attention runs its kernel's plain version
inside the kernel's ``torch.autograd.Function`` and differentiates through
its closed-form backward.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import build_model, convert  # noqa: E402

B, S = 2, 16
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-4  # of each leaf's largest reference gradient
KW = dict(smoke=True, param_dtype="float32", compute_dtype="float32")


def make_batch(cfg, seed: int = 1) -> dict:
    """``tests/test_arch_smoke.py::_make_batch``'s fields and shapes, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family in ("vlm", "encoder"):
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3))
        batch["mrope_positions"] = np.ascontiguousarray(pos)
    batch["labels"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch["loss_mask"] = np.ones((B, S), np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg = jax_get_config(arch, **KW), get_config(arch, **KW)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = make_batch(cfg)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))
    (jloss, jmetrics), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    params.trainable()
    loss, metrics = model.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert metrics.keys() == jmetrics.keys()
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]),
                                   err_msg=name, **LOSS_TOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg, device="cpu").leaves()
    got = params.leaves()
    assert got.keys() == want.keys()
    unread = {"embed"} if cfg.family in ("vlm", "encoder") else set()
    for path, leaf in got.items():
        w = want[path].numpy()
        if leaf.grad is None:
            assert path in unread, f"{arch}: {path} has no gradient"
            assert not w.any(), f"{arch}: {path} has none, the reference's is nonzero"
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(leaf.grad.numpy() - w).max())
        assert err <= GRAD_RTOL * scale, \
            f"{arch} {path}: max |err| {err:.3e}, max |want| {scale:.3e}"
