"""The port's training path against the reference's: loss, train step, flows.

* ``cross_entropy_loss`` and its gradient against the reference's (padded
  vocabulary, a weighted mask, z-loss, an empty mask), float32: 1e-6.
* One ``make_train_step`` step on the dense smoke model with
  ``scan_layers=False`` (the reference then decays what the port decays,
  ``ROADMAP.md`` §3), the reference's weights carried across, float32
  compute: both moments and every metric within 1e-5 (atol and rtol), and
  every parameter whose clipped gradient ``g`` is resolved (``|g| >= 100
  eps``) too.  The first AdamW step moves a parameter by ``lr g / (|g| +
  eps)`` (plus decay): the sign of ``g`` where ``|g| >> eps``, and an
  ill-conditioned function of it where ``|g|`` is near ``eps = 1e-8``.
  0.15 % of the smoke model's gradient elements lie below ``100 eps`` (the
  tail of their spread, the key biases' most: a bias shared by every key
  barely moves a softmax, RoPE leaves little of it, and it is computed by
  cancellation), where float32 summation order alone moves the step of 5
  elements by up to 7e-5.  Those elements (at most 1 % of the model,
  checked) are held through their moments, which agree to 1e-9.
* ``microbatches=4`` against one batch, in both packages, within the 5e-4
  of ``tests/test_distributed_multidev.py:99``.
* Ports of ``tests/test_integration.py``'s training tests (the loss falls;
  a restart from a checkpoint continues bitwise on the CPU; remat off /
  full / ``block_outs`` and ``sequence_parallel`` leave the loss alone,
  1e-5) and of ``examples/train_lm.py``'s flow at fewer steps (a crash at
  half, a restore from disk, a replan for 14 survivors, the loss still
  falling); the launcher's command line (its lines, report, checkpoints
  and ``--resume``); remat off against on for the hybrid, Mamba-2 and MoE
  families (1e-6 of each leaf's largest gradient: the same operations
  run again).
* The pin of the reference's AdamW fault: with zero gradients and
  ``weight_decay=0.5`` its update moves the stacked ``layers.norm1`` under
  ``scan_layers=True`` and the port's does not move any norm or bias.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.runtime.train import init_state as jax_init_state  # noqa: E402
from repro.runtime.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.service_time import ShiftedExponential  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import rdp  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import build_model, common, convert  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.runtime.train import TrainState, init_state, make_train_step  # noqa: E402

STEP_TOL = dict(atol=1e-5, rtol=1e-5)
MICRO_TOL = dict(atol=5e-4, rtol=5e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ the loss


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("mask_kind", ["none", "weights", "empty"])
def test_cross_entropy_matches_reference(z_loss, mask_kind):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 33, size=(2, 5)).astype(np.int32)
    mask = {"none": None,
            "weights": rng.integers(0, 3, size=(2, 5)).astype(np.float32),
            "empty": np.zeros((2, 5), np.float32)}[mask_kind]

    def ref(lg):
        m = None if mask is None else jnp.asarray(mask)
        return jax_common.cross_entropy_loss(lg, jnp.asarray(labels), m, real_vocab=33,
                                             z_loss=z_loss)

    want, want_grad = jax.value_and_grad(ref)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = common.cross_entropy_loss(x, torch.from_numpy(labels),
                                    None if mask is None else torch.from_numpy(mask),
                                    real_vocab=33, z_loss=z_loss)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=1e-6)
    assert not x.grad[..., 33:].any()  # the padded vocabulary takes no gradient


# ------------------------------------------------------------------ one step


def _reference_step_pair(steps=40, microbatches=1, lr=None, weight_decay=0.1, **overrides):
    """The dense smoke model in both packages on the reference's weights:
    ``(jax state, jax step, port state, port step, a batch as numpy)``."""
    kw = dict(smoke=True, scan_layers=False, **F32, **overrides)
    jcfg, cfg = jax_get_config("qwen2-1.5b", **kw), get_config("qwen2-1.5b", **kw)
    sched = (jax_cosine(3e-3, 5, steps), cosine_with_warmup(3e-3, 5, steps)) if lr is None \
        else (lr, lr)
    jopt = JaxAdamW(sched[0], weight_decay=weight_decay)
    opt = AdamW(sched[1], weight_decay=weight_decay)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jstate = jax_init_state(jmodel, jopt, jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg,
                                     device="cpu").trainable()
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 8, seed=0))
    return (jstate, jax.jit(jax_make_train_step(jmodel, jopt, microbatches=microbatches)),
            state, make_train_step(model, opt, microbatches=microbatches),
            pipe.global_batch(0), cfg)


def _tree_by_path(tree, cfg):
    """The reference's per-layer-list tree as the port's ``{path: array}``."""
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu").leaves()


def test_one_train_step_matches_reference():
    jstate, jstep, state, step, batch, cfg = _reference_step_pair()
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = step(state, _t(batch))
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt_state.count) == int(jnew.opt_state.count) == 1
    assert m.keys() == jm.keys()
    for name in m:
        np.testing.assert_allclose(_np(m[name]), np.asarray(jm[name]), err_msg=name, **STEP_TOL)
    want_m = _tree_by_path(jnew.opt_state.m, cfg)
    for got, want, what in ((new.opt_state.m, want_m, "m"),
                            (new.opt_state.v, _tree_by_path(jnew.opt_state.v, cfg), "v")):
        assert got.keys() == want.keys()
        for path in got:
            np.testing.assert_allclose(_np(got[path]), want[path].numpy(),
                                       err_msg=f"{what} {path}", **STEP_TOL)
    got, want = new.params.leaves(), _tree_by_path(jnew.params, cfg)
    assert got.keys() == want.keys()
    n_unresolved = n_all = 0
    for path in got:
        g = np.abs(want_m[path].numpy()) / 0.1  # |g| = |m| / (1 - b1)
        resolved = (g >= 100 * 1e-8) | (g == 0)
        n_unresolved += int((~resolved).sum())
        n_all += resolved.size
        np.testing.assert_allclose(_np(got[path])[resolved], want[path].numpy()[resolved],
                                   err_msg=f"param {path}", **STEP_TOL)
    assert n_unresolved <= 1e-2 * n_all, (n_unresolved, n_all)
    # the step is functional: the state it was given is unchanged
    assert int(state.step) == 0 and not any(v.any() for v in state.opt_state.m.values())
    assert all(p.requires_grad for p in new.params.leaves().values())


def test_microbatched_step_matches_full_batch():
    jstate, jstep, state, step, batch, _ = _reference_step_pair(lr=1e-2, weight_decay=0.0)
    _, jstep4, _, step4, _, _ = _reference_step_pair(lr=1e-2, weight_decay=0.0, microbatches=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jref, jm = jstep(jstate, jbatch)
    jmb, jm4 = jstep4(jstate, jbatch)
    ref, m = step(state, _t(batch))
    mb, m4 = step4(state, _t(batch))
    for got, want, what in ((m4, m, "port"), (jm4, jm, "reference")):
        np.testing.assert_allclose(_np(got["loss"]), _np(want["loss"]), err_msg=what,
                                   atol=1e-4, rtol=1e-4)
    for path, leaf in mb.params.leaves().items():
        np.testing.assert_allclose(_np(leaf), _np(ref.params.leaves()[path]),
                                   err_msg=path, **MICRO_TOL)
    jleaves = zip(jax.tree.leaves(jmb.params), jax.tree.leaves(jref.params))
    for a, b in jleaves:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **MICRO_TOL)


# ------------------------------------------------------------------ trajectories


def loss_trajectories(steps: int, seq: int, batch: int, n_layers=None, **overrides) -> tuple:
    """Both packages' losses and grad norms over ``steps`` train steps of
    qwen2-1.5b from the reference's weights: float32 compute,
    ``scan_layers=False`` (both then decay the same leaves), the launcher's
    schedule ``cosine_with_warmup(3e-3, max(steps // 20, 1), steps)`` and
    ``SyntheticLM``'s batches.  Returns ``(reference, port, port params at
    step 0)``, each side a list of ``(loss, grad_norm)``; the reference runs
    first and its state is dropped before the port's is made.  ``n_layers``
    cuts the depth."""
    kw = dict(scan_layers=False, **F32, **overrides)
    jcfg, cfg = jax_get_config("qwen2-1.5b", **kw), get_config("qwen2-1.5b", **kw)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    warm = max(steps // 20, 1)
    jopt, opt = JaxAdamW(jax_cosine(3e-3, warm, steps)), AdamW(cosine_with_warmup(3e-3, warm,
                                                                                 steps))
    jmodel = jax_build_model(jcfg)
    jstate = jax_init_state(jmodel, jopt, jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg,
                                     device="cpu").trainable()
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, seq, batch, seed=0))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt))
    ref = []
    for s in range(steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in pipe.global_batch(s).items()})
        ref.append((float(jm["loss"]), float(jm["grad_norm"])))
    del jstate, jstep
    step = make_train_step(build_model(cfg), opt)
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    port = []
    for s in range(steps):
        state, m = step(state, _t(pipe.global_batch(s)))
        port.append((float(m["loss"]), float(m["grad_norm"])))
    return ref, port, params


def test_loss_trajectory_matches_reference():
    """Six steps of the smoke model at the launcher's schedule: every step's
    loss and grad norm within 1e-5 of the reference's (relative; the steps
    after the first also carry the first step's ill-conditioned elements,
    see the one-step test)."""
    ref, port, _ = loss_trajectories(6, 32, 8, smoke=True)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=0)


# ------------------------------------------------------------------ integration


def _setup(steps=40, seq=32, batch=8, **overrides):
    cfg = get_config("qwen2-1.5b", smoke=True, **overrides)
    model = build_model(cfg)
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, seq, batch, seed=0))
    opt = AdamW(cosine_with_warmup(3e-3, 5, steps))
    return cfg, model, pipe, opt, make_train_step(model, opt)


def _init(model, opt):
    return init_state(model, opt, torch.Generator().manual_seed(0))


def test_training_reduces_loss():
    cfg, model, pipe, opt, step = _setup(steps=60)
    state = _init(model, opt)
    losses = []
    for s in range(60):
        state, m = step(state, _t(pipe.global_batch(s)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert all(np.isfinite(losses))


def test_restart_determinism(tmp_path):
    """Stop at step k, restore, continue: the loss stream is bitwise the
    uninterrupted run's (checkpoint/restart is exact)."""
    total, k = 20, 10
    cfg, model, pipe, opt, step = _setup(steps=total)
    state = _init(model, opt)
    ref_losses = []
    mgr = CheckpointManager(tmp_path, keep=1)
    for s in range(total):
        state, m = step(state, _t(pipe.global_batch(s)))
        ref_losses.append(float(m["loss"]))
        if s == k - 1:
            mgr.save(k, state)

    # restart from the checkpoint (fresh everything)
    cfg2, model2, pipe2, opt2, step2 = _setup(steps=total)
    state2, s0 = CheckpointManager(tmp_path).restore(_init(model2, opt2))
    assert s0 == k and int(state2.step) == k
    for s in range(k, total):
        state2, m = step2(state2, _t(pipe2.global_batch(s)))
        assert float(m["loss"]) == ref_losses[s], s


@pytest.mark.parametrize("overrides", [{"remat_policy": "block_outs"},
                                       {"sequence_parallel": True}, {"remat": False}])
def test_perf_flags_do_not_change_loss(overrides):
    """sequence_parallel / remat / remat_policy are numerics-neutral."""
    _, model, pipe, opt, step = _setup(steps=3)
    batch = _t(pipe.global_batch(0))
    _, m0 = step(_init(model, opt), batch)
    _, model2, _, _, step2 = _setup(steps=3, **overrides)
    new2, m2 = step2(_init(model2, opt), batch)
    assert float(m2["loss"]) == pytest.approx(float(m0["loss"]), abs=1e-5), overrides
    new0, _ = step(_init(model, opt), batch)
    for path, leaf in new2.params.leaves().items():
        np.testing.assert_allclose(_np(leaf), _np(new0.params.leaves()[path]), atol=1e-5,
                                   rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b", "qwen3-moe-235b-a22b"])
def test_remat_leaves_every_family_gradient_alone(arch):
    """The hybrid's per-group and Mamba-2's per-layer checkpoints (and the
    MoE block's) give the gradients of the plain forward: 1e-6 of each
    leaf's largest, float32 (the recompute runs the same operations)."""
    grads = []
    for remat in (True, False):
        cfg = get_config(arch, smoke=True, remat=remat, **F32)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0)).trainable()
        rng = np.random.default_rng(2)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)}
        loss, _ = model.train_loss(params, _t(batch))
        loss.backward()
        grads.append((loss.item(), {k: p.grad for k, p in params.leaves().items()}))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for path, g in grads[0][1].items():
        want = grads[1][1][path]
        assert g is not None and want is not None, path
        scale = float(want.abs().max())
        assert float((g - want).abs().max()) <= 1e-6 * max(scale, 1e-30), path


def test_train_lm_flow_crash_restore_replan(tmp_path):
    """``examples/train_lm.py`` at 120 steps: a 16-worker plan, a crash at
    half with a restore from disk, a replan for 14 survivors, and a loss
    that keeps falling."""
    steps, crash_at = 120, 60
    ctl = rdp.ElasticController(ShiftedExponential(delta=0.05, mu=5.0))
    plan = ctl.initial_plan(16)
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = build_model(cfg)
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, 64, 8, seed=1))
    opt = AdamW(cosine_with_warmup(3e-3, 20, steps))
    step_fn = make_train_step(model, opt)
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _init(model, opt)
    losses = []
    for step in range(steps):
        state, metrics = step_fn(state, _t(pipe.global_batch(step)))
        losses.append(float(metrics["loss"]))
        if step == crash_at:
            mgr.save(step, state)
            state, s = mgr.restore(_init(model, opt))  # a fresh process's state, from disk
            assert s == crash_at
            tr = ctl.on_membership_change(plan, n_healthy=14)
            assert tr.new_plan.n_workers == 14
            assert tr.new_plan.n_batches * tr.new_plan.replication == 14
    assert np.mean(losses[-10:]) < np.mean(losses[crash_at - 10: crash_at + 1])
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_launcher_plans_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train``: the reference's lines and
    report, checkpoints every ``--ckpt-every`` steps and at the end, and
    ``--resume`` from the newest; without a card it needs ``--device cpu``."""
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "6", "--seq-len", "16",
            "--ckpt-every", "3", "--log-every", "2", "--ckpt-dir", str(tmp_path)]
    assert train_launch.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("[plan] N=8 -> B=2 shards x r=4 replicas", "[model] qwen2-1.5b-smoke",
                 "step     0 loss", "[done] final loss", "[report]"):
        assert line in out, line
    run_dir = tmp_path / "qwen2-1.5b-smoke"
    report = json.loads((run_dir / "train_report.json").read_text())
    assert report["plan"]["B"] == 2 and report["plan"]["r"] == 4
    assert len(report["losses"]) == len(report["step_ms"]) == 6
    assert report["final_loss"] == report["losses"][-1] and report["device"] == "cpu"
    assert CheckpointManager(run_dir).all_steps() == [3, 6]
    assert train_launch.main(argv + ["--steps", "8", "--resume", "--device", "cpu"]) == 0
    assert "[resume] from step 6" in capsys.readouterr().out
    assert len(json.loads((run_dir / "train_report.json").read_text())["losses"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launch.main(argv)


# ------------------------------------------------------------------ the AdamW pin


def test_reference_decays_stacked_norms_the_port_does_not():
    """``repro/optim/adamw.py:73`` decays a leaf when ``p.ndim >= 2``; under
    ``scan_layers=True`` a stacked norm is ``(L, d)``, so zero gradients
    move it by ``lr * wd``.  The port's unstacked norms and biases are 1-D
    and stay; its matrices decay as the reference's do."""
    kw = dict(smoke=True, **F32)
    jcfg, cfg = jax_get_config("qwen2-1.5b", **kw), get_config("qwen2-1.5b", **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    jopt, opt = JaxAdamW(1.0, weight_decay=0.5), AdamW(1.0, weight_decay=0.5)
    jupd, _, _ = jopt.update(jax.tree.map(jnp.zeros_like, jparams), jopt.init(jparams), jparams)
    assert jparams["layers"]["norm1"].ndim == 2
    np.testing.assert_allclose(np.abs(np.asarray(jupd["layers"]["norm1"])), 0.5)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    leaves = params.leaves()
    upd, _, _ = opt.update({k: torch.zeros_like(p) for k, p in leaves.items()},
                           opt.init(params), params)
    for path, u in upd.items():
        if leaves[path].dim() == 1:  # every norm and bias
            assert not u.any(), path
        else:
            np.testing.assert_allclose(u.numpy(), -0.5 * leaves[path].numpy(), err_msg=path)
    assert "layers.0.norm1" in upd and "layers.1.attn.bq" in upd
    # the reference agrees with the port where its layers are not stacked
    jcfg_flat = dataclasses.replace(jcfg, scan_layers=False)
    flat = jax_build_model(jcfg_flat).init(jax.random.key(0))
    jupd_flat, _, _ = jopt.update(jax.tree.map(jnp.zeros_like, flat), jopt.init(flat), flat)
    assert not np.asarray(jupd_flat["layers"][0]["norm1"]).any()


if __name__ == "__main__":
    # qwen2-1.5b at full width (d_model 1536, vocab 151936) cut to 2 layers,
    # global batch 8 x seq 128 and 6 steps, as chip_smoke.py's restart phase
    # runs it on the card (there in bf16 compute, from the port's own weights):
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py
    # About 10 GB of host memory at its peak and a few minutes of CPU.
    import math
    import time

    from repro_torch.runtime.train import _value_and_grad

    n_steps, seq_len, n_batch = 6, 128, 8
    t_start = time.perf_counter()
    ref, port, p0 = loss_trajectories(n_steps, seq_len, n_batch, n_layers=2)
    vocab = get_config("qwen2-1.5b").vocab_size
    pipe = SyntheticLM(PipelineConfig(vocab, seq_len, n_batch, seed=0))
    cfg = dataclasses.replace(get_config("qwen2-1.5b", scan_layers=False, **F32), n_layers=2)
    print(f"qwen2-1.5b, 2 layers at full width, f32, batch {n_batch} x {seq_len}, "
          f"cosine_with_warmup(3e-3, {max(n_steps // 20, 1)}, {n_steps}); uniform ln V = "
          f"{math.log(vocab):.4f}, the data's ceiling {pipe.bigram_ceiling_loss():.4f}")
    for s, ((rl, rg), (pl, pg)) in enumerate(zip(ref, port)):
        print(f"step {s}: loss reference {rl:.7f} port {pl:.7f} (rel {abs(pl - rl) / rl:.2e}); "
              f"grad norm reference {rg:.6f} port {pg:.6f}")
    # where the first step's gradient lies against AdamW's eps = 1e-8: the
    # update lr g / (|g| + eps) barely moves an element with |g| << eps
    batch0 = pipe.global_batch(0)
    _, _, grads = _value_and_grad(build_model(cfg), p0, _t(batch0))
    tokens = np.unique(np.concatenate([batch0["tokens"], batch0["labels"]]).ravel())
    for path, g in grads.items():
        a = g.abs()
        line = (f"  {path}: {a.numel()} elements, |g| < 1e-8 {float((a < 1e-8).float().mean()):.2%}"
                f", |g| < 1e-6 {float((a < 1e-6).float().mean()):.2%}")
        if path == "embed":
            seen = torch.zeros(vocab, dtype=torch.bool)
            seen[torch.from_numpy(tokens)] = True
            rows = a.max(dim=1).values
            line += (f"; {int(seen.sum())} rows are the batch's tokens or labels (largest "
                     f"|g| of a row: median {float(rows[seen].median()):.3e}), the other "
                     f"rows' median "
                     f"{float(rows[~seen].median()):.3e}")
        print(line)
    print(f"done in {time.perf_counter() - t_start:.1f} s")
