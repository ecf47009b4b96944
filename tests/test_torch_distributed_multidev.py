"""The port's mesh code on gloo CPU ranks against the reference's multi-device tests.

Mirrors ``tests/test_distributed_multidev.py`` (which forces 8 host devices
for jax) on ``torch.distributed``: one world of 8 gloo ranks runs every
8-rank case (``tests/torch_mesh_ranks.py``), a world of 4 the checkpoint
restore; the ranks join through a ``file://`` store, one thread each.  The
reference's side runs here on one device: its single-device train step, its
plain decode and its quantization, on the same seeded inputs, its weights
carried into the port by ``models/convert.py::params_from_jax``.

Every case whose mesh has a model axis of size > 1 runs tensor-parallel
(``distributed/tensor_parallel.py``): the reference's cases on (4, 2),
(2, 2, 2) and (2, 4), the checkpoint restore on (2, 2), and the MoE step on
(2, 2), which is held to the reference's ``jit_train_step`` on four host
devices (a jax subprocess).  The TP step is also held against the same
mesh's step under ``MeshAxes.dp_over_model`` (no tensor parallelism), and a
case records what a rank computes on: its compute tree's shapes and any
gather over the model axis.

Tolerances: the reference's (loss 1e-3, every leaf 2e-3; microbatching
5e-4; decode logits 2e-3 / 3e-3), and 1e-5 against the port's own plain step
on one process.  A first AdamW step moves a parameter by ``lr g / (|g| +
eps)``, ill-conditioned where ``|g|`` is near ``eps``: against the plain
step, parameters are held at 1e-5 where ``|g| >= 100 eps`` and every moment
everywhere (``tests/test_torch_train.py``'s contract).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import collectives as jax_collectives  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.runtime.train import init_state as jax_init_state  # noqa: E402
from repro.runtime.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, convert  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.train import TrainState, make_train_step  # noqa: E402
from torch_mesh_ranks import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 16
S_PRE, S_MAX = 12, 16
EPS = 1e-8
CASES8 = ("rows", "step42", "rdp222", "micro", "ragged", "allreduce", "ckpt_save",
          "seqdecode", "ringdecode", "tpdp", "tptree", "fewrows")
CASES4 = ("ckpt_restore", "moe22", "moe_fewrows")
ROW_SPECS = {
    ("pod", "data", "model"): {"batch": (("pod", "data"),), "model": (None, "model"),
                               "both": (("pod", "data"), "model"), "data": ("data",),
                               "cols": (None, ("pod", "data"))},
    ("replica", "shard", "model"): {"shard": ("shard",), "model": (None, "model"),
                                    "both": ("shard", "model")},
}

pytestmark = pytest.mark.timeout(600)


def ok(outputs: list) -> list:
    for out in outputs:
        assert "error" not in out, out.get("error")
    return outputs


# ---------------------------------------------------------------------------
# the reference's side, and one run of the ranks for the whole module
# ---------------------------------------------------------------------------


def _np_batch(seed: int, vocab: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (B, S), dtype=np.int32),
            "loss_mask": np.ones((B, S), np.float32)}


def _ragged_mask() -> np.ndarray:
    """Rows of very different lengths: a mean of per-rank means would be wrong."""
    lengths = np.array([16, 1, 3, 0, 16, 9, 2, 5])
    return (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32")
    cfg = jax_get_config("qwen2-1.5b", **kw)
    model = jax_build_model(cfg)
    opt = JaxAdamW(learning_rate=1e-2, weight_decay=0.0)
    state0 = jax_init_state(model, opt, jax.random.key(0))
    np_batch = _np_batch(1, cfg.vocab_size)
    out = {"cfg": cfg, "np_batch": np_batch, "ragged_mask": _ragged_mask()}
    step = jax.jit(jax_make_train_step(model, opt))
    mb_step = jax.jit(jax_make_train_step(model, opt, microbatches=4))
    for name, fn, mask in (("step", step, None), ("micro", mb_step, None),
                           ("ragged", step, out["ragged_mask"])):
        batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
        if mask is not None:
            batch["loss_mask"] = jnp.asarray(mask)
        st, metrics = fn(state0, batch)
        out[name] = {"loss": float(metrics["loss"]),
                     "params": convert.params_from_jax(jax.tree.map(np.asarray, st.params),
                                                       get_config("qwen2-1.5b", **kw),
                                                       device="cpu").leaves()}
    port_cfg = get_config("qwen2-1.5b", **kw)
    out["params"] = convert.params_from_jax(jax.tree.map(np.asarray, state0.params), port_cfg,
                                            device="cpu").leaves()

    # the decode case: the reference's plain repeated-KV decode (pad_heads_to=4)
    dkw = dict(kw, pad_heads_to=4)
    dmodel = jax_build_model(jax_get_config("qwen2-1.5b", **dkw))
    dparams = dmodel.init(jax.random.key(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S_MAX), dtype=np.int32)
    logits, cache, t = dmodel.prefill(dparams, {"tokens": jnp.asarray(toks[:, :S_PRE])},
                                      max_len=S_MAX)
    dec = [np.asarray(logits)]
    for i in range(3):
        logits, cache, t = dmodel.decode_step(dparams, cache,
                                              jnp.asarray(toks[:, S_PRE + i:S_PRE + i + 1]), t)
        dec.append(np.asarray(logits))
    out["dec_logits"] = dec
    out["dec_tokens"] = toks
    out["dec_params"] = convert.params_from_jax(jax.tree.map(np.asarray, dparams),
                                                get_config("qwen2-1.5b", **dkw),
                                                device="cpu").leaves()
    out["ar_x"] = np.random.default_rng(3).standard_normal((8, 64, 64)).astype(np.float32)
    return out


_JAX_MOE = """
import pickle, sys, jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import AdamW
from repro.runtime.train import init_state, jit_train_step
cfg = get_config("qwen3-moe-235b-a22b", smoke=True, param_dtype="float32", compute_dtype="float32")
model = build_model(cfg)
opt = AdamW(learning_rate=1e-2, weight_decay=0.0)
state0 = init_state(model, opt, jax.random.key(0))
rng = np.random.default_rng(4)
batch = {{"tokens": rng.integers(0, cfg.vocab_size, ({b}, {s}), dtype=np.int32),
          "labels": rng.integers(0, cfg.vocab_size, ({b}, {s}), dtype=np.int32),
          "loss_mask": (rng.random(({b}, {s})) > 0.2).astype(np.float32)}}
mesh = make_mesh((2, 2), ("data", "model"))
with mesh:
    fn, st_sh, b_sh = jit_train_step(mesh, model, opt, ShapeConfig("t", {s}, {b}, "train"),
                                     donate=False)
    new, metrics = fn(jax.device_put(state0, st_sh), jax.device_put(batch, b_sh))
host = lambda t: jax.tree.map(np.asarray, t)
pickle.dump({{"params0": host(state0.params), "params": host(new.params),
             "m": host(new.opt_state.m), "batch": batch,
             "metrics": {{k: float(v) for k, v in metrics.items()}}}}, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    """The reference's MoE step on a (2, 2) ("data", "model") mesh of four host devices."""
    path = tmp_path_factory.mktemp("moe") / "moe.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_MOE.format(b=B, s=S), str(path)],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        out = pickle.load(f)
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True, param_dtype="float32",
                     compute_dtype="float32")
    for name in ("params0", "params", "m"):
        out[name] = convert.params_from_jax(out[name], cfg, device="cpu").leaves()
    return out


@pytest.fixture(scope="module")
def ranks(ref, moe_ref, tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    torch.save({
        "moe_params": moe_ref["params0"],
        "moe_batch": {k: torch.from_numpy(v) for k, v in moe_ref["batch"].items()},
        "params": ref["params"],
        "batch": {k: torch.from_numpy(v) for k, v in ref["np_batch"].items()},
        "ragged_mask": torch.from_numpy(ref["ragged_mask"]),
        "ar_x": torch.from_numpy(ref["ar_x"]),
        "dec_params": ref["dec_params"],
        "dec_tokens": torch.from_numpy(ref["dec_tokens"]),
        "ckpt_dir": str(work / "ckpt"),
        "row_specs": ROW_SPECS,
    }, work / "inputs.pt")
    out = run_ranks(CASES8, 8, str(work))
    out.update(run_ranks(CASES4, 4, str(work)))
    return out


def _port_model():
    return build_model(get_config("qwen2-1.5b", smoke=True, param_dtype="float32",
                                  compute_dtype="float32"))


def _plain_step(leaves: dict, batch: dict, microbatches: int = 1, state=None):
    """The port's single-process step from ``leaves`` (or a full mesh state)."""
    model = _port_model()
    opt = AdamW(learning_rate=1e-2, weight_decay=0.0)
    if state is None:
        params = model.init(torch.Generator().manual_seed(0)).replace_leaves(
            {k: v.clone() for k, v in leaves.items()}).trainable()
        state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    new, metrics = make_train_step(model, opt, microbatches=microbatches)(state, batch)
    full = {"step": new.step, "count": new.opt_state.count}
    full.update({f"params.{k}": p.detach() for k, p in new.params.leaves().items()})
    full.update({f"m.{k}": t for k, t in new.opt_state.m.items()})
    full.update({f"v.{k}": t for k, t in new.opt_state.v.items()})
    return float(metrics["loss"]), full


def _hold_state(got: dict, want: dict, tol: float, before: dict | None = None) -> None:
    """Every moment within ``tol``; every parameter within ``tol`` where the
    step's gradient is resolved (|g| >= 100 eps, g = (m - b1 m_before) / (1 - b1),
    ``m_before`` zero on a first step, else from the state ``before`` the step)."""
    assert set(got) == set(want)
    held = total = 0
    for k, w in want.items():
        g = got[k]
        if k.startswith("params."):
            m = "m." + k[len("params."):]
            grad = (want[m] - (0.9 * before[m] if before is not None else 0.0)) / 0.1
            sel = (grad.abs() >= 100 * EPS) | (grad == 0)
            held, total = held + int(sel.sum()), total + sel.numel()
            np.testing.assert_allclose(g[sel].numpy(), w[sel].numpy(), rtol=tol, atol=tol,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       rtol=tol, atol=tol, err_msg=k)
    assert held > 0.99 * total, (held, total)  # at most 1 % left to the moments


def _hold_reference(got: dict, ref_params: dict, tol: float) -> None:
    for k, w in ref_params.items():
        np.testing.assert_allclose(got["params." + k].numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=k)


def _same_on_every_rank(outputs: list, key: str) -> None:
    for out in outputs[1:]:
        assert torch.equal(out[key], outputs[0][key])


# ---------------------------------------------------------------------------
# the reference's six cases, the ragged mask, the element order
# ---------------------------------------------------------------------------


def test_sharded_step_matches_single_device(ref, ranks):
    outs = ok(ranks["step42"])
    _same_on_every_rank(outs, "loss")
    got = outs[0]
    assert got["b_spec"]["tokens"] == "PartitionSpec('data', None)"
    assert abs(float(got["loss"]) - ref["step"]["loss"]) < 1e-3
    _hold_reference(got["state"], ref["step"]["params"], 2e-3)
    loss, plain = _plain_step(ref["params"], ref["np_batch"])
    assert abs(float(got["loss"]) - loss) < 1e-5
    _hold_state(got["state"], plain, 1e-5)


def test_rdp_mesh_matches_plain_dp(ref, ranks):
    """replica x shard factorization is numerically plain DP, and the
    replicas of a shard hold bitwise the same parameters (first-of-r)."""
    outs = ok(ranks["rdp222"])
    got = outs[0]
    assert got["b_spec"]["tokens"] == "PartitionSpec('shard', None)"
    assert abs(float(got["loss"]) - ref["step"]["loss"]) < 1e-3
    _hold_reference(got["state"], ref["step"]["params"], 2e-3)
    loss, plain = _plain_step(ref["params"], ref["np_batch"])
    assert abs(float(got["loss"]) - loss) < 1e-5
    _hold_state(got["state"], plain, 1e-5)
    # rank = replica * 4 + shard * 2 + model: replica 1's twin of rank r is r + 4
    for r in range(4):
        a, b = outs[r]["local"], outs[r + 4]["local"]
        assert all(torch.equal(a[k], b[k]) for k in a), r


def test_microbatched_step_matches_full_batch(ref, ranks):
    got = ok(ranks["micro"])[0]
    assert abs(float(got["loss"]) - ref["micro"]["loss"]) < 1e-4
    assert abs(float(got["loss"]) - ref["step"]["loss"]) < 1e-4
    _hold_reference(got["state"], ref["step"]["params"], 5e-4)
    loss, plain = _plain_step(ref["params"], ref["np_batch"], microbatches=4)
    assert abs(float(got["loss"]) - loss) < 1e-5
    _hold_state(got["state"], plain, 1e-5)


def test_microbatch_fewer_rows_than_batch_shards_matches_plain(ref, ranks):
    """Microbatches of 2 rows over 8 batch shards: every rank computes each
    chunk whole, weighted by 1 / 8 (the rules' replication of a dim the
    axes do not divide), and the step is the plain microbatched step's."""
    outs = ok(ranks["fewrows"])
    _same_on_every_rank(outs, "loss")
    got = outs[0]
    loss, plain = _plain_step(ref["params"], ref["np_batch"], microbatches=4)
    assert abs(float(got["loss"]) - loss) < 1e-5
    _hold_state(got["state"], plain, 1e-5)


def test_moe_microbatch_fewer_rows_than_batch_shards_matches_plain(ranks):
    """The MoE step on (4, 1) in one-row microbatches: the aux loss's
    gradient, a statistic of the whole chunk on every rank, enters once."""
    outs = ok(ranks["moe_fewrows"])
    got = outs[0]
    for key in ("loss", "moe_aux", "loss_total"):
        _same_on_every_rank(outs, key)
        assert abs(float(got[key]) - float(got["want"][key])) < 1e-5, key
    assert float(got["want"]["moe_aux"]) > 0
    _hold_state(got["state"], got["plain"], 1e-5)


def test_ragged_loss_mask_matches_single_device(ref, ranks):
    """The global normalisation: each rank's masked sum over the mask sum of
    the whole batch, not a mean of per-rank means."""
    got = ok(ranks["ragged"])[0]
    assert abs(float(got["loss"]) - ref["ragged"]["loss"]) < 1e-3
    _hold_reference(got["state"], ref["ragged"]["params"], 2e-3)
    batch = dict(ref["np_batch"], loss_mask=ref["ragged_mask"])
    loss, plain = _plain_step(ref["params"], batch)
    assert abs(float(got["loss"]) - loss) < 1e-5
    _hold_state(got["state"], plain, 1e-5)
    # the wrong normalisation (a mean of the 4 batch shards' means) is far off
    per = []
    for j in range(4):
        rows = {k: v[2 * j:2 * j + 2] for k, v in batch.items()}
        per.append(_plain_step(ref["params"], rows)[0] if rows["loss_mask"].sum() else 0.0)
    assert abs(np.mean(per) - loss) > 1e-2


def test_compressed_allreduce(ref, ranks):
    outs = ok(ranks["allreduce"])
    x = ref["ar_x"]
    true_mean = x.mean(axis=0)
    qs, scales = [], []
    for r, out in enumerate(outs):
        q, scale = jax_collectives.quantize_int8(jnp.asarray(x[r]))
        q, scale = np.asarray(q), np.asarray(scale)
        assert np.array_equal(out["q"].numpy(), q), r
        assert out["scale"].numpy().tobytes() == scale.tobytes(), r
        ef = np.asarray(jnp.asarray(x[r]) - jax_collectives.dequantize_int8(jnp.asarray(q),
                                                                             jnp.asarray(scale)))
        assert out["ef"].numpy().tobytes() == ef.tobytes(), r
        qs.append(q)
        scales.append(scale)
    want = np.asarray(jnp.tensordot(jnp.asarray(np.stack(scales)),
                                    jnp.asarray(np.stack(qs)).astype(jnp.float32).reshape(8, -1),
                                    axes=1).reshape(x.shape[1:]) / 8)
    # the dot's sum runs in another order: within 1e-6 of the sum of the
    # terms' magnitudes (relative to the mean itself where nothing cancels)
    scale_of_terms = np.abs(np.stack(scales)) @ np.abs(np.stack(qs)).reshape(8, -1) / 8
    for out in outs:
        diff = np.abs(out["mean"].numpy() - want).reshape(-1)
        assert np.all(diff <= 1e-6 * scale_of_terms), diff.max()
        np.testing.assert_allclose(out["plain"].numpy(), true_mean, rtol=1e-5, atol=1e-6)
    # the reference's own assertions: one-shot error within a quantization step,
    # and the error feedback telescopes
    err = float(np.abs(outs[0]["mean"].numpy() - true_mean).max())
    assert err <= float(np.abs(x).max()) / 127.0 * 1.01, err
    avg_err = float(np.abs(outs[0]["running"].numpy() - true_mean).max())
    assert avg_err < err * 0.25, (avg_err, err)


def test_checkpoint_cross_mesh_restore(ref, ranks):
    """Saved on 8 ranks (4, 2), restored on 4 ranks (2, 2): bitwise the saved
    state; the next step is, on every element, the step the same mesh takes
    from that state placed in memory, and its loss the single-process step's."""
    saved = ok(ranks["ckpt_save"])
    assert saved[0]["wrote"] == ["step_00000001"]
    outs = ok(ranks["ckpt_restore"])
    got = outs[0]
    assert got["step"] == 1 and all(o["placed"] for o in outs)
    want = saved[0]["state"]
    assert set(got["restored"]) == set(want)
    for k, w in want.items():
        assert torch.equal(got["restored"][k], w), k
    # the single-process step from the saved state
    model = _port_model()
    opt = AdamW(learning_rate=1e-2, weight_decay=0.0)
    params = model.init(torch.Generator().manual_seed(0)).replace_leaves(
        {k[len("params."):]: v for k, v in want.items() if k.startswith("params.")}).trainable()
    from repro_torch.optim import OptState

    state = TrainState(want["step"], params, OptState(
        want["count"], {k[2:]: v for k, v in want.items() if k.startswith("m.")},
        {k[2:]: v for k, v in want.items() if k.startswith("v.")}))
    loss, plain = _plain_step(None, ref["np_batch"], state=state)
    assert np.isfinite(float(got["loss"]))
    assert abs(float(got["loss"]) - loss) < 1e-5
    # the restore alone: the (2, 2) step (tensor-parallel) from the restored
    # state against the same step from the state placed with no checkpoint
    assert abs(float(got["loss"]) - float(got["fresh_loss"])) < 1e-5
    assert set(got["state"]) == set(got["fresh_state"])
    for k, w in got["fresh_state"].items():
        np.testing.assert_allclose(np.asarray(got["state"][k], np.float64),
                                   np.asarray(w, np.float64), rtol=1e-5, atol=1e-5, err_msg=k)
    # and against the single-process step, under the step-to-plain contract
    _hold_state(got["state"], plain, 1e-5, before=want)


def test_seq_sharded_kv_decode_matches_plain(ref, ranks):
    """decode_kv_seq_sharded on (2, 4): the true-KV ring sharded over the
    model axis by sequence, the partial-softmax combine across the 4 model
    ranks, against the plain repeated-KV decode (the port's and the
    reference's)."""
    outs = ok(ranks["seqdecode"])
    got = outs[0]
    spec = got["c_spec"]
    assert spec["0.ks"] == "PartitionSpec('data', 'model', None, None)"
    assert spec["0.poss"] == "PartitionSpec('model',)"
    # each rank holds B/2 rows and W/4 slots of the ring
    assert tuple(got["local_cache"]["ks"].shape[:2]) == (B // 2, S_MAX // 4)
    plain = build_model(get_config("qwen2-1.5b", smoke=True, param_dtype="float32",
                                   compute_dtype="float32", pad_heads_to=4))
    params = plain.init(torch.Generator().manual_seed(0)).replace_leaves(ref["dec_params"])
    toks = torch.from_numpy(ref["dec_tokens"])
    with torch.no_grad():
        logits, cache, t = plain.prefill(params, {"tokens": toks[:, :S_PRE]}, S_MAX)
        mine = [logits]
        for i in range(3):
            logits, cache, t = plain.decode_step(params, cache, toks[:, S_PRE + i:S_PRE + i + 1], t)
            mine.append(logits)
    for i, key in enumerate(("prefill", "decode0", "decode1", "decode2")):
        _same_on_every_rank(outs, key)
        tol = 2e-3 if i == 0 else 3e-3
        np.testing.assert_allclose(got[key].numpy(), ref["dec_logits"][i], atol=tol, rtol=tol,
                                   err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), mine[i].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    # the ring holds the true heads at the positions written
    assert got["cache"]["ks"].shape[2] == plain.cfg.n_kv_heads
    assert got["cache"]["poss"].tolist() == list(range(S_MAX - 1)) + [-1]


def test_head_sharded_ring_decode_matches_plain(ref, ranks):
    """The plain ring on (2, 4), sharded on heads over the model axis: each
    step gathers the heads and writes this rank's back."""
    outs = ok(ranks["ringdecode"])
    got = outs[0]
    assert got["c_spec"]["0.k"] == "PartitionSpec('data', None, 'model', None)"
    for i, key in enumerate(("prefill", "decode0", "decode1", "decode2")):
        tol = 2e-3 if i == 0 else 3e-3
        np.testing.assert_allclose(got[key].numpy(), ref["dec_logits"][i], atol=tol, rtol=tol,
                                   err_msg=key)
    seq = ok(ranks["seqdecode"])[0]
    for key in ("prefill", "decode0", "decode1", "decode2"):
        np.testing.assert_allclose(got[key].numpy(), seq[key].numpy(), atol=1e-5, rtol=1e-5)


def test_tp_step_matches_dp_over_model(ranks):
    """The tensor-parallel step on (4, 2) against the same mesh's step with the
    model axis as data parallelism (``MeshAxes.dp_over_model``)."""
    tp_out, dp_out = ok(ranks["step42"])[0], ok(ranks["tpdp"])[0]
    assert dp_out["b_spec"]["tokens"] == "PartitionSpec(('data', 'model'), None)"
    assert abs(float(tp_out["loss"]) - float(dp_out["loss"])) < 1e-5
    assert abs(float(tp_out["grad_norm"]) - float(dp_out["grad_norm"])) < 1e-5
    _hold_state(tp_out["state"], dp_out["state"], 1e-5)


def test_tp_rank_computes_on_its_model_shards(ranks):
    """A rank's compute tree (the train step on (4, 2)) holds its model shard of
    every leaf the rules shard over "model" and the whole of every other; no
    parameter and no plain-ring cache leaf is gathered over the model axis
    (the train step, and the ring decode on (2, 4))."""
    from repro_torch.distributed import sharding as port_sharding
    from repro_torch.runtime.train import param_shapes

    outs = ok(ranks["tptree"])
    shapes = param_shapes(_port_model())
    specs = port_sharding.param_shardings({"data": 4, "model": 2}, shapes)
    split = 0
    for k, leaf in shapes.items():
        want = list(leaf.shape)
        for d, part in enumerate(specs[k].spec):
            if part == "model":
                want[d] //= 2
                split += 1
        for out in outs:
            assert out["tree"][k] == tuple(want), (k, out["tree"][k], want)
    assert split >= 10  # wq, bq, wo, the MLP's three and the embedding, in both layers
    for out in outs:
        assert out["gathers"] > 0
        assert out["train_over_model"] == 0 and out["serve_over_model"] == 0, out


def test_moe_mesh_step_over_two_batch_shards_matches_reference(moe_ref, ranks):
    """The MoE step on (2, 2): two batch shards (the aux loss's batch means
    all-reduced) and the experts over the model axis, against the
    reference's jit_train_step on the same mesh: loss, aux, grad norm, the
    first moments (the clipped gradients times 1 - b1) everywhere and the
    parameters where |g| >= 100 eps, within 1e-5."""
    outs = ok(ranks["moe22"])
    got, want = outs[0], moe_ref["metrics"]
    for key in ("loss", "moe_aux", "grad_norm", "loss_total"):
        _same_on_every_rank(outs, key)
        assert abs(float(got[key]) - want[key]) < 1e-5, (key, float(got[key]), want[key])
    assert want["moe_aux"] > 0
    held = total = 0
    for k, w in moe_ref["m"].items():
        m = got["state"]["m." + k]
        np.testing.assert_allclose(m.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
        sel = (w.abs() / 0.1 >= 100 * EPS) | (w == 0)
        held, total = held + int(sel.sum()), total + sel.numel()
        np.testing.assert_allclose(got["state"]["params." + k][sel].numpy(),
                                   moe_ref["params"][k][sel].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert held > 0.99 * total, (held, total)


_JAX_ROWS = """
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
specs = json.loads({specs!r})
out = {{}}
for axes, named in specs:
    mesh = make_mesh((2, 2, 2), tuple(axes))
    for name, spec in named.items():
        spec = [tuple(p) if isinstance(p, list) else p for p in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map((16, 8))
        out[axes[0] + ":" + name] = [
            [[s.start or 0, s.stop or n] for s, n in zip(idx[d], (16, 8))]
            for d in mesh.devices.flat]
print(json.dumps(out))
"""


def test_element_order_matches_jax(ranks):
    """Which elements each rank holds: a dim over two mesh axes splits with the
    first axis major, as jax's NamedSharding (8 host devices in a subprocess)."""
    specs = [[list(axes), {k: [list(p) if isinstance(p, tuple) else p for p in v]
                           for k, v in named.items()}] for axes, named in ROW_SPECS.items()]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _JAX_ROWS.format(specs=json.dumps(specs)))], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    outs = ok(ranks["rows"])
    full = torch.arange(16 * 8).reshape(16, 8)
    # axes.shard from ("pod", "data") rows: to (None, "model"), to (batch, model),
    # and to (None, ("pod", "data")) on the columns
    moved = {"shard:model": "pod:model", "shard:both": "pod:both", "shard:cols": "pod:cols"}
    assert set(want) == {k for k in outs[0] if k not in moved}
    for key, ref_key in [(k, k) for k in want] + list(moved.items()):
        for rank, bounds in enumerate(want[ref_key]):
            expect = full[tuple(slice(a, b) for a, b in bounds)]
            assert torch.equal(outs[rank][key], expect), (key, rank)
