"""The state-space and hybrid families' mesh steps, and sequence parallelism, on gloo ranks.

One world of 4 gloo CPU ranks (``tests/torch_mesh_ranks.py``) runs the port's
``jit_train_step``, ``jit_prefill`` and ``jit_serve_step`` for mamba2-2.7b
smoke and recurrentgemma-2b smoke on ("data", "model") meshes (2, 2) and
(1, 4), tensor-parallel over "model" (``runtime/train.py::TP_FAMILIES``),
and qwen2-1.5b smoke's step on (2, 2) with ``sequence_parallel=True``.  The
reference's side is its own ``jit_train_step`` / ``jit_prefill`` /
``jit_serve_step`` on the same meshes of four host devices (one jax
subprocess), from the same weights (key 0) and batch, carried into the port
by ``models/convert.py::params_from_jax``.

Tolerances: a step's loss and grad norm within 1e-5 of the reference's, its
first moments (the clipped gradients times 1 - b1) everywhere and its
parameters where ``|g| >= 100 eps`` within 1e-5 (``tests/
test_torch_distributed_multidev.py``'s MoE step); the same against the port's
plain single-process step.  Served logits the same on every rank, within
1e-5 of the port's plain path and of the reference's mesh serving.  A
rank's compute tree holds only its model shards of the split leaves, and
neither step gathers a parameter or a cache leaf over the model axis.  The
element order of the RG-LRU's block rule ``("model", None, None)`` is held
to jax's ``NamedSharding``.
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import build_model, convert, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.train import TrainState, make_train_step, param_shapes  # noqa: E402
from torch_mesh_ranks import REC_ARCHS, REC_PRE, rec_cfg, run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, S_MAX = 8, 16, 16
EPS = 1e-8
TOL = 1e-5
SHAPES = {"22": (2, 2), "14": (1, 4)}
CASES = ("rec_ssm22", "rec_ssm14", "rec_hyb22", "rec_hyb14", "sp22")

pytestmark = pytest.mark.timeout(600)

_JAX = """
import dataclasses, pickle, sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import AdamW
from repro.runtime.serve import jit_prefill, jit_serve_step
from repro.runtime.train import init_state, jit_train_step
B, S = {b}, {s}
host = lambda t: jax.tree.map(np.asarray, t)
out = {{}}
def batch_of(cfg, seed):
    rng = np.random.default_rng(seed)
    return {{"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}}
def train(model, mesh, state0, batch):
    opt = AdamW(learning_rate=1e-2, weight_decay=0.0)
    with mesh:
        fn, st_sh, b_sh = jit_train_step(mesh, model, opt, ShapeConfig("t", S, B, "train"),
                                         donate=False)
        new, metrics = fn(jax.device_put(state0, st_sh), jax.device_put(batch, b_sh))
    return {{"params": host(new.params), "m": host(new.opt_state.m),
            "metrics": {{k: float(v) for k, v in metrics.items()}}}}
for fam, arch, pre in {families}:
    cfg = get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    state0 = init_state(model, AdamW(learning_rate=1e-2, weight_decay=0.0), jax.random.key(0))
    batch = batch_of(cfg, 5)
    rec = {{"params0": host(state0.params), "batch": batch}}
    for name, shape in (("22", (2, 2)), ("14", (1, 4))):
        mesh = make_mesh(shape, ("data", "model"))
        rec["train" + name] = train(model, mesh, state0, batch)
        with mesh:
            pf, p_sh, b_sh, _ = jit_prefill(mesh, model, ShapeConfig("p", S, B, "prefill"))
            st, _, _, tok_sh = jit_serve_step(mesh, model, ShapeConfig("d", S, B, "decode"),
                                              donate=False)
            params = jax.device_put(state0.params, p_sh)
            logits, cache, t = pf(params, jax.device_put({{"tokens": batch["tokens"][:, :pre]}},
                                                          b_sh))
            dec = [np.asarray(logits)]
            for i in range(3):
                tok = jax.device_put(batch["tokens"][:, pre + i:pre + i + 1], tok_sh)
                logits, cache, t = st(params, cache, tok, t)
                dec.append(np.asarray(logits))
        rec["serve" + name] = dec
    out[fam] = rec
cfg = get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32",
                 sequence_parallel=True)
model = build_model(cfg)
state0 = init_state(model, AdamW(learning_rate=1e-2, weight_decay=0.0), jax.random.key(0))
batch = batch_of(cfg, 6)
out["sp"] = {{"params0": host(state0.params), "batch": batch,
             "train22": train(model, make_mesh((2, 2), ("data", "model")), state0, batch)}}
rows = {{}}
for shape in ((2, 2), (1, 4)):
    mesh = make_mesh(shape, ("data", "model"))
    idx = NamedSharding(mesh, P("model", None, None)).devices_indices_map((16, 4, 4))
    rows[shape] = [[idx[d][0].start or 0, idx[d][0].stop or 16] for d in mesh.devices.flat]
out["rows"] = rows
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's mesh steps on four host devices, its weights carried into the port."""
    path = tmp_path_factory.mktemp("rec") / "ref.pkl"
    families = [(fam, arch, REC_PRE[fam]) for fam, arch in REC_ARCHS.items()]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX.format(b=B, s=S, families=families),
                        str(path)], capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        out = pickle.load(f)
    for fam in REC_ARCHS:
        cfg = rec_cfg(fam)
        rec = out[fam]
        rec["params0"] = convert.params_from_jax(rec["params0"], cfg, device="cpu").leaves()
        for name in SHAPES:
            for key in ("params", "m"):
                rec["train" + name][key] = convert.params_from_jax(
                    rec["train" + name][key], cfg, device="cpu").leaves()
    qcfg = get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32")
    sp = out["sp"]
    sp["params0"] = convert.params_from_jax(sp["params0"], qcfg, device="cpu").leaves()
    for key in ("params", "m"):
        sp["train22"][key] = convert.params_from_jax(sp["train22"][key], qcfg,
                                                     device="cpu").leaves()
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    work = tmp_path_factory.mktemp("recmesh")
    inp = {"params": ref["sp"]["params0"],
           "batch": {k: torch.from_numpy(v) for k, v in ref["sp"]["batch"].items()}}
    for fam in REC_ARCHS:
        inp[f"{fam}_params"] = ref[fam]["params0"]
        inp[f"{fam}_batch"] = {k: torch.from_numpy(v) for k, v in ref[fam]["batch"].items()}
    torch.save(inp, work / "inputs.pt")
    return run_ranks(CASES, 4, str(work))


def ok(outputs: list) -> list:
    for out in outputs:
        assert "error" not in out, out.get("error")
    return outputs


def _plain(cfg, leaves: dict, batch: dict):
    """The port's single-process step and serving from ``leaves``."""
    model = build_model(cfg)
    opt = AdamW(learning_rate=1e-2, weight_decay=0.0)
    params = model.init(torch.Generator().manual_seed(0)).replace_leaves(
        {k: v.clone() for k, v in leaves.items()})
    state = TrainState(torch.zeros((), dtype=torch.int32), params.trainable(),
                       opt.init(params))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    new, metrics = make_train_step(model, opt)(state, tb)
    full = {f"params.{k}": p.detach() for k, p in new.params.leaves().items()}
    full.update({f"m.{k}": t for k, t in new.opt_state.m.items()})
    full.update({f"v.{k}": t for k, t in new.opt_state.v.items()})
    return float(metrics["loss"]), float(metrics["grad_norm"]), full, model, params


def _hold_step(got: dict, m_want: dict, p_want: dict, what: str) -> None:
    """First moments everywhere, parameters where the step's gradient is
    resolved (``|g| >= 100 eps``, g from the first moment), within 1e-5."""
    held = total = 0
    for k, w in m_want.items():
        np.testing.assert_allclose(got["m." + k].numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{what} m.{k}")
        sel = (w.abs() / 0.1 >= 100 * EPS) | (w == 0)
        held, total = held + int(sel.sum()), total + sel.numel()
        np.testing.assert_allclose(got["params." + k][sel].numpy(), p_want[k][sel].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} params.{k}")
    assert held > 0.99 * total, (held, total)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("fam", list(REC_ARCHS))
def test_recurrent_mesh_train_step_matches_reference_and_plain(ref, ranks, fam, shape):
    outs = ok(ranks[f"rec_{fam}{shape}"])
    got, want = outs[0], ref[fam]["train" + shape]
    for key in ("loss", "grad_norm"):
        for out in outs[1:]:
            assert torch.equal(out[key], got[key])
        assert abs(float(got[key]) - want["metrics"][key]) < TOL, (key, float(got[key]),
                                                                   want["metrics"][key])
    _hold_step(got["state"], want["m"], want["params"], "against the reference")
    loss, gnorm, plain, _, _ = _plain(rec_cfg(fam), ref[fam]["params0"], ref[fam]["batch"])
    assert abs(float(got["loss"]) - loss) < TOL and abs(float(got["grad_norm"]) - gnorm) < TOL
    _hold_step(got["state"], {k[2:]: v for k, v in plain.items() if k.startswith("m.")},
               {k[7:]: v for k, v in plain.items() if k.startswith("params.")},
               "against the plain step")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("fam", list(REC_ARCHS))
def test_recurrent_mesh_serving_matches_reference_and_plain(ref, ranks, fam, shape):
    """The prefill and three decode steps: the same logits on every rank,
    within 1e-5 of the reference's mesh serving and of the port's plain
    path."""
    outs = ok(ranks[f"rec_{fam}{shape}"])
    _, _, _, model, params = _plain(rec_cfg(fam), ref[fam]["params0"], ref[fam]["batch"])
    tokens = torch.from_numpy(ref[fam]["batch"]["tokens"])
    pre = REC_PRE[fam]
    with torch.no_grad():
        logits, cache, t = model.prefill(params, {"tokens": tokens[:, :pre]}, S_MAX)
        mine = [logits]
        for i in range(3):
            logits, cache, t = model.decode_step(params, cache, tokens[:, pre + i:pre + i + 1], t)
            mine.append(logits)
    for i, key in enumerate(("prefill", "decode0", "decode1", "decode2")):
        for out in outs[1:]:
            assert torch.equal(out[key], outs[0][key]), key
        got = outs[0][key].detach().numpy()
        np.testing.assert_allclose(got, ref[fam]["serve" + shape][i], rtol=TOL, atol=TOL,
                                   err_msg=f"{key} against the reference")
        np.testing.assert_allclose(got, mine[i].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{key} against the plain path")


@pytest.mark.parametrize("fam", list(REC_ARCHS))
def test_recurrent_rank_computes_on_its_model_shards(ranks, fam):
    """A rank's compute tree (the train step) holds its model shard of every
    leaf the rules split over "model" and the whole of every other; its
    cache leaves are its model shards too; no parameter and no cache leaf
    is gathered over the model axis, in the train step or in serving."""
    cfg = rec_cfg(fam)
    shapes = param_shapes(build_model(cfg))
    for name, (dsz, msz) in SHAPES.items():
        outs = ok(ranks[f"rec_{fam}{name}"])
        specs = sharding.param_shardings({"data": dsz, "model": msz}, shapes)
        split = 0
        for k, leaf in shapes.items():
            want = list(leaf.shape)
            for d, part in enumerate(specs[k].spec):
                if part == "model":
                    want[d] //= msz
                    split += 1
            for out in outs:
                assert out["tree"][k] == tuple(want), (name, k, out["tree"][k], want)
        assert split >= 8
        for out in outs:
            assert out["train_over_model"] == 0 and out["serve_over_model"] == 0, name
            cache = out["local_cache"]
            if fam == "ssm":
                assert cache["0.conv_x"][-1] == 2 * cfg.d_model // msz
                assert cache["0.h"][1] == 2 * cfg.d_model // cfg.ssm_headdim // msz
                assert cache["0.conv_bc"][-1] == 2 * cfg.ssm_state
            else:
                assert cache["groups.0.rglru_0.conv"][-1] == cfg.d_model // msz
                assert cache["groups.0.rglru_0.h"][-1] == cfg.d_model // msz
                k_pad = transformer._layout(cfg).k_pad  # the ring's heads: whole where TP > K_pad
                heads = k_pad // msz if k_pad % msz == 0 else k_pad
                assert cache["groups.0.attn_2.k"][2] == heads
            for path, local in cache.items():
                if not path.endswith("pos"):  # the ring's positions are (W,)
                    assert local[0] == B // dsz, path


def test_sequence_parallel_mesh_step_matches_reference(ref, ranks):
    """qwen2 smoke's step on (2, 2) with ``sequence_parallel=True``: within
    1e-5 of the reference's step with it, and of the same mesh's step
    without it."""
    outs = ok(ranks["sp22"])
    got, want = outs[0], ref["sp"]["train22"]
    for key in ("loss", "grad_norm"):
        for out in outs[1:]:
            assert torch.equal(out["sp"][key], got["sp"][key])
        assert abs(float(got["sp"][key]) - want["metrics"][key]) < TOL, key
        assert abs(float(got["sp"][key]) - float(got["tp"][key])) < TOL, key
    _hold_step(got["sp"]["state"], want["m"], want["params"], "against the reference")
    tp_state = got["tp"]["state"]
    _hold_step(got["sp"]["state"], {k[2:]: v for k, v in tp_state.items() if k.startswith("m.")},
               {k[7:]: v for k, v in tp_state.items() if k.startswith("params.")},
               "against the step without it")


def test_block_rule_element_order_matches_jax(ref):
    """A ``("model", None, None)`` leaf (the RG-LRU's ``w_a`` / ``w_i``): each
    rank's blocks by ``sharding.local_slice`` are jax's on the same mesh."""
    for shape, rows in ref["rows"].items():
        mesh = {"data": shape[0], "model": shape[1]}
        for dev, (lo, hi) in enumerate(rows):
            coord = (dev // shape[1], dev % shape[1])
            got = sharding.local_slice((16, 4, 4), ("model", None, None), mesh, coord)[0]
            assert (got.start, got.stop) == (lo, hi), (shape, dev)

