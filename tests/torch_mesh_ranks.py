"""Rank side of the port's multi-rank tests: the mesh code on gloo CPU ranks.

One process per rank:

    python tests/torch_mesh_ranks.py CASES RANK WORLD STORE WORKDIR

Each rank joins a gloo world of WORLD ranks through the ``file://`` store
STORE, reads ``WORKDIR/inputs.pt`` (written by the test: the reference's
weights carried into the port, the batches), runs each case of CASES
(comma-separated) in turn and writes ``WORKDIR/<case>.rank<RANK>.pt``.  A
case that raises writes its traceback instead, so the other cases still
report.  Imports torch and the port only (no jax).  The tests call
:func:`run_ranks`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import traceback

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.planner import RedundancyPlan  # noqa: E402
from repro_torch.distributed import axes, collectives, rdp, sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, OptState  # noqa: E402
from repro_torch.runtime.serve import jit_prefill, jit_serve_step  # noqa: E402
from repro_torch.runtime.train import (  # noqa: E402
    TrainState, jit_init_state, jit_train_step, make_train_step, shard_state)
from torch.distributed.tensor import DTensor  # noqa: E402

B, S = 8, 16
S_PRE, S_MAX = 12, 16


def train_cfg():
    return get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32")


def decode_cfg(seq_sharded: bool):
    return get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32",
                      pad_heads_to=4, decode_kv_seq_sharded=seq_sharded)


def moe_cfg():
    return get_config("qwen3-moe-235b-a22b", smoke=True, param_dtype="float32",
                      compute_dtype="float32")


def optimizer() -> AdamW:
    return AdamW(learning_rate=1e-2, weight_decay=0.0)


def params_of(model, leaves: dict):
    """The port's Params carrying ``leaves`` (by path)."""
    return model.init(torch.Generator().manual_seed(0)).replace_leaves(leaves)


def plain_state(model, opt, leaves: dict) -> TrainState:
    params = params_of(model, leaves).trainable()
    return TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))


def full_state(state: TrainState) -> dict:
    """Every leaf of a mesh state, whole (a collective: every rank calls it)."""
    out = {"step": state.step.clone(), "count": state.opt_state.count.clone()}
    for k, p in state.params.leaves().items():
        out[f"params.{k}"] = p.full_tensor()
    for name in ("m", "v"):
        for k, t in getattr(state.opt_state, name).items():
            out[f"{name}.{k}"] = t.full_tensor()
    return out


def state_of(model, full: dict) -> TrainState:
    """The single-process state holding ``full``'s leaves (``full_state``'s keys)."""
    def part(prefix):
        return {k[len(prefix):]: v.clone() for k, v in full.items() if k.startswith(prefix)}

    params = params_of(model, part("params.")).trainable()
    return TrainState(full["step"].clone(), params,
                      OptState(full["count"].clone(), part("m."), part("v.")))


def local_state(state: TrainState) -> dict:
    return {f"params.{k}": p.to_local().clone() for k, p in state.params.leaves().items()}


def _step(inp, mesh, axes, batch_key="batch", microbatches=1, model=None, mesh_axes=None,
          params_key="params"):
    """One mesh step from the reference's weights; ``mesh``: a DeviceMesh, or
    a shape to make one of with ``axes``."""
    model, opt = model or build_model(train_cfg()), optimizer()
    if axes is not None:
        mesh = make_mesh(mesh, axes, device_type="cpu")
    mesh_axes = mesh_axes(mesh) if mesh_axes is not None else None
    step, st_sh, b_sh = jit_train_step(mesh, model, opt, ShapeConfig("t", S, B, "train"),
                                       donate=False, microbatches=microbatches,
                                       mesh_axes=mesh_axes)
    state = shard_state(plain_state(model, opt, inp[params_key]), st_sh)
    batch = dict(inp[params_key.replace("params", "batch")])  # moe_params: moe_batch
    if batch_key != "batch":
        batch["loss_mask"] = inp[batch_key]
    # half the leaves as DTensors placed by b_sh, half as the plain global batch
    batch["tokens"] = sharding.distribute(batch["tokens"], b_sh["tokens"])
    new, metrics = step(state, batch)
    return new, metrics, {k: str(s.spec) for k, s in b_sh.items()}


def case_step42(inp):
    new, metrics, b_spec = _step(inp, (4, 2), ("data", "model"))
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "b_spec": b_spec,
            "state": full_state(new), "local": local_state(new)}


def case_rdp222(inp):
    plan = RedundancyPlan(n_workers=4, n_batches=2, replication=2, objective="mean",
                          predicted_mean=0.0, predicted_cov=0.0, frontier_B=(),
                          frontier_mean=(), frontier_cov=(), source="test")
    new, metrics, b_spec = _step(inp, rdp.make_rdp_mesh(plan, 2, device_type="cpu"), None)
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "b_spec": b_spec,
            "state": full_state(new), "local": local_state(new)}


def case_tpdp(inp):
    """The step of ``case_step42``'s mesh with the model axis as more data
    parallelism (``MeshAxes.dp_over_model``): no tensor parallelism."""
    new, metrics, b_spec = _step(inp, (4, 2), ("data", "model"),
                                 mesh_axes=sharding.MeshAxes.dp_over_model)
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "b_spec": b_spec,
            "state": full_state(new)}


def _gathers_over_model(calls: list, x, keep) -> None:
    """Record whether ``sharding.gather(x, keep)`` gathers over a "model" axis of size > 1."""
    if isinstance(x, DTensor):
        mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
        calls.append(any(p.is_shard() and names[i] == "model" and mesh.size(i) > 1
                         and "model" not in keep for i, p in enumerate(x.placements)))


def case_tptree(inp):
    """What a tensor-parallel rank computes on: the shapes of the train
    step's compute tree on (4, 2), and whether the train step or the plain
    ring's serving on (2, 4) gathers anything over the model axis."""
    real, calls = sharding.gather, []

    def spy(x, keep=()):
        _gathers_over_model(calls, x, keep)
        return real(x, keep)

    seen = {}
    model = build_model(train_cfg())

    def train_loss(params, batch):
        seen.update({k: tuple(v.shape) for k, v in params.leaves().items()})
        return model.train_loss(params, batch)

    sharding.gather = spy
    try:
        _step(inp, (4, 2), ("data", "model"), model=dataclasses.replace(model,
                                                                      train_loss=train_loss))
        train_calls, calls[:] = list(calls), []
        _serve(inp, False)
        serve_calls = list(calls)
    finally:
        sharding.gather = real
    return {"tree": seen, "train_over_model": sum(train_calls),
            "serve_over_model": sum(serve_calls), "gathers": len(train_calls) + len(serve_calls)}


def case_moe22(inp):
    """The MoE family's step on (2, 2): two batch shards, the experts over the model axis."""
    model = build_model(moe_cfg())
    new, metrics, _ = _step(inp, (2, 2), ("data", "model"), model=model, params_key="moe_params")
    return {**{k: metrics[k] for k in ("loss", "moe_aux", "grad_norm", "loss_total")},
            "state": full_state(new)}


def case_fewrows(inp):
    """Microbatches of 2 rows over 8 batch shards: each rank computes every
    chunk whole (the rules' replication of a dim the axes do not divide)."""
    new, metrics, _ = _step(inp, (8, 1), ("data", "model"), microbatches=4)
    return {"loss": metrics["loss"], "state": full_state(new)}


def case_moe_fewrows(inp):
    """The MoE step on (4, 1) in microbatches of one row (fewer than the
    batch shards), and the single-process step on the same inputs."""
    model, opt = build_model(moe_cfg()), optimizer()
    new, metrics, _ = _step(inp, (4, 1), ("data", "model"), model=model,
                            params_key="moe_params", microbatches=B)
    plain, want = make_train_step(model, opt, microbatches=B)(
        plain_state(model, opt, inp["moe_params"]), dict(inp["moe_batch"]))
    return {**{k: metrics[k] for k in ("loss", "moe_aux", "loss_total")},
            "want": {k: want[k] for k in ("loss", "moe_aux", "loss_total")},
            "state": full_state(new), "plain": local_state_of(plain)}


def local_state_of(state: TrainState) -> dict:
    """A single-process state's leaves by ``full_state``'s keys."""
    out = {"step": state.step, "count": state.opt_state.count}
    out.update({f"params.{k}": p.detach() for k, p in state.params.leaves().items()})
    for name in ("m", "v"):
        out.update({f"{name}.{k}": t for k, t in getattr(state.opt_state, name).items()})
    return out


def case_micro(inp):
    new, metrics, _ = _step(inp, (2, 4), ("data", "model"), microbatches=4)
    return {"loss": metrics["loss"], "state": full_state(new)}


def case_ragged(inp):
    new, metrics, _ = _step(inp, (4, 2), ("data", "model"), batch_key="ragged_mask")
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "state": full_state(new)}


REC_ARCHS = {"ssm": "mamba2-2.7b", "hyb": "recurrentgemma-2b"}
REC_PRE = {"ssm": 12, "hyb": 8}  # the hybrid's prompt no longer than its window (8)


def rec_cfg(fam: str, **kw):
    return get_config(REC_ARCHS[fam], smoke=True, param_dtype="float32", compute_dtype="float32",
                      **kw)


def _rec(inp, fam: str, shape) -> dict:
    """The state-space or hybrid family's mesh train step and serving on a
    ("data", "model") mesh of ``shape``, tensor-parallel over "model": the
    step's metrics and state, the prefill and three decode steps' logits,
    the shapes of the train step's compute tree and of this rank's cache,
    and how many parameter or cache gathers crossed the model axis."""
    real, calls = sharding.gather, []

    def spy(x, keep=()):
        _gathers_over_model(calls, x, keep)
        return real(x, keep)

    seen = {}
    model = build_model(rec_cfg(fam))

    def train_loss(params, batch):
        seen.update({k: tuple(v.shape) for k, v in params.leaves().items()})
        return model.train_loss(params, batch)

    sharding.gather = spy
    try:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        new, metrics, _ = _step(inp, mesh, None, model=dataclasses.replace(
            model, train_loss=train_loss), params_key=f"{fam}_params")
        train_calls, calls[:] = sum(calls), []
        out, cache = _serve_model(model, mesh, inp[f"{fam}_params"],
                                  inp[f"{fam}_batch"]["tokens"], REC_PRE[fam])
        out["local_cache"] = {path: tuple(x.to_local().shape)
                              for path, x in _cache_leaves(cache)}
        serve_calls = sum(calls)
    finally:
        sharding.gather = real
    return {**{k: metrics[k] for k in ("loss", "grad_norm")}, "state": full_state(new),
            "tree": seen, "train_over_model": train_calls, "serve_over_model": serve_calls,
            **out}


def _serve_model(model, mesh, leaves: dict, tokens, n_pre: int):
    """``jit_prefill`` of ``n_pre`` tokens and three ``jit_serve_step`` calls:
    ``({"prefill", "decode0".."decode2": logits, "c_spec"}, the cache)``."""
    prefill, p_sh, _, c_sh = jit_prefill(mesh, model, ShapeConfig("p", S_MAX, B, "prefill"))
    step, _, _, _ = jit_serve_step(mesh, model, ShapeConfig("d", S_MAX, B, "decode"),
                                   donate=False)
    params = params_of(model, leaves)
    params = params.replace_leaves({k: sharding.distribute(p, p_sh[k])
                                    for k, p in params.leaves().items()})
    logits, cache, t = prefill(params, {"tokens": tokens[:, :n_pre]})
    out = {"prefill": logits, "c_spec": sharding.describe(c_sh)}
    for i in range(3):
        logits, cache, t = step(params, cache, tokens[:, n_pre + i:n_pre + i + 1], t)
        out[f"decode{i}"] = logits
    return out, cache


def _cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _cache_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _cache_leaves(v, f"{prefix}{i}.")]
    return [(prefix.rstrip("."), tree)]


def case_rec_ssm22(inp):
    return _rec(inp, "ssm", (2, 2))


def case_rec_ssm14(inp):
    return _rec(inp, "ssm", (1, 4))


def case_rec_hyb22(inp):
    return _rec(inp, "hyb", (2, 2))


def case_rec_hyb14(inp):
    return _rec(inp, "hyb", (1, 4))


def case_sp22(inp):
    """qwen2 smoke's step on (2, 2) with ``sequence_parallel=True``, and the
    same mesh's step without it."""
    out = {}
    for name, seq in (("sp", True), ("tp", False)):
        model = build_model(dataclasses.replace(train_cfg(), sequence_parallel=seq))
        new, metrics, _ = _step(inp, (2, 2), ("data", "model"), model=model)
        out[name] = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                     "state": full_state(new)}
    return out


def case_allreduce(inp):
    mesh = make_mesh((dist.get_world_size(),), ("pod",), device_type="cpu")
    group = mesh.get_group("pod")
    x = inp["ar_x"][dist.get_rank()]
    ef = torch.zeros_like(x)
    q, scale = collectives.quantize_int8(x.float() + ef)
    mean, ef1 = collectives.compressed_allreduce_mean(x, ef, group)
    plain = collectives.allreduce_mean(x, group)
    efs, running = ef, torch.zeros_like(x)
    for _ in range(30):
        m, efs = collectives.compressed_allreduce_mean(x, efs, group)
        running = running + m
    return {"q": q, "scale": scale, "mean": mean, "ef": ef1, "plain": plain,
            "running": running / 30}


def case_ckpt_save(inp):
    new, metrics, _ = _step(inp, (4, 2), ("data", "model"))
    CheckpointManager(inp["ckpt_dir"], keep=1).save(1, new)
    return {"state": full_state(new), "wrote": sorted(os.listdir(inp["ckpt_dir"]))}


def case_ckpt_restore(inp):
    model, opt = build_model(train_cfg()), optimizer()
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    init, st_sh = jit_init_state(mesh, model, opt)
    like = init(torch.Generator().manual_seed(1))  # other weights: restore must replace them
    restored, step_no = CheckpointManager(inp["ckpt_dir"], keep=1).restore(like)
    placed = all(p.placements == st_sh.params[k].placements
                 for k, p in restored.params.leaves().items())
    saved = full_state(restored)
    step, _, _ = jit_train_step(mesh, model, opt, ShapeConfig("t", S, B, "train"), donate=False)
    new, metrics = step(restored, inp["batch"])
    # the same mesh's step from the same state placed in memory, with no checkpoint
    fresh, fresh_metrics = step(shard_state(state_of(model, saved), st_sh), inp["batch"])
    return {"step": step_no, "placed": placed, "restored": saved, "loss": metrics["loss"],
            "state": full_state(new), "fresh_loss": fresh_metrics["loss"],
            "fresh_state": full_state(fresh)}


def _serve(inp, seq_sharded: bool):
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out, cache = _serve_model(build_model(decode_cfg(seq_sharded)), mesh, inp["dec_params"],
                              inp["dec_tokens"], S_PRE)
    out["local_cache"] = {k: v.to_local().clone() for k, v in cache[0].items()}
    out["cache"] = {k: v.full_tensor() for k, v in cache[0].items()}
    return out


def case_seqdecode(inp):
    return _serve(inp, True)


def case_ringdecode(inp):
    return _serve(inp, False)


def case_rows(inp):
    """Which elements each rank holds under a few specs, for the element order;
    and ``axes.shard`` moving a DTensor to the placements its roles resolve to."""
    out = {}
    full = torch.arange(16 * 8).reshape(16, 8)
    for names in (("pod", "data", "model"), ("replica", "shard", "model")):
        mesh = make_mesh((2, 2, 2), names, device_type="cpu")
        for name, spec in inp["row_specs"][names].items():
            sh = sharding.NamedSharding(mesh, sharding.PartitionSpec(*spec))
            out[f"{names[0]}:{name}"] = sharding.distribute(full, sh).to_local().clone()
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    x = sharding.distribute(full, sharding.NamedSharding(
        mesh, sharding.PartitionSpec(("pod", "data"))))
    with axes.logical_axes(mesh, ("pod", "data"), "model"):
        out["shard:model"] = axes.shard(x, None, "model").to_local().clone()
        out["shard:both"] = axes.shard(x, "batch", "model").to_local().clone()
        out["shard:cols"] = axes.shard(x, None, "batch").to_local().clone()
    return out


def case_launch(inp):
    """The launcher's command line (the smoke config: bfloat16 compute)."""
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "3", "--seq-len", "32",
                       "--device", "cpu", "--ckpt-dir", inp["launch_dir"], "--ckpt-every", "2",
                       "--log-every", "1"])
    return {}


def case_launch_f32(inp):
    """``launch.train.train`` in float32 compute, no checkpoints."""
    from repro_torch.launch import train as launch_train

    report = launch_train.train(train_cfg(), steps=3, seq_len=32, device="cpu", ckpt_every=0,
                                ckpt_dir=inp["launch_dir"] + "_f32", log_every=1)
    return {"losses": report["losses"], "grad_norms": report["grad_norms"]}


def run_ranks(cases, world: int, workdir, timeout: float = 420.0) -> dict:
    """Run ``cases`` on ``world`` gloo ranks -> {case: [rank 0's output, ...]}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    store = os.path.join(workdir, f"store{world}")
    if os.path.exists(store):  # a file store is good for one world only
        os.remove(store)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{world}.{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, ",".join(cases), str(r), str(world), store, str(workdir)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        tail = open(os.path.join(workdir, f"rank{world}.0.log")).read()[-4000:]
        raise AssertionError(f"ranks exited {[p.returncode for p in procs]}:\n{tail}")
    return {c: [torch.load(os.path.join(workdir, f"{c}.rank{r}.pt"), weights_only=False)
                for r in range(world)] for c in cases}


def main(argv) -> int:
    cases, rank, world, store, workdir = argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5]
    torch.set_num_threads(1)
    # a rank whose case raised leaves the others in a collective: fail it after a minute
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        for case in cases.split(","):
            try:
                out = globals()[f"case_{case}"](inp)
            except Exception:  # reported to the test, which fails that case alone
                out = {"error": traceback.format_exc()}
            torch.save(out, os.path.join(workdir, f"{case}.rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
