"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on fake ranks.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step for the 16x16 single-pod and 2x16x16 two-pod meshes and reads
XLA's memory and cost analyses and the partitioned HLO.  The port compiles
nothing: it starts a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once), builds the production mesh on it (``launch/mesh.py``), builds
rank 0's state and batch on ``meta`` tensors (shapes, dtypes and strides,
no storage; every shard is even, so rank 0's is any rank's) and runs one
real step of the port on them: ``jit_train_step`` for ``train_*``,
``jit_prefill`` for ``prefill_*``, ``jit_serve_step`` -- one token against a
``seq_len`` cache -- for ``decode_*`` / ``long_*``.  The hand kernels are
custom operators whose fake implementations give their outputs' shapes and
launch nothing; the route each call would take on an H100 is read from its
tensors (``flash_attention.attention_route``).  ``meta`` and not fake
``cuda`` tensors: a CPU-only build of torch cannot index a fake ``cuda``
tensor (its Python binding takes a CUDA device guard), and the step's
values are not needed.  :class:`~repro_torch.launch.step_stats.StepStats`
reads the rank's ops as they run, and each record holds:

  * ``memory``     -- the state bytes per device (parameters, AdamW moments,
                      step counters), the batch and cache bytes, the
                      argument bytes (their sum), the peak of live device
                      bytes during the step (each storage once) and ``fits``
                      against the H100's device memory
  * ``step_stats`` -- per-device FLOPs (the attention kernel's apart), the
                      eager program's device traffic, the collectives by kind
                      (bytes and ring-model wire bytes, within a pod and
                      across pods) and the hand kernels' launches by kernel

Records go to ``build/dryrun/<mesh>_<arch>_<shape>.json`` (``build/`` is
ignored by git); a failure is recorded, not raised.  These are predictions
for a mesh of H100s, not measurements: ``chip_smoke.py``'s phase 20 holds
one cell's prediction against the same step run on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the records as a table
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, SHAPES, applicable_shapes, get_config, skipped_shapes
from ..distributed import sharding
from ..models import build_model
from ..optim import AdamW, cosine_with_warmup
from ..runtime.serve import _cache_shapes, _prefill_batch_shapes, jit_prefill, jit_serve_step
from ..runtime.train import (TrainState, _input_shapes, default_microbatches, jit_train_step,
                             shard_state)
from .mesh import make_production_mesh
from .step_stats import StepStats, stats_to_dict

__all__ = ["ARTIFACTS", "DRYRUN_OVERRIDES", "H100_MEMORY_BYTES", "build_step", "fake_world",
           "main", "predict_step", "run_cell"]

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# dry-run numerics, the reference's: bf16 params + fp32 Adam moments, TP
# padding for the 16-wide model axis, vocab padded to 16*128
DRYRUN_OVERRIDES = dict(
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    pad_heads_to=16,
    pad_vocab_to_multiple=2048,
)

# the device memory a cell must fit: torch.cuda.get_device_properties(0).total_memory
# as it reads on an NVIDIA H100 80GB HBM3 (chip_smoke.py's phase 20 prints it
# and checks this constant against the card)
H100_MEMORY_BYTES = 85_017_493_504

_DTYPES = {"tokens": torch.int32, "labels": torch.int32, "loss_mask": torch.float32,
           "mrope_positions": torch.int32}


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0 (every
    collective returns at once); an existing world of another size, or a real
    one, is torn down first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)


def _nbytes(tree) -> int:
    """Bytes of a tree of tensors on this rank (a DTensor's local shard)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree._local_tensor if hasattr(tree, "_local_tensor") else tree
        return t.numel() * t.element_size()
    return 0


def _place_tree(tree, sh_tree):
    if isinstance(tree, dict):
        return {k: _place_tree(v, sh_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place_tree(v, s) for v, s in zip(tree, sh_tree)]
    return sharding.distribute(tree, sh_tree)


def _zeros_like_tree(tree, device):
    """Zeros of ``tree``'s shapes and dtypes on ``device``."""
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like_tree(v, device) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def _batch(shapes: Dict[str, torch.Size], cfg, device) -> Dict[str, torch.Tensor]:
    cdt = cfg.dtype("compute")
    return {k: torch.zeros(s, dtype=_DTYPES.get(k, cdt), device=device) for k, s in shapes.items()}


def _params(model, device: str):
    """The model's parameters on ``device``: zeros on ``meta`` (shapes and
    dtypes only; traced under ``FakeTensorMode``, so nothing is allocated),
    seeded draws elsewhere."""
    if device != "meta":
        return model.init(torch.Generator(device=device).manual_seed(0))
    with FakeTensorMode():
        tree = model.init(torch.Generator())
    return tree.replace_leaves({k: torch.zeros(p.shape, dtype=p.dtype, device=device)
                                for k, p in tree.leaves().items()})


def build_step(model, shape, mesh, microbatches: int = 1, mesh_axes=None,
               device: str = "meta"):
    """``(step, args, roots, memory)``: the cell's mesh step, its arguments
    on ``device`` (this rank's shards; zeros on ``meta``, seeded draws
    elsewhere), the tensors the arguments hold (for a memory tracker) and
    their bytes by kind.  ``step(*args)`` runs one step."""
    kind = shape.kind
    cfg = model.cfg
    if kind == "train":
        optimizer = AdamW(cosine_with_warmup(3e-4, 100, 10_000))
        step, st_sh, b_sh = jit_train_step(mesh, model, optimizer, shape,
                                           microbatches=microbatches, mesh_axes=mesh_axes)
        batch_shapes = _input_shapes(model, shape)
    elif kind == "prefill":
        step, p_sh, b_sh, _ = jit_prefill(mesh, model, shape)
        batch_shapes = _prefill_batch_shapes(model, shape)
    else:
        step, p_sh, c_sh, tok_sh = jit_serve_step(mesh, model, shape)
        cache_shapes = _cache_shapes(model, shape)
        b_sh = {"tokens": tok_sh}
        batch_shapes = {"tokens": torch.Size((shape.global_batch, 1))}

    params = _params(model, device)
    batch = {k: sharding.distribute(v, b_sh[k])
             for k, v in _batch(batch_shapes, cfg, device).items()}
    mem: Dict = {"batch_bytes": _nbytes(batch), "cache_bytes": 0}
    if kind == "train":
        params = params.trainable()
        state = shard_state(TrainState(torch.zeros((), dtype=torch.int32, device=device),
                                        params, optimizer.init(params)), st_sh)
        mem["param_bytes"] = _nbytes(state.params.leaves())
        mem["moment_bytes"] = _nbytes(state.opt_state.m) + _nbytes(state.opt_state.v)
        mem["counter_bytes"] = _nbytes([state.step, state.opt_state.count])
        roots = [state.params.leaves(), state.opt_state.m, state.opt_state.v, state.step,
                 state.opt_state.count, batch]
        args = (state, batch)
        del state
    else:
        placed = params.replace_leaves(
            {k: sharding.distribute(p.detach(), p_sh[k]) for k, p in params.leaves().items()})
        mem["param_bytes"] = _nbytes(placed.leaves())
        mem["moment_bytes"] = mem["counter_bytes"] = 0
        roots = [placed.leaves(), batch]
        args = (placed, batch)
        if kind == "decode":
            cache = _place_tree(_zeros_like_tree(cache_shapes, device), c_sh)
            mem["cache_bytes"] = _nbytes(cache)
            roots.append(cache)
            args = (placed, cache, batch["tokens"], shape.seq_len - 1)
        del placed
    del params, batch
    mem["state_bytes"] = mem["param_bytes"] + mem["moment_bytes"] + mem["counter_bytes"]
    mem["argument_bytes"] = mem["state_bytes"] + mem["batch_bytes"] + mem["cache_bytes"]
    return step, args, roots, mem


def predict_step(model, shape, mesh, microbatches: int = 1, mesh_axes=None,
                 pod_size: Optional[int] = None) -> Dict:
    """One step of ``model`` at ``shape`` on ``mesh`` from this rank on
    ``meta`` tensors under :class:`StepStats`: the dry run's prediction.
    Returns ``{"memory": ..., "step_stats": ...}``."""
    step, args, roots, mem = build_step(model, shape, mesh, microbatches, mesh_axes)
    stats = StepStats("meta", pod_size)
    stats.track(roots)
    del roots
    # autograd's backward on this thread: the step's logical_axes context is per thread
    with torch.autograd.set_multithreading_enabled(False), stats:
        out = step(*args)
    del out, args
    mem["peak_bytes"] = stats.peak_bytes
    mem["device_bytes"] = H100_MEMORY_BYTES
    mem["fits"] = stats.peak_bytes <= H100_MEMORY_BYTES
    return {"memory": mem, "step_stats": stats_to_dict(stats)}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: pathlib.Path,
    skip_existing: bool = True,
    overrides: Optional[dict] = None,
    tag: str = "",
    mesh_override=None,  # e.g. the RDP ("replica","shard","model") mesh
) -> Dict:
    """One cell's record (written to ``out_dir``).  Without ``mesh_override``
    the cell's production mesh is built on a fake world of its size; a
    ``mesh_override`` is used as it is, on the process group it was built on."""
    mesh_name = ("multipod" if multi_pod else "singlepod") + tag
    out_path = pathlib.Path(out_dir) / f"{mesh_name}_{arch}_{shape_name}.json"
    if skip_existing and out_path.exists():
        return json.loads(out_path.read_text())

    shape = SHAPES[shape_name]
    ov = dict(DRYRUN_OVERRIDES)
    ov.update(overrides or {})
    mb_override = ov.pop("microbatches", None)
    mesh_axes_name = ov.pop("mesh_axes", None)
    cfg = get_config(arch, **ov)
    model = build_model(cfg)
    if mesh_override is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        mesh = mesh_override
    names = tuple(mesh.mesh_dim_names)
    sizes = [int(n) for n in mesh.shape]
    n_dev = int(mesh.size())
    pod_size = n_dev // sizes[names.index("pod")] if "pod" in names else None

    record: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_shape": dict(zip(names, sizes)),
        "n_devices": n_dev,
        "kind": shape.kind,
        "params_estimate": int(cfg.param_count_estimate()),
        "active_params_estimate": int(cfg.active_param_count_estimate()),
        "tokens_per_step": int(
            shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        ),
        "overrides": {k: str(v) for k, v in ov.items()},
        "ok": False,
    }

    t0 = time.time()
    try:
        mb, mesh_axes = 1, None
        if shape.kind == "train":
            mb = mb_override or default_microbatches(model, shape)
            record["microbatches"] = int(mb)
            if mesh_axes_name == "dp_over_model":
                mesh_axes = sharding.MeshAxes.dp_over_model(mesh)
                record["mesh_axes"] = mesh_axes_name
        out = predict_step(model, shape, mesh, microbatches=mb, mesh_axes=mesh_axes,
                           pod_size=pod_size)
        record.update(out)
        record["trace_s"] = round(time.time() - t0, 2)
        record["ok"] = True
    except Exception as e:  # recorded, not raised: failures are report items
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2))
    status = "ok" if record["ok"] else "FAIL"
    print(f"[{status}] {mesh_name} {arch} {shape_name} trace={record.get('trace_s', '-')}s",
          flush=True)
    return record


_KINDS = {"all-reduce": "AR", "all-gather": "AG", "reduce-scatter": "RS", "all-to-all": "A2A"}


def _wire(rec: Dict, key: str) -> str:
    coll = rec["step_stats"]["collectives"]
    parts = [f"{short} {coll[k][key] / 1e9:.3g}" for k, short in _KINDS.items()
             if coll.get(k, {}).get(key)]
    return " ".join(parts) or "0"


def _cells(rec: Optional[Dict]) -> list:
    """One mesh's columns of a cell: state (+ cache) GB, peak GB, fits,
    TFLOP (attention's), wire GB within a pod, across pods."""
    if rec is None:
        return ["-"] * 6
    if not rec["ok"]:
        return [f"failed: {rec['error'][:120]}"] + [""] * 5
    m, st = rec["memory"], rec["step_stats"]
    state = f"{m['state_bytes'] / 1e9:.3f}"
    if m["cache_bytes"]:
        state += f" + {m['cache_bytes'] / 1e9:.3f}"
    return [state, f"{m['peak_bytes'] / 1e9:.3f}", "yes" if m["fits"] else "**no**",
            f"{st['flops'] / 1e12:.2f} ({st['attention_flops'] / 1e12:.2f})",
            _wire(rec, "ici_bytes"), _wire(rec, "dcn_bytes")]


def table(out_dir) -> str:
    """The records in ``out_dir`` as a markdown table: a row a (tag, arch,
    shape), the single-pod mesh's columns, then the two-pod mesh's where it
    ran; failures with their error; then the skipped cells by reason."""
    recs = [json.loads(p.read_text()) for p in sorted(pathlib.Path(out_dir).glob("*.json"))]
    by: Dict = {}
    for r in recs:
        if r.get("skipped"):
            continue
        pod = "multi" if r["mesh"].startswith("multipod") else "single"
        tag = r["mesh"].split("pod", 1)[1]
        by.setdefault((tag, r["arch"], r["shape"]), {})[pod] = r
    cols = ("state (+ cache) GB", "peak GB", "fits", "TFLOP (attention)", "wire GB in a pod",
            "across pods")
    # one pod has no across-pods column
    head = [f"1 pod: {cols[0]}", *cols[1:-1], f"2 pods: {cols[0]}", *cols[1:]]
    rows = ["| tag | arch | shape | mb | " + " | ".join(head) + " |",
            "|" + "---|" * (4 + len(head))]
    for (tag, arch, shape), pods in sorted(by.items()):
        any_rec = pods.get("single") or pods.get("multi")
        rows.append(f"| {tag or '-'} | {arch} | {shape} | {any_rec.get('microbatches', '-')} | "
                    + " | ".join(_cells(pods.get("single"))[:-1] + _cells(pods.get("multi")))
                    + " |")
    skipped: Dict[str, list] = {}
    for r in (r for r in recs if r.get("skipped")):
        skipped.setdefault(r["reason"], []).append(f"{r['arch']} {r['shape']}")
    rows += [f"\nSkipped ({reason}): {', '.join(sorted(cells))}."
             for reason, cells in sorted(skipped.items())]
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown table, run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0

    out_dir = pathlib.Path(args.out)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_fail = 0
    for mp in meshes:  # one fake world per mesh size
        for arch in archs:
            shapes = applicable_shapes(arch)
            if args.shape != "all":
                if args.shape not in shapes:
                    print(f"[skip] {arch} {args.shape}: "
                          f"{skipped_shapes(arch).get(args.shape, 'n/a')}")
                    continue
                shapes = {args.shape: shapes[args.shape]}
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mp, out_dir, skip_existing=not args.force)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    for arch in archs:
        for shape_name, reason in skipped_shapes(arch).items():
            if args.shape in ("all", shape_name):
                p = out_dir / f"skipped_{arch}_{shape_name}.json"
                out_dir.mkdir(parents=True, exist_ok=True)
                p.write_text(json.dumps({
                    "arch": arch, "shape": shape_name, "skipped": True, "reason": reason,
                }, indent=2))
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
