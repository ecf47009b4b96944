"""The port's dry run against the reference's on the same smoke cells.

``repro_torch.launch.dryrun.run_cell`` and ``repro.launch.dryrun.run_cell``
on qwen2-1.5b's smoke config at the real shapes ``train_4k``,
``prefill_32k`` and ``decode_32k``, with the dry run's overrides
(bf16 parameters, padded vocabulary) and ``pad_heads_to=4``, each on a
(2, 4) ("data", "model") and a (2, 2, 2) ("pod", "data", "model") mesh
(``mesh_override``).  The port runs on a fake world of 8 ranks, the
reference on 8 of the 512 host devices its module asks for; each in a
subprocess of its own (the reference sets ``XLA_FLAGS`` before importing
jax, the port starts a fake process group).  The reference runs with
``scan_layers=False``: stacked, its dense MLP's leaves meet the MoE experts'
3-D rule (``ROADMAP.md`` §3) and shard differently from the port's
unstacked ones.

* Per-device argument bytes equal the reference's
  ``memory_analysis.argument_size_in_bytes`` byte for byte (parameters,
  AdamW moments and counters, the batch, the cache), but for decode's 4
  bytes: the reference takes the position ``t`` as an int32 device scalar,
  the port as a Python int.
* FLOPs are within 3 % of the reference's loop-aware ``hlo_stats`` count.
  Prefill and decode are equal.  Train differs by two terms: (a) the
  port's closed-form attention backward (``attention_bwd``) forms
  ``softmax(Q K^T)`` again, one product of ``2 b h Sq Sk hd`` a layer that
  XLA's differentiation takes from the remat recompute -- a quarter of the
  port's forward-and-recompute attention FLOPs, counted out here (11 % of
  the smoke step, where attention over 4096 keys dominates a width of 64);
  (b) the port's remat recompute forms each layer's ``o @ wo`` again (its
  sum feeds the residual stream the MLP's norm reads), 0.17 % on (2, 4);
  the reference's compiled recompute does not hold that product.
* The port's collectives equal a count written out here from the sharding
  rules and the model's regions: the parameters' gathers over the FSDP
  axis, the batch's gathers over the batch axes, the model group's sums
  (embedding, two a block, the vocab-parallel cross-entropy's three, the
  remat recompute's one a block, the backward's sums of entered regions and
  replicated kv leaves), the batch axes' gradient sums and scalars, the
  clipping norm's one sum, the logits' gathers; each kind's count, bytes,
  ring-model wire bytes and the within-pod / across-pods split.  The
  reference's collectives are reported beside them and not held: XLA's
  partitioner picks its own.
* One full-width cell, qwen2-1.5b ``train_4k`` on the 16 x 16 production
  mesh (256 fake ranks), runs ``ok`` and its FLOPs are within 2 % of the
  count derived here from the config: the forward, the remat recompute and
  the backward of each layer's products, the unembedding, and the attention.
* ``launch/perf_cells.py``'s variants are the reference's, and its
  technique cell (the RDP mesh, r = 2) runs at about twice the baseline's
  per-device FLOPs.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OVERRIDES = {"smoke": True, "pad_heads_to": 4, "scan_layers": False}
CELLS = [(m, s) for m in MESHES for s in SHAPE_NAMES]
IDS = [f"{m}-{s}" for m, s in CELLS]


def _port(out_dir: str) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    out = {}
    dryrun.fake_world(8)
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, "cpu")
        for s in SHAPE_NAMES:
            out[f"{name}/{s}"] = dryrun.run_cell(ARCH, s, False, out_dir, skip_existing=False,
                                                 overrides=OVERRIDES, tag=f"_{name}",
                                                 mesh_override=mesh)
    out["full"] = dryrun.run_cell(ARCH, "train_4k", False, out_dir, skip_existing=False)
    from repro_torch.launch import perf_cells

    out["technique"] = perf_cells.run_technique_cell(force=True, out_dir=out_dir)
    out["variants"] = perf_cells.VARIANTS
    return out


def _reference(out_dir: str) -> dict:
    from repro.launch import dryrun  # sets XLA_FLAGS before it imports jax

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.launch import perf_cells

    out = {"variants": perf_cells.VARIANTS}
    for name, (shape, axes) in MESHES.items():
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
        for s in SHAPE_NAMES:
            out[f"{name}/{s}"] = dryrun.run_cell(ARCH, s, False, pathlib.Path(out_dir),
                                                 skip_existing=False, overrides=OVERRIDES,
                                                 tag=f"_{name}", mesh_override=mesh)
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu")
    procs = {}
    for side in ("port", "reference"):
        out = tmp_path_factory.mktemp(side)
        procs[side] = (subprocess.Popen([sys.executable, __file__, side, str(out)], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), out)
    got = {}
    for side, (proc, out) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{side}: {stderr[-3000:]}"
        got[side] = json.loads((out / "records.json").read_text())
    return got


def _pair(records, mesh, shape):
    port, ref = records["port"][f"{mesh}/{shape}"], records["reference"][f"{mesh}/{shape}"]
    assert port["ok"], port.get("traceback")
    assert ref["ok"], ref.get("traceback")
    return port, ref


@pytest.mark.parametrize("mesh,shape", CELLS, ids=IDS)
def test_argument_bytes_equal_reference(records, mesh, shape):
    port, ref = _pair(records, mesh, shape)
    got = port["memory"]["argument_bytes"]
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    t_scalar = 4 if shape.startswith("decode") else 0  # the reference's int32 position
    assert got + t_scalar == want
    mem = port["memory"]
    assert got == mem["state_bytes"] + mem["batch_bytes"] + mem["cache_bytes"]
    assert mem["peak_bytes"] >= got and mem["fits"]


@pytest.mark.parametrize("mesh,shape", CELLS, ids=IDS)
def test_flops_within_three_percent_of_reference(records, mesh, shape):
    port, ref = _pair(records, mesh, shape)
    got, want = port["step_stats"]["flops"], ref["hlo_stats"]["flops"]
    # (a): the closed-form attention backward's product that forms P again
    extra = port["step_stats"]["attention_flops"] / 4 if shape.startswith("train") else 0.0
    assert abs(got - extra - want) <= 0.03 * want, (got, extra, want)
    if not shape.startswith("train"):
        assert got == want


def _axes(spec) -> set:
    out = set()
    for part in spec:
        if part is not None:
            out.update((part,) if isinstance(part, str) else part)
    return out


def expected_collectives(cfg, shape, sizes: dict, microbatches: int, pod_size) -> dict:
    """The port's collectives of one step by kind, counted from the sharding
    rules and the model's regions (a dense, tied-embedding, biased-qkv
    decoder under full remat, as qwen2's smoke config)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model
    from repro_torch.runtime.train import param_shapes

    names = list(sizes)
    batch_axes = [a for a in names if a in ("pod", "data")]
    tp_size = sizes.get("model", 1)
    leaves = param_shapes(build_model(cfg))
    specs = sharding.param_shardings(sizes, leaves)
    pb, cb = cfg.dtype("param").itemsize, cfg.dtype("compute").itemsize
    L, d, hd, n_kv = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    v_pad = cfg.padded_vocab
    events = []

    def model_local(k, itemsize):
        n = math.prod(leaves[k].shape) * itemsize
        return n // tp_size if "model" in _axes(specs[k].spec) else n

    def gather_over(axes, whole):  # minor axis first; each output grows
        left = math.prod(sizes[a] for a in axes)
        for a in reversed(axes):
            events.append(("all-gather", a, whole * sizes[a] // left))
            left //= sizes[a]

    def each_batch_axis(kind, nbytes):
        for a in batch_axes:
            events.append((kind, a, nbytes))

    for k in leaves:  # the parameters, whole but over "model"
        if "data" in _axes(specs[k].spec):
            events.append(("all-gather", "data", model_local(k, pb)))
    b, s = shape.global_batch, shape.seq_len
    b_loc = b // math.prod(sizes[a] for a in batch_axes)
    if shape.kind == "train":
        for itemsize in (4, 4, 4):  # tokens, labels (int32), loss_mask (f32)
            gather_over(batch_axes, b * s * itemsize)
        rows = b_loc // microbatches
        act = rows * s * d * cb
        for _ in range(microbatches):
            each_batch_axis("all-reduce", 4)  # the mask's sum over the global batch
            # forward: embedding, two a block; cross-entropy: max, exp-sum, label logit
            events += [("all-reduce", "model", act)] * (1 + 2 * L)
            events += [("all-reduce", "model", rows * s * 4)] * 3
            events += [("all-reduce", "model", act)] * L  # the recompute's attention sums
            # backward: the entered regions' inputs (attention, MLP, unembedding)
            events += [("all-reduce", "model", act)] * (2 * L + 1)
            # and the replicated wk / wv / bk / bv each block reads a part of
            events += [("all-reduce", "model", d * n_kv * hd * cb)] * (2 * L)
            events += [("all-reduce", "model", n_kv * hd * cb)] * (2 * L)
            each_batch_axis("all-reduce", 4)  # the loss metric
            each_batch_axis("all-reduce", 4)  # the total loss
        g_item = pb if microbatches == 1 else 4
        for k in leaves:  # each gradient summed over the batch axes
            each_batch_axis("all-reduce", model_local(k, g_item))
        split = sum("model" in _axes(specs[k].spec) for k in leaves)
        events.append(("all-reduce", "model", split * 4))  # the clipping norm's squares
    else:
        s_in = s if shape.kind == "prefill" else 1
        gather_over(batch_axes, b * s_in * 4)  # the tokens
        events += [("all-reduce", "model", b_loc * s_in * d * cb)] * (1 + 2 * L)
        events.append(("all-gather", "model", b_loc * v_pad * 4))  # the last logits' columns
        gather_over(batch_axes, b * v_pad * 4)  # every rank's rows
    from repro_torch.launch.step_stats import wire_bytes

    out: dict = {}
    for kind, axis, nbytes in events:
        if sizes[axis] == 1:
            continue
        wire = wire_bytes(kind, nbytes, sizes[axis])
        slot = out.setdefault(kind, {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0,
                                     "ici_bytes": 0.0, "dcn_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += nbytes
        slot["wire_bytes"] += wire
        slot["dcn_bytes" if axis == "pod" and pod_size else "ici_bytes"] += wire
    return out


@pytest.mark.parametrize("mesh,shape", CELLS, ids=IDS)
def test_collectives_equal_analytic_count(records, mesh, shape):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import DRYRUN_OVERRIDES

    port, ref = _pair(records, mesh, shape)
    ov = dict(DRYRUN_OVERRIDES, **OVERRIDES)
    cfg = get_config(ARCH, **ov)
    sizes = port["mesh_shape"]
    pod = port["n_devices"] // sizes["pod"] if "pod" in sizes else None
    want = expected_collectives(cfg, SHAPES[shape], sizes, port.get("microbatches", 1), pod)
    got = port["step_stats"]["collectives"]
    beside = {k: (v["count"], v["bytes"]) for k, v in ref["hlo_stats"]["collectives"].items()}
    assert got == want, f"the reference's (count, bytes) beside: {beside}"


def _full_width_flops(cfg, shape, dp: int, tp_size: int, microbatches: int) -> float:
    """Per-device FLOPs of a train step of a dense decoder on (dp, tp_size),
    padded heads over the model axis: each layer's products (q, the kv heads
    its query slots read, o, the gated MLP's three) forward and twice in the
    backward, and in the remat recompute all but the MLP's down projection
    (the recompute stops at the block's last saved tensor, its input); the
    unembedding forward and twice backward; attention (counted dense)
    forward and recompute, and the closed-form backward's five products."""
    from repro_torch.models.transformer import HeadLayout

    lay = HeadLayout.make(cfg.n_heads, cfg.n_kv_heads, cfg.pad_heads_to)
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    slots = lay.h_pad // tp_size  # rank 0's query slots
    kv = ((slots - 1) // lay.g_pad) // lay.repeat + 1  # the true kv heads they read
    rows = shape.global_batch // dp
    t = rows * shape.seq_len
    down = 2 * t * (cfg.d_ff // tp_size) * d
    layer = 2 * t * (d * slots * hd + 2 * d * kv * hd + slots * hd * d) + 3 * down
    unembed = 2 * t * d * (cfg.padded_vocab // tp_size)
    attn = 4 * rows * slots * shape.seq_len ** 2 * hd  # forward of one layer
    del microbatches  # the chunks' sum is the batch's
    return L * (4 * layer - down + 2 * attn + 2.5 * attn) + 3 * unembed


def test_full_width_cell_runs_and_counts_its_flops(records):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import DRYRUN_OVERRIDES

    rec = records["port"]["full"]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh_shape"] == {"data": 16, "model": 16} and rec["n_devices"] == 256
    cfg = get_config(ARCH, **DRYRUN_OVERRIDES)
    want = _full_width_flops(cfg, SHAPES["train_4k"], 16, 16, rec["microbatches"])
    got = rec["step_stats"]["flops"]
    assert abs(got - want) <= 0.02 * want, (got, want)
    assert rec["memory"]["fits"]
    assert rec["step_stats"]["launches_by_kernel"]["wgmma"] == 2 * cfg.n_layers * \
        rec["microbatches"]


if __name__ == "__main__":
    side, out_dir = sys.argv[1], sys.argv[2]
    recs = (_port if side == "port" else _reference)(out_dir)
    pathlib.Path(out_dir, "records.json").write_text(json.dumps(recs))


def test_perf_cells_are_the_reference_variants_and_the_technique_cell_runs(records):
    """The port's lever variants are the reference's, and the technique cell
    (qwen2-1.5b train_4k on the RDP mesh: replica 2, shard 8, model 16) runs
    with each replica group computing every microbatch: twice the per-device
    batch of the (16, 16) baseline, so within 10 % of twice its FLOPs."""
    assert records["port"]["variants"] == records["reference"]["variants"]
    rec, base = records["port"]["technique"], records["port"]["full"]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh_shape"] == {"replica": 2, "shard": 8, "model": 16}
    ratio = rec["step_stats"]["flops"] / base["step_stats"]["flops"]
    assert 1.8 <= ratio <= 2.2, ratio
