"""``launch/step_stats.py``: per-device statistics of one step, op by op.

* FLOPs: a loop of L matmuls of d x d gives ``2 d^3 L`` exactly; the
  attention operator's formula is torch's own ``scaled_dot_product_attention``
  formula on the same shapes (its query heads over every key); a smoke
  model's train step counts what ``torch.utils.flop_counter.FlopCounterMode``
  counts over the same step.
* Collectives: all-reduce, all-gather and reduce-scatter on a fake process
  group of 8 ranks (a subprocess: ``torch.testing._internal.distributed.fake_pg``)
  give the reference's bytes and ring-model wire bytes exactly
  (``repro.launch.hlo_stats``'s formulas, restated here), with the split
  between within a pod (``ici_bytes``) and across pods (``dcn_bytes``) right
  on a (2, 2, 2) ("pod", "data", "model") mesh.
* ``launches_by_kernel`` follows ``flash_attention.attention_route`` for
  each attention kernel, counts the three RMSNorm operators apart, and
  counts a backward operator's call once for each of its three kernels.
* The peak of live device bytes counts each storage once.

No jax.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode, sdpa_flop_count  # noqa: E402

from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.launch.step_stats import StepStats, stats_to_dict, wire_bytes  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("d,n_layers", [(64, 1), (96, 5), (256, 3)])
def test_matmul_loop_flops_exact(d, n_layers):
    x = torch.empty((d, d), device="meta")
    ws = [torch.empty((d, d), device="meta") for _ in range(n_layers)]
    with StepStats("meta") as st:
        for w in ws:
            x = x @ w
    assert st.t.flops == 2 * d**3 * n_layers
    assert st.t.attention_flops == 0


@pytest.mark.parametrize("b,sq,h,kh,sk,hd", [(2, 128, 8, 2, 128, 64), (4, 1, 12, 2, 1056, 128),
                                             (1, 77, 16, 16, 77, 80)])
def test_attention_formula_is_torch_sdpa(b, sq, h, kh, sk, hd):
    q = torch.empty((b, sq, h, hd), device="meta")
    k = torch.empty((b, sk, kh, hd), device="meta")
    pos_q = torch.empty((b, sq), dtype=torch.int32, device="meta")
    pos_k = torch.empty((b, sk), dtype=torch.int32, device="meta")
    want = sdpa_flop_count((b, h, sq, hd), (b, h, sk, hd), (b, h, sk, hd))
    with StepStats("meta") as st:
        flash.attention(q, k, k, pos_q, pos_k)
    assert st.t.flops == st.t.attention_flops == want == flash.attention_flops(b, sq, h, sk, hd)
    with FlopCounterMode(display=False) as fc:
        flash.attention(q, k, k, pos_q, pos_k)
    assert fc.get_total_flops() == want


def test_train_step_flops_equal_flop_counter_mode():
    """A smoke model's loss and gradients (remat on, CPU tensors): the same
    FLOPs under StepStats as under FlopCounterMode."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0)).trainable()
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.long(), "loss_mask": torch.ones(2, 16)}

    def step():
        loss, _ = model.train_loss(params, batch)
        return torch.autograd.grad(loss, list(params.leaves().values()))

    with StepStats("cpu") as st:
        step()
    with FlopCounterMode(display=False) as fc:
        step()
    assert st.t.flops == fc.get_total_flops() > 0
    assert st.t.attention_flops == 2 * cfg.n_layers * flash.attention_flops(
        2, 16, cfg.n_heads, 16, cfg.head_dim)  # forward and the remat recompute


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launches_by_kernel_follow_route(dtype):
    cases = [((2, 1, 8, 64), (2, 40, 2, 64)),      # one query row a kv group: split-KV
             ((1, 32, 8, 64), (1, 32, 2, 64)),     # a prefill: wgmma in bf16, else CUDA cores
             ((1, 24, 4, 68), (1, 24, 4, 68))]     # bf16 rows off 16 bytes: CUDA cores
    want = dict.fromkeys(("rmsnorm", "sumsq", "scaled", "splitkv", "wgmma", "simt",
                          "bwd_delta", "bwd_dkdv", "bwd_dq"), 0)
    with StepStats("meta") as st:
        for qs, ks in cases:
            q = torch.empty(qs, dtype=dtype, device="meta")
            k = torch.empty(ks, dtype=dtype, device="meta")
            pq = torch.empty(qs[:2], dtype=torch.int32, device="meta")
            pk = torch.empty(ks[:2], dtype=torch.int32, device="meta")
            flash.attention(q, k, k, pq, pk)
            want[flash.attention_route(q, k, k)] += 1
            lse = torch.empty(qs[0], qs[2], qs[1], device="meta")
            if flash.attention_route(q, k, k) == "wgmma":  # training's forward: its backward
                assert flash.backward_route(q, k, k, lse) == "kernels"
                flash.attention_backward(q, q, k, k, q, lse, pq, pk)
                for name in ("bwd_delta", "bwd_dkdv", "bwd_dq"):
                    want[name] += 1
        x = torch.empty((4, 64), dtype=dtype, device="meta")
        w = torch.empty((64,), dtype=dtype, device="meta")
        rmsnorm.rms_norm_fused(x, w)
        rmsnorm.rms_norm_fused(x, w)
        total = rmsnorm.row_sumsq(x)
        rmsnorm.rms_norm_scaled(x, w, total, 128)
    want.update(rmsnorm=2, sumsq=1, scaled=1)
    assert st.t.launches_by_kernel == want
    routes = [flash.attention_route(torch.empty(q, dtype=dtype, device="meta"),
                                    *[torch.empty(k, dtype=dtype, device="meta")] * 2)
              for q, k in cases]
    assert routes == ["splitkv", "wgmma" if dtype == torch.bfloat16 else "simt", "simt"]


def test_peak_counts_each_storage_once():
    with StepStats("meta") as st:
        a = torch.empty((1024,), device="meta")  # 4096 bytes
        b = a.view(32, 32)  # a view: no new storage
        c = b + 1  # 4096 more
        del c
        d = torch.empty((256,), device="meta")  # 1024
    assert st.peak_bytes == 8192
    assert st.live_bytes == 4096 + 1024
    del a, b, d


def test_wire_bytes_formulas():
    assert wire_bytes("all-reduce", 800, 8) == 2 * 7 / 8 * 800
    assert wire_bytes("all-gather", 800, 8) == 7 / 8 * 800
    assert wire_bytes("reduce-scatter", 100, 8) == 7 * 100
    assert wire_bytes("all-to-all", 800, 4) == 3 / 4 * 800
    assert wire_bytes("all-reduce", 800, 1) == 0.0


def _fake_group_case() -> dict:
    """The collectives of a fake world of 8 on a (2, 2, 2) mesh, under StepStats."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    fake_world(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    x = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")  # 4096 bytes
    out = {}
    for name, group in (("model", mesh.get_group("model")), ("pod", mesh.get_group("pod")),
                        ("world", dist.group.WORLD)):
        n = dist.get_world_size(group)
        with StepStats("meta", pod_size=4) as st:
            dist.all_reduce(x, group=group)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            shard = torch.empty((64 // n, 32), dtype=torch.bfloat16, device="meta")
            dist.reduce_scatter_tensor(shard, x, group=group)
        out[name] = {"n": n, "ranks": dist.get_process_group_ranks(group),
                     "stats": stats_to_dict(st)["collectives"]}
    # a shard that is a contiguous slice (dim 0) holds its own storage, not the whole's
    from repro_torch.distributed import sharding

    full = torch.empty((16, 4), device="meta")
    shard = sharding.distribute(full, sharding.NamedSharding(mesh, sharding.P(("pod", "data"))))
    local = shard.to_local()
    out["shard"] = [list(local.shape), local.untyped_storage().nbytes()]
    return out


def test_collective_bytes_on_a_fake_group_of_eight():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, __file__], capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["model"]["ranks"] == [0, 1] and got["pod"]["ranks"] == [0, 4]
    assert got["world"]["ranks"] == list(range(8))
    assert got["shard"] == [[4, 4], 4 * 4 * 4]  # sharding.distribute keeps no whole leaf alive
    for name, crosses in (("model", False), ("pod", True), ("world", True)):
        n, st = got[name]["n"], got[name]["stats"]
        want = {"all-reduce": 4096, "all-gather": 4096 * n, "reduce-scatter": 4096 // n}
        assert set(st) == set(want), name
        for kind, nbytes in want.items():
            # the reference's ring model (hlo_stats._local_stats)
            wire = {"all-reduce": 2.0 * (n - 1) / n * nbytes,
                    "all-gather": (n - 1) / n * nbytes,
                    "reduce-scatter": float(n - 1) * nbytes}[kind]
            slot = st[kind]
            assert slot["count"] == 1 and slot["bytes"] == nbytes, (name, kind, slot)
            assert slot["wire_bytes"] == wire, (name, kind, slot)
            assert slot["dcn_bytes" if crosses else "ici_bytes"] == wire, (name, kind, slot)
            assert slot["ici_bytes" if crosses else "dcn_bytes"] == 0.0, (name, kind, slot)


if __name__ == "__main__":
    print(json.dumps(_fake_group_case()))
