"""The dry run against the card, the custom operators' launches, and the remat policy.

Shared with ``chip_smoke.py``'s phase 20 (this file imports no jax, so it
runs on the card's machine):

* :func:`kernel_counts` -- a profiler trace's device kernels by the hand
  kernel they are (``launch/step_stats.py``'s ``launches_by_kernel`` keys);
* :func:`remat_sums` -- a train step's loss and gradients on thread ranks
  (``tests/torch_tp_threads.py``) with the sums each rank's forward and its
  backward's recompute ran over the model group.

Card tests (marked ``cuda``; a fixture skips them where no card is present):

* each custom operator on a CUDA tensor launches its hand kernel (the
  wrappers' counts move by one, by ``route``), never the plain version;
* a smoke model's mesh train step on a world of one: the dry run's
  prediction (``launch/dryrun.py::predict_step`` on ``meta`` tensors) has
  the launches by kernel the wrappers count over the real step and the
  FLOPs ``FlopCounterMode`` counts over it, exactly;
* ``remat_policy="block_outs"`` at TP 2 on the card: gradients bitwise
  ``"full"``'s (float32), no sum over the model group in the recompute.

    PYTHONPATH=src:tests python -m pytest tests/test_torch_dryrun_cuda.py -m cuda -q
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch.step_stats import KERNELS  # noqa: E402

__all__ = ["kernel_class", "kernel_counts", "remat_sums"]


def kernel_class(name: str):
    """The ``launches_by_kernel`` key of a device kernel's name, or None.

    ``csrc/rmsnorm.cu``: ``rmsnorm_kernel<..., false>`` is the fused norm,
    ``rmsnorm_kernel<..., true>`` the split row's ``rmsnorm_scaled``,
    ``rmsnorm_sumsq_kernel`` its sum of squares; ``csrc/flash_attention.cu``:
    ``splitkv_kernel``, ``wgmma_kernel``, ``simt_kernel``, and the backward's
    ``flash_bwd::delta_kernel``, ``flash_bwd::dkdv_kernel``,
    ``flash_bwd::dq_kernel``."""
    if "flash_bwd::" in name:
        for k in ("delta", "dkdv", "dq"):
            if f"flash_bwd::{k}_kernel" in name:
                return f"bwd_{k}"
        return None
    if "rmsnorm_sumsq_kernel" in name:
        return "sumsq"
    if "rmsnorm_kernel" in name:
        return "scaled" if "true>" in name else "rmsnorm"
    for k in ("splitkv", "wgmma", "simt"):
        if f"{k}_kernel" in name:
            return k
    return None


def kernel_counts(names) -> dict:
    """Device kernel names (one per launch) counted by :func:`kernel_class`."""
    out = dict.fromkeys(KERNELS, 0)
    for name in names:
        k = kernel_class(name)
        if k is not None:
            out[k] += 1
    return out


def remat_sums(model, params, batch, size: int) -> list:
    """One loss-and-gradient step of ``model`` on ``size`` thread ranks
    (each its shard of ``params``), per rank ``(sums in the forward, sums in
    the backward's recompute, loss, gradients by leaf path)``.  A sum is a
    forward of ``leave`` or ``leave_to_shards`` over the model group (the
    recompute re-runs the forward; the backward's own collectives are the
    conjugate functions' backwards, not counted)."""
    import torch_tp_threads as th

    counts: dict = {}
    lock = threading.Lock()
    saved = (tp._Leave.forward, tp._LeaveToShards.forward)

    def counting(fn):
        def forward(ctx, *args):
            with lock:
                name = threading.current_thread().name
                counts[name] = counts.get(name, 0) + 1
            return fn(ctx, *args)
        return staticmethod(forward)

    tp._Leave.forward = counting(saved[0])
    tp._LeaveToShards.forward = counting(saved[1])
    try:
        def rank(r, group):
            p = th.rank_params(params, size, r, trainable=True)
            leaves = p.leaves()
            me = threading.current_thread().name
            loss, _ = model.train_loss(p, batch)
            fwd = counts.get(me, 0)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            return (fwd, counts.get(me, 0) - fwd, loss.detach(),
                    {k: g for k, g in zip(leaves, grads)})

        return th.run_ranks(size, rank)
    finally:
        tp._Leave.forward, tp._LeaveToShards.forward = saved


def smoke_batch(cfg, b: int, s: int, device, seed: int = 5) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                           dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
            "loss_mask": torch.ones((b, s), device=device)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def world_of_one(card, tmp_path):
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_kernel_class_reads_the_kernel_names():
    names = ["void (anonymous namespace)::rmsnorm_kernel<__nv_bfloat16, float, 8, false>(x)",
             "void (anonymous namespace)::rmsnorm_kernel<float, float, 4, true>(x)",
             "void (anonymous namespace)::rmsnorm_sumsq_kernel<float>(x)",
             "void splitkv_kernel<__nv_bfloat16, 8>(x)", "wgmma_kernel(x)",
             "void simt_kernel<float>(x)", "ampere_bf16_s16816gemm", "Memcpy HtoD",
             "void flash_bwd::delta_kernel(x, flash_bwd::Strides)",
             "void flash_bwd::dkdv_kernel<2>(x, flash_bwd::Strides)",
             "void flash_bwd::dq_kernel<2>(x, flash_bwd::Strides)",
             "void flash_bwd::dq_kernel<1>(x, flash_bwd::Strides)"]
    assert kernel_counts(names) == {"rmsnorm": 1, "scaled": 1, "sumsq": 1, "splitkv": 1,
                                    "wgmma": 1, "simt": 1, "bwd_delta": 1, "bwd_dkdv": 1,
                                    "bwd_dq": 2}


@pytest.mark.cuda
def test_custom_ops_launch_their_kernels(card):
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((4, 256), generator=gen, device=card, dtype=torch.bfloat16)
    w = torch.randn((256,), generator=gen, device=card, dtype=torch.bfloat16)
    before = (rmsnorm.launches, rmsnorm.sumsq_launches, rmsnorm.scaled_launches)
    rmsnorm.rms_norm_fused(x, w)
    total = rmsnorm.row_sumsq(x)
    rmsnorm.rms_norm_scaled(x, w, total, 256)
    torch.cuda.synchronize()
    assert (rmsnorm.launches - before[0], rmsnorm.sumsq_launches - before[1],
            rmsnorm.scaled_launches - before[2]) == (3, 1, 1)
    for sq, dtype, path in ((1, torch.bfloat16, "splitkv"), (64, torch.bfloat16, "wgmma"),
                            (64, torch.float32, "simt")):
        q = torch.randn((1, sq, 8, 64), generator=gen, device=card, dtype=dtype)
        k = torch.randn((1, 64, 2, 64), generator=gen, device=card, dtype=dtype)
        qpos = torch.arange(64 - sq, 64, dtype=torch.int32, device=card)[None]
        kpos = torch.arange(64, dtype=torch.int32, device=card)[None]
        assert flash.attention_route(q, k, k) == path
        n = getattr(flash, f"{path}_launches")
        flash.attention(q, k, k, qpos, kpos)
        torch.cuda.synchronize()
        assert getattr(flash, f"{path}_launches") == n + 1


@pytest.mark.cuda
def test_prediction_matches_the_real_step(card, world_of_one):
    """A smoke qwen2 mesh train step on (1, 1): the meta prediction's
    launches by kernel and FLOPs are the real step's, exactly."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    model = build_model(get_config("qwen2-1.5b", smoke=True))
    shape = ShapeConfig("train", 64, 4, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    pred = dryrun.predict_step(model, shape, mesh)["step_stats"]
    step, args, _, _ = dryrun.build_step(model, shape, mesh, device="cuda")
    names = ("launches", "splitkv_launches", "wgmma_launches", "simt_launches", "bwd_launches")
    before = {n: getattr(flash, n) for n in names}
    norm0 = rmsnorm.launches
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    got = {k: getattr(flash, f"{k}_launches") - before[f"{k}_launches"]
           for k in ("splitkv", "wgmma", "simt")}
    got["rmsnorm"] = rmsnorm.launches - norm0
    # each backward call launches its three kernels once
    got.update(dict.fromkeys(("bwd_delta", "bwd_dkdv", "bwd_dq"),
                             flash.bwd_launches - before["bwd_launches"]))
    want = pred["launches_by_kernel"]
    assert got == {k: want[k] for k in got}
    assert fc.get_total_flops() == pred["flops"]


@pytest.mark.cuda
def test_block_outs_gradients_bitwise_on_the_card(card):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for policy in ("full", "block_outs"):
        cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True, param_dtype="float32",
                                             compute_dtype="float32"), remat_policy=policy)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=card).manual_seed(0))
        out[policy] = remat_sums(model, params, smoke_batch(cfg, 2, 16, card), 2)
    for full, saved in zip(out["full"], out["block_outs"]):
        assert saved[1] == 0 and full[1] == cfg.n_layers
        assert torch.equal(full[2], saved[2])
        for k, g in full[3].items():
            assert torch.equal(g, saved[3][k]), k
