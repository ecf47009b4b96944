"""Training launcher: replication-planned data parallelism + checkpointed loop.

Port of ``repro.launch.train``.  The paper's technique is wired in as a
first-class feature: before the run, the RedundancyPlanner picks (B, r) for
the configured worker budget from the assumed step-time distribution; the
data pipeline assigns shards by the balanced non-overlapping policy; the
trainer logs the predicted E[T] / CoV frontier next to the measured step
times.  In a world of one process, one device runs the whole global batch
(the reference's single-device branch).  In an initialised
``torch.distributed`` world of N > 1 ranks (``torchrun --nproc-per-node N -m
repro_torch.launch.train ...``, which this module joins from the
environment, gloo with ``--device cpu`` and NCCL on the cards; or a process
group the caller made) it trains on a ``(N, 1)`` ("data", "model") mesh
through ``runtime.train.jit_train_step``, as the reference's ``n_dev > 1``
branch does; every rank makes the same global batch, and rank 0 alone
prints, checkpoints and writes ``train_report.json``.  Each step's time is
taken on the host clock up to the loss's copy to the host.

:func:`train` takes an ``ArchConfig`` (so a caller can cut depth or set the
dtypes) and returns the report it writes; :func:`main` builds the config
from the command line.  ``--ckpt-every 0`` (``ckpt_every=0``) turns
checkpoints off, the final one included.

Example (on the card; ``--device cpu`` runs the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 100 --global-batch 8 --seq-len 128 --workers 8 --service-dist sexp
Two ranks on the CPU:
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --smoke --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import ArchConfig, ShapeConfig
from ..core.planner import RedundancyPlanner
from ..core.service_time import Exponential, Pareto, ShiftedExponential
from ..data import PipelineConfig, SyntheticLM
from ..distributed import rdp
from ..models import build_model
from ..optim import AdamW, cosine_with_warmup
from ..runtime.train import init_state, jit_train_step, make_train_step, shard_state
from .mesh import make_mesh

DISTS = {
    "exp": Exponential(mu=1.0),
    "sexp": ShiftedExponential(delta=0.05, mu=5.0),
    "pareto": Pareto(sigma=1.0, alpha=1.5),
}
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(cfg: ArchConfig, steps: int = 100, global_batch: int = 8, seq_len: int = 128,
          microbatches: int = 1, lr: float = 3e-3, workers: int = 8,
          service_dist: str = "sexp", objective: str = "mean",
          ckpt_dir: str = DEFAULT_CKPT_DIR, ckpt_every: int = 50, resume: bool = False,
          log_every: int = 10, seed: int = 0, device=None) -> dict:
    """Plan (B, r), then train ``cfg`` for ``steps`` steps of ``global_batch`` x ``seq_len``.

    Prints the reference's ``[plan]``, ``[model]``, ``step``, ``[done]`` and
    ``[report]`` lines, writes ``train_report.json`` under
    ``ckpt_dir/<cfg.name>/`` and returns the report: the reference's fields,
    plus the device and every step's loss, grad norm and host ms (from
    ``resume``'s step on).
    """
    dev = resolve_device(device)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    lead = n_dev == 1 or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    # --- the paper's planning step -----------------------------------------
    planner = RedundancyPlanner(workers)
    plan = planner.plan(DISTS[service_dist], objective)
    say(
        f"[plan] N={plan.n_workers} -> B={plan.n_batches} shards x r={plan.replication} "
        f"replicas ({plan.source}); predicted E[T]={plan.predicted_mean:.3f} "
        f"CoV={plan.predicted_cov:.3f}",
        flush=True,
    )
    cov = rdp.surviving_coverage(plan, [True] * plan.n_workers)
    if not cov["covered"]:
        raise RuntimeError(f"the plan leaves shards uncovered: {cov}")

    model = build_model(cfg)
    pipe = SyntheticLM(
        PipelineConfig(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            n_shards=min(plan.n_batches, global_batch),
            replication=plan.replication,
            seed=seed,
        )
    )
    optimizer = AdamW(cosine_with_warmup(lr, max(steps // 20, 1), steps))
    state = init_state(model, optimizer, torch.Generator(device=dev).manual_seed(seed))
    if n_dev > 1:
        mesh = make_mesh((n_dev, 1), ("data", "model"), device_type=dev.type)
        step_fn, st_sh, _ = jit_train_step(mesh, model, optimizer,
                                           ShapeConfig("cli", seq_len, global_batch, "train"),
                                           microbatches=microbatches)
        state = shard_state(state, st_sh)
    else:
        step_fn = make_train_step(model, optimizer, microbatches=microbatches)

    out_dir = pathlib.Path(ckpt_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    mgr = CheckpointManager(out_dir, keep=3) if ckpt_every > 0 else None
    n_params = sum(p.numel() for p in state.params.leaves().values())
    say(f"[model] {cfg.name}: {n_params/1e6:.1f}M params, {cfg.n_layers} layers", flush=True)
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        say(f"[resume] from step {start}", flush=True)

    ceiling = pipe.bigram_ceiling_loss()
    times, losses, grad_norms = [], [], []
    loss = float("nan")
    for step in range(start, steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.global_batch(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # the copy to the host synchronises
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % log_every == 0 or step == steps - 1:
            say(
                f"step {step:5d} loss {loss:.4f} (ceiling {ceiling:.3f}) "
                f"grad_norm {grad_norms[-1]:.3f} "
                f"lr {float(metrics['lr']):.2e} {times[-1]*1e3:.0f}ms",
                flush=True,
            )
        if mgr is not None and step and step % ckpt_every == 0:
            mgr.save_async(step, state)
    if mgr is not None:
        mgr.wait()
        mgr.save(steps, state)
    median_ms = float(np.median(times) * 1e3) if times else float("nan")
    say(f"[done] final loss {loss:.4f}; median step {median_ms:.0f}ms", flush=True)

    # replication-plan report next to measured steps (observability hook)
    report = {
        "plan": {
            "B": plan.n_batches, "r": plan.replication,
            "objective": objective,
            "frontier_B": plan.frontier_B,
            "frontier_mean": plan.frontier_mean,
            "frontier_cov": plan.frontier_cov,
        },
        "final_loss": loss,
        "loss_ceiling": ceiling,
        "median_step_ms": median_ms,
        "params": n_params,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "losses": losses,
        "grad_norms": grad_norms,
        "step_ms": [t * 1e3 for t in times],
    }
    if n_dev > 1:
        report["world"] = n_dev
    out = out_dir / "train_report.json"
    if lead:
        out.write_text(json.dumps(report, indent=2))
    say(f"[report] {out}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--workers", type=int, default=8, help="DP worker budget N for planning")
    ap.add_argument("--service-dist", default="sexp", choices=list(DISTS))
    ap.add_argument("--objective", default="mean", choices=["mean", "cov", "blend"])
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50, help="0: no checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    joined = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        # started by torchrun: join its world (rank, size and address from the environment)
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
        joined = True
    if dist.is_initialized() and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        train(get_config(args.arch, smoke=args.smoke), steps=args.steps,
              global_batch=args.global_batch, seq_len=args.seq_len,
              microbatches=args.microbatches, lr=args.lr, workers=args.workers,
              service_dist=args.service_dist, objective=args.objective, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume, log_every=args.log_every,
              seed=args.seed, device=dev)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
