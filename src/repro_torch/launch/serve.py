"""Serving launcher: prefill + greedy decode, then replication planning.

Port of ``repro.launch.serve``.  The paper maps to serving as *request
replication*: a batch of independent requests (the "tasks") can be
replicated across worker groups, and the batch completes when every request
is served by its fastest replica (T = max_B min_r).  The launcher serves
``--requests`` requests on the card (one at a time, batch 1: a prefill of
``--prompt-len`` tokens, then ``--gen`` greedy decode steps against the KV
cache), takes each request's service time on the host clock up to the last
token's copy to the host, and plans replication for the measured times with
``RedundancyPlanner.plan_empirical`` and ``simulate_balanced`` (the latter on
the card's cover kernel).

Weights are seeded random (``--seed``), made by the port's ``init_params``
in the param dtype; serving keeps one compute-dtype copy of them.

Example (on the card; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --requests 4 --prompt-len 1024 --gen 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config
from ..core import simulator
from ..core.planner import RedundancyPlanner
from ..core.service_time import Empirical
from ..models import build_model
from ..runtime.serve import make_prefill_step, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encoder":
        raise SystemExit(f"{args.arch} is encoder-only: no autoregressive serving")
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device=dev).manual_seed(args.seed)))
    max_len = args.prompt_len + args.gen

    prefill = make_prefill_step(model, max_len)
    step = make_serve_step(model)

    rng = np.random.default_rng(args.seed)
    service_times = []
    with torch.inference_mode():
        for r in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, size=(1, args.prompt_len))
            tokens = torch.as_tensor(prompt, dtype=torch.int32).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache, t = prefill(params, {"tokens": tokens})
            tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None].int()
            _sync(dev)
            t_prefill = time.perf_counter() - t0
            out = []
            for _ in range(args.gen):
                logits, cache, t = step(params, cache, tok, t)
                tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None].int()
                out.append(int(tok[0, 0]))  # the copy to the host synchronises
            dt = time.perf_counter() - t0
            service_times.append(dt)
            per_tok = (dt - t_prefill) / max(args.gen, 1)
            print(f"request {r}: {dt * 1e3:.3f}ms (prefill {t_prefill * 1e3:.3f}ms, "
                  f"decode {per_tok * 1e3:.3f}ms/token), generated {out[:8]}...", flush=True)

    # paper: plan replication for these measured service times
    times = np.asarray(service_times)
    planner = RedundancyPlanner(args.workers)
    plan = planner.plan_empirical(times, "mean", n_mc=5000)
    dist = Empirical(tuple(times))

    def mean_T(seed: int, n_batches: int) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        samples = simulator.simulate_balanced(
            gen, dist, args.workers, n_batches, 20000, device=dev
        )
        return simulator.stats_from_samples(samples).mean

    base, best = mean_T(1, args.workers), mean_T(2, plan.n_batches)
    print(
        f"[plan] measured mean {times.mean()*1e3:.3f}ms/req; for N={args.workers} "
        f"workers the planner picks B={plan.n_batches} (r={plan.replication}): "
        f"E[T] {base*1e3:.3f}ms (no redundancy) -> {best*1e3:.3f}ms",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
