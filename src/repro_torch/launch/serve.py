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
:func:`serve` takes an ``ArchConfig`` (so a caller can cut depth or set the
param dtype); :func:`main` builds one from the command line.

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
from ..configs.base import ArchConfig
from ..core import simulator
from ..core.planner import RedundancyPlanner
from ..core.service_time import Empirical
from ..models import build_model
from ..runtime.serve import make_prefill_step, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, requests: int = 8, prompt_len: int = 32, gen: int = 16,
          workers: int = 8, seed: int = 0, device=None) -> list:
    """Serve ``requests`` requests of the model ``cfg`` and plan replication for them.

    Prints one line per request and the planner's line, as :func:`main`, and
    returns each request's ``(total, prefill, decode per token)`` in seconds.
    A ``vlm`` request goes in as embeddings with M-RoPE positions (``arange``
    in each of the 3 sections), made inside its timed window; an encoder has
    no autoregressive serving and is refused.
    """
    dev = resolve_device(device)
    if cfg.family == "encoder":
        raise SystemExit(f"{cfg.name} is encoder-only: no autoregressive serving")
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device=dev).manual_seed(seed)))
    max_len = prompt_len + gen

    prefill = make_prefill_step(model, max_len)
    step = make_serve_step(model)

    rng = np.random.default_rng(seed)
    records = []
    with torch.inference_mode():
        for r in range(requests):
            prompt = rng.integers(0, cfg.vocab_size, size=(1, prompt_len))
            tokens = torch.as_tensor(prompt, dtype=torch.int32).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            if cfg.family == "vlm":
                pos = torch.arange(prompt_len, dtype=torch.int32, device=dev)
                pos = pos[None, :, None].expand(1, prompt_len, 3).contiguous()
                embeds = params["embed"][tokens.long()].to(cfg.dtype("compute"))
                logits, cache, t = prefill(params, {"embeds": embeds, "mrope_positions": pos})
            else:
                logits, cache, t = prefill(params, {"tokens": tokens})
            tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None].int()
            _sync(dev)
            t_prefill = time.perf_counter() - t0
            out = []
            for _ in range(gen):
                logits, cache, t = step(params, cache, tok, t)
                tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None].int()
                out.append(int(tok[0, 0]))  # the copy to the host synchronises
            dt = time.perf_counter() - t0
            per_tok = (dt - t_prefill) / max(gen, 1)
            records.append((dt, t_prefill, per_tok))
            print(f"request {r}: {dt * 1e3:.3f}ms (prefill {t_prefill * 1e3:.3f}ms, "
                  f"decode {per_tok * 1e3:.3f}ms/token), generated {out[:8]}...", flush=True)

    # paper: plan replication for these measured service times
    times = np.asarray([rec[0] for rec in records])
    planner = RedundancyPlanner(workers)
    plan = planner.plan_empirical(times, "mean", n_mc=5000)
    dist = Empirical(tuple(times))

    def mean_T(seed: int, n_batches: int) -> float:
        generator = torch.Generator(device=dev).manual_seed(seed)
        samples = simulator.simulate_balanced(generator, dist, workers, n_batches, 20000,
                                              device=dev)
        return simulator.stats_from_samples(samples).mean

    base, best = mean_T(1, workers), mean_T(2, plan.n_batches)
    print(
        f"[plan] measured mean {times.mean()*1e3:.3f}ms/req; for N={workers} "
        f"workers the planner picks B={plan.n_batches} (r={plan.replication}): "
        f"E[T] {base*1e3:.3f}ms (no redundancy) -> {best*1e3:.3f}ms",
        flush=True,
    )
    return records


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
    serve(get_config(args.arch, smoke=args.smoke), requests=args.requests,
          prompt_len=args.prompt_len, gen=args.gen, workers=args.workers, seed=args.seed,
          device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
