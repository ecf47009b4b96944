"""The training entry: ``runtime.train.make_train_step`` on one card, steps back to back.

Set-up builds what ``launch/train.py`` builds on a world of one: the
model, AdamW with its schedule, the training state, and the step.  The state's master weights are then written
with the benchmark's own initial weights (:mod:`perfbench.weights`), and the
step is driven through the configuration's first steps on the run's first
batches, through the same call and feed as the window: after the first, each
leaf's gradient as AdamW received it is read from its first moment; after
the last, each leaf's change.  The same state goes on into the window, which
runs steps, each on a fresh batch, until ``seconds`` have passed; a step is
timed on the host clock up to its loss's copy to the host, as the launcher
times it.  After the window and the reading of ``memory_peak_bytes`` the
state is freed and the plain reference follows the same first steps.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

from perfbench import traffic, weights, work
from perfbench.harness import HERE, Outcome, load_module
from perfbench.trace import Tracer

# the configuration's keys that set the port's ArchConfig
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
             "qkv_bias", "tie_embeddings", "rope_theta", "param_dtype", "compute_dtype", "remat",
             "remat_policy")


def build(config: dict, mix: dict, device):
    """``(model, optimizer, step_fn)`` as ``launch.train`` builds them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.runtime.train import make_train_step

    cfg = dataclasses.replace(get_config(config["arch"]), **{k: config[k] for k in ARCH_KEYS})
    o = config["optimizer"]
    s = o["schedule"]
    optimizer = AdamW(cosine_with_warmup(s["peak"], s["warmup"], s["total"], s["floor_frac"]),
                      b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                      clip_norm=o["clip_norm"], decay_min_ndim=o["decay_min_ndim"])
    model = build_model(cfg)
    step_fn = make_train_step(model, optimizer, microbatches=int(mix["microbatches"]))
    return model, optimizer, step_fn


def _alloc_retries(device) -> int:
    """The caching allocator's retries so far: each frees its cached blocks and
    waits for the card before it allocates again."""
    import torch

    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


def run(cell, seed: int, seconds: float, traced: bool, device, process_start: float) -> Outcome:
    import torch

    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.runtime.train import init_state

    config, mix = cell.config, cell.traffic
    model, optimizer, step_fn = build(config, mix, device)
    lay = weights.layout(config)
    state = init_state(model, optimizer, torch.Generator(device=device).manual_seed(0))
    leaves = state.params.leaves()
    if set(leaves) != {name for name, *_ in lay}:
        raise ValueError(f"the port's leaves differ from the layout: "
                         f"{sorted(set(leaves) ^ {name for name, *_ in lay})}")
    weights.fill(leaves, lay, seed)
    del leaves  # the initial tensors go with the first step's state
    batch_tokens = int(mix["batch"]) * int(mix["seq"])

    def batch_of(k: int) -> dict:
        return traffic.lm_batch(mix, config["vocab_size"], seed, k, device)

    # the first steps: set-up, through the window's own call and feed
    n_first = int(mix["setup_steps"])
    losses, grads = [], None
    for k in range(n_first):
        state, metrics = step_fn(state, batch_of(k))
        losses.append(float(metrics["loss"]))
        if k == 0:
            b1 = config["optimizer"]["b1"]
            grads = {n: float(m.norm()) / (1 - b1) for n, m in state.opt_state.m.items()}
    change = weights.change_norms(state.params.leaves(), lay, seed)
    program = {"loss": losses, "grad": grads, "change": change}
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # the window
    tracer = Tracer(traced, device.type)
    n_trace = int(mix["trace_steps"])
    launches0 = (rmsnorm.launches, flash_attention.launches)
    retries0 = _alloc_retries(device)
    setup_s = time.time() - process_start
    step_s = []
    tracer.start()
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        t = t1
        with tracer.unit():
            state, metrics = step_fn(state, batch_of(n_first + len(step_s)))
            loss = float(metrics["loss"])
        t1 = time.perf_counter()
        step_s.append(t1 - t)
        if len(step_s) == n_trace:
            tracer.stop()
    window_s, steps = t1 - t0, len(step_s)
    tracer.stop()
    if not math.isfinite(loss):
        raise FloatingPointError(f"the window's last step has loss {loss}")
    counts = {"rmsnorm_launches": rmsnorm.launches - launches0[0],
              "attention_launches": flash_attention.launches - launches0[1]}
    peak, memory = 0, {}
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        memory = {"reserved_peak_bytes": torch.cuda.max_memory_reserved(device),
                  "window_alloc_retries": _alloc_retries(device) - retries0}
    trace = tracer.result()
    del state, metrics, model, optimizer, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = load_module(HERE / "reference" / "train.py", "perfbench_reference_train")
    want = reference.follow(config, mix, seed, n_first, device)
    compared = reference.compare(program, want)
    print(f"perfbench: set-up {setup_s:.1f} s, {steps} steps in {window_s:.1f} s, the reference's "
          f"{n_first} steps {time.perf_counter() - t_ref:.1f} s", file=sys.stderr, flush=True)

    facts = {"units": trace.units if trace else 0, "arch": config, "batch": int(mix["batch"]),
             "seq": int(mix["seq"]),
             "flops_per_step": work.train_flops(config, int(mix["batch"]), int(mix["seq"]))}
    return Outcome(
        attempted=steps, failed=0,
        e2e={"train_tokens_per_s": steps * batch_tokens / window_s, "setup_s": setup_s},
        compared=compared, memory_peak_bytes=peak, trace=trace, facts=facts,
        extra={"counters": {"steps": steps, "window_s": window_s, "step_s": step_s,
                            "tokens_per_step": batch_tokens,
                            "first_losses": losses, **memory,
                            **{k: v / max(steps, 1) for k, v in counts.items()}}},
    )
