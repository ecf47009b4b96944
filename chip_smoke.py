#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
``repro_torch`` from ``src/`` (never jax, never ``repro``) and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the paths from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and prints each kernel's
   registers and spills;
3. holds cover kernel A (draws in) bitwise equal to its plain PyTorch version
   on the card, in float32 and float64, at the shapes of
   ``tests/test_torch_cover.py``, at edge geometries (r = 1, r = n_slots,
   rows off 16-byte boundaries, masked ``ld > r``, batches wider than its
   shared-memory buffer) and at the frontier shapes (N = 100: 9 x 32768 x 100;
   N = 720: 30 x 32768 x 720) and ``simulate_fifo``'s (64 * 32768, 10, 10)
   grid, unmasked and masked to 5 x 5; times the largest frontier beside the
   kernel's memory bound;
3b. holds cover kernel B (Philox sample-and-cover) to its plain version: the
   uniforms bitwise, the cover times of Exp, SExp, Pareto(1.5) and job6 at
   N = 100 and N = 720 in float32 and float64 over reps [0, 2048) and
   [32768 - 2048, 32768) (through ``rep0``), bitwise for job6 and within a
   relative 2e-6 / 1e-14 for the others; counts the instructions of its
   loop in the compiled SASS (``cuobjdump``) for its operations bound, and
   times it per law at (30, 32768, 720) float32 beside that bound, its plain
   version and the unfused pass it replaces (``dist.sample`` + kernel A);
4. holds the RMSNorm and flash-attention kernels to their plain versions
   within ``tests/test_kernels.py``'s ``TOL`` (float32 2e-5, bfloat16 3e-2)
   and within ``ROW_RTOL`` of |want| plus the RMS of the output row (bfloat16
   2**-6, float32 2e-5), which a result with 64 keys dropped fails (checked
   in every attention case), at the serving path's shapes -- RMSNorm (1024,
   1536) and (1, 1536), plain and ``plus_one``; attention prefill (1, 1024,
   12, 128) over 2 KV heads, causal, against the served 1056-slot cache
   whose last 32 slots are -1, and against 1024 keys at arange positions
   (also through the Pallas-signature entry); decode Sq = 1 against a
   1056-slot cache holding -1 slots; a gemma-shaped head_dim 256 case and a
   sliding-window case; and each served zoo family's attention as its
   served path calls it (prefill over 1024 keys, the last decode step
   against the 1040-slot ring): qwen3-moe 64 / 4 heads of 128 (16 query
   rows a KV head on split-KV), qwen2-vl 28 / 4, recurrentgemma 10 / 1 at
   head_dim 256 with window 2048, hubert-xlarge 16 / 16 at head_dim 80,
   non-causal -- checks which of the three attention kernels each case
   launched (split-KV for decode, wgmma for a bf16 prefill, the CUDA-core
   kernel for a float32 prefill), and times the served prefill (1024 keys
   at arange positions: a prefill attends over the prompt's own k/v),
   decode and hubert's prefill of each kernel beside its bound, its plain
   version and one PyTorch library call (``torch.nn.functional.rms_norm``,
   ``scaled_dot_product_attention``, which the port never calls), warm and
   with the L2 cache flushed before each call, the decode kernel at three
   split counts, and each other zoo case's kernel beside its bound;
4b. holds RMSNorm to its plain version (``TOL`` and ``ROW_RTOL``) at every
   width the zoo serves, d in (5120, 4096, 3584, 2560) over 1024 rows and
   one, bf16 and float32, plain and ``plus_one``, and times it at mamba2's
   d_inner 5120 (the kernel's scalar path) beside its bound, its plain
   version and ``F.rms_norm``;
5. runs the planning path, ``plan_sweep`` over Exp, SExp, Pareto(1.5) and the
   §VII heavy-tail trace job ``job6`` across budgets N in {100, 720} with
   32768 reps, with the launch counters set to 0 just before and read just
   after (one kernel-B launch per grid point, none of kernel A); checks the
   Exp and SExp frontier means against the closed form ``analysis.mean_T``;
   prints each grid point's B* and wall time, a frontier pass's host time,
   the selection's host time, its peak device memory and the card's idle
   share over one ``plan_cluster`` (``torch.profiler``); checks
   ``frontier_job_times`` with ``rep_chunk=4096`` bitwise equal to one launch;
5b. runs churned planning on the epoch scan's gang lane, the reference
   benchmark's dynamic scenario (``benchmarks/cluster_bench.py``
   ``bench_dynamic``: ``ChurnProcess(0.02, 2.0)``, speeds
   ``default_rng(0).uniform(0.5, 2.0, N)``, 2 churn pairs per worker, 96-job
   streams) at N = 100 with 4096 reps (9 candidates x 43 streams = 387
   lanes), for Exp(1) and Pareto(1, 1.8): ``plan_cluster`` in float32 with
   the frontier rows bitwise equal to the same call on the CPU and the same
   B*; the rows of ``tests/golden/epoch_scan_frontier.json`` (the JAX
   package's output, float64) bitwise; ``simulate_epochs`` at N = 100, B = 50,
   96 Poisson arrivals (mean gap 3 s), 64 reps, cancelling, size-independent
   task times, the churn horizon auto-sized, float64, bitwise equal to the
   CPU except the two worker-second sums (rtol 1e-12); ``rep_chunk`` 1024
   and 16 bitwise equal to one call; and prints the wall time per
   ``plan_cluster``, the steps run, the kernel launches per step, the host
   ms per step, the peak device memory and the card's idle share over one
   call (``torch.profiler``).  No kernel runs on this path (the counters of
   both cover kernels stay at 0);
5c. runs the epoch scan's adaptive policies and its streaming fold (no
   kernel) on the churned-planning scenario with its 2 churn pairs per
   worker: the in-scan replanner (``ReplanConfig(512, 128, 96)``, as
   ``examples/elastic_failover.py`` sets it) in ``simulate_epochs`` from
   B = N = 100 over the 96 Poisson arrivals, 64 reps, cancelling, float64
   (decisions and times equal to the CPU run, a replan in every rep) and in
   ``plan_cluster`` at 4096 reps, float32 (the CPU's B*); speculation as
   ``examples/speculative_backup.py`` runs it (N = 10, Pareto(1, 1.5),
   ``Speculation(0.4, 2.0, 3)``, 40 jobs at t = 0, 200 reps, cancelling,
   B = N and the closed form's B*, float64) bitwise against the CPU but the
   two sums, with backups launched and a lower mean compute time than B = N
   without them; ``outputs="stream"`` on the churned case without the
   replanner, its stats bitwise equal to ``epoch_stream_stats`` of the
   card's full report and to the CPU's stream; ``plan_slo`` on the churned
   cluster (``RedundancyPlanner(100)``, Pareto(1, 1.8), p99 <= 4 s at 0.3
   jobs/s, ``fifo_gang``, 200 jobs, 8 reps, float64) equal to the CPU's
   ``SLOPlan`` with some but not all of the 9 candidates feasible; and the
   JAX package's float64 runs ``tests/golden/epoch_scan_replan.json`` and
   ``epoch_scan_speculation.json``; prints for each case the wall time
   (median of 3 calls; ``plan_slo`` one call), steps, host ms per step,
   kernel launches per step, the card's idle share (``torch.profiler``) and
   peak device memory;
5d. runs space sharing and the event engine (no kernel on the space lane):
   the port's ``ClusterEngine`` on the host against the space lane on the
   card in float64 on ``tests/test_space_sharing.py``'s crafted schedule
   (six speeds, ``Empirical((1.3,))``, N = 6, 8 jobs, 2 workers a job;
   ``fifo_gang``, ``packed``, ``balanced``, cancellation off and on; and the
   heterogeneous-plan case), the whole trajectory and accounting equal;
   ``tests/golden/epoch_scan_space.json`` (the JAX package's float64 runs)
   bitwise but the two sums; space-shared planning on the churned cluster
   (the churned-planning scenario, ``RedundancyPlanner(100, candidates=(1,
   2, 4, 5, 10, 20))``, ``packed`` and ``balanced``, 20 workers a job,
   48-job streams, Pareto(1, 1.8), 4096 reps, float32) with its wall
   (median of 3), steps, launches per step, host ms per step, idle share and
   peak memory beside the CPU's wall, and the same call at 64 reps in
   float64 (frontier rows, and ``simulate_epochs``) bitwise equal to the CPU
   but the two sums; ``bench_space_sharing``'s scheduling effect
   (``simulate_fifo``, Pareto(1, 1.8), N = 16, B = 2, 24 jobs at t = 0, 256
   reps, ``packed`` with 5 workers a job in float64, bitwise equal to the
   CPU, against ``fifo_gang``: the mean-response ratio below 1) and its two
   backends (N = 16, ``feasible_B(5)``, 2048 reps, 48-job streams,
   ``packed``, Exp(1) and Pareto(1, 1.8): ``backend="python"``, the port's
   engine on the host, against ``backend="torch"`` warm, best of 3; equal
   B for Exp(1));
6. runs ``simulate_fifo`` on the card the same way and checks its accounting
   invariant;
7. runs the paper's batching schemes at full width: ``simulate_membership``
   at N = 720, B = 24 (s = r = 30) for ``non_overlapping``, ``hybrid`` and
   ``cyclic`` with 32768 Exp(1) samples (kernel A, one launch per chunk of
   samples); checks the non-overlapping mean within 3 sigma of
   ``analysis.mean_T``, the membership cover on the card bitwise equal to
   the CPU on the same draws, and the Fig. 6 lead of non-overlapping at
   (6, 3) and (12, 4) with 150k samples (hybrid deals the cyclic batches, so
   the two agree in law); prints the ordering at N = 720;
8. runs the trace-scale stream: the reference's golden cluster-day
   (10,000 jobs, 13,824 workers in 2,304 packed pools of 6, B = 3, 2 reps,
   slab 1024, float32; one kernel-A launch per slab) against
   ``tests/golden/trace_day_summary.json`` (``n_jobs_done`` exactly, the
   rest within rtol 1e-5), with its wall time, host ms per job step, peak
   device memory and the card's idle share over one slab; ``collect=True``
   against ``fold_stream_stats``; a float64 stream of 2,000 jobs and 4 reps
   in all four scheduler cases, bitwise against the same call on the CPU;
   kernel A bitwise against its plain version at each slab grid;
9. runs ``RedundancyPlanner(100).plan_slo`` over the §VII trace jobs job1
   and job6 as two classes with a p99 target each, all three schedulers,
   pool widths (10, 20, 50) (41 candidates), 2000 jobs, 16 reps, float64,
   and checks its ``SLOPlan`` equal to the same call on the CPU;
10. runs the serving path, ``repro_torch.launch.serve.main`` at the full
   width and depth of qwen2-1.5b (4 requests, prompt 1024, gen 32, batch 1,
   seeded weights), with the counters set to 0 just before and read just
   after: 57 RMSNorm and 28 attention launches per forward, (1 + gen)
   forwards per request, 2 kernel-A cover launches for the planner
   (``simulate_balanced``), every decode
   attention on the split-KV kernel and every prefill attention on the wgmma
   kernel; prints each
   request's ms with its prefill / decode split, the peak device memory and
   the planner's line;
11. profiles one decode step of the served model for the card's idle share
   and its device time and launches by kernel;
12. checks the KV cache at full width: in float32 compute with TF32 off,
   prefill 8 tokens and decode 4, each step's logits against the
   teacher-forced ``forward`` within 2e-3;
13. serves the rest of the zoo through ``launch.serve.serve`` at full
   published width, bf16 weights, 2 requests, prompt 1024, 16 tokens, batch
   1: qwen3-moe-235b-a22b cut to 6 of 94 layers, qwen2-vl-7b (embeddings
   and M-RoPE ids), recurrentgemma-2b and mamba2-2.7b whole; the counters
   set to 0 just before each and read just after (per forward: 13 / 57 / 53
   / 129 RMSNorm and 6 / 28 / 8 / 0 attention launches, decode on split-KV,
   prefill on wgmma, 2 kernel-A launches for the planner); runs
   hubert-xlarge's 48-layer forward over 1024 frame embeddings (48 wgmma
   launches); prints each request's prefill ms and decode ms per token, the
   peak device memory and the card's name and power limit beside them;
   then profiles one decode step of each after a 1024-token prefill (the
   card's busy time, idle share and top kernels);
14. checks each of those families at full width in float32 (TF32 off) at a
   cut depth (2 layers; recurrentgemma one (R, R, A) group and its (R, R)
   tail; MoE with a capacity that drops nothing): prefill 8 tokens and
   decode 4 against the teacher-forced ``forward`` within 2e-3, and
   hubert's forward against the same forward through the plain attention;
   then the MoE smoke models on the card against the CPU (equal top-k
   expert ids, logits within 1e-4);
15. prints the kernels line, then, last, the one-line JSON result.

Any failed phase exits non-zero and prints no result; so does a run without
a CUDA device or without the repo's sources beside the script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores, and
# the dense bf16 tensor-core rate
CARD_BYTES_PER_S = 3.35e12
CARD_F32_FLOP_PER_S = 67e12
CARD_BF16_FLOP_PER_S = 989e12
# instructions the card can issue per second: one warp instruction per clock
# from each of an SM's 4 schedulers, 32 lanes, 132 SMs, 1980 MHz boost clock
# (half the float32 rate, which counts an FMA as two operations)
CARD_ISSUE_PER_S = 4 * 32 * 132 * 1.98e9

N_REPS = 32768
BUDGETS = (100, 720)
SEED = 1
# churned planning: the reference benchmark's dynamic scenario at the
# planning budget (benchmarks/cluster_bench.py bench_dynamic)
CHURN_N, CHURN_REPS, CHURN_PAIRS, CHURN_STREAM = 100, 4096, 2, 96
CHURN_FAIL_RATE, CHURN_DOWNTIME = 0.02, 2.0
# simulate_epochs on the card: B, Poisson arrivals at a mean gap, reps (the
# churn horizon auto-sized from the stream, the entry point's default)
EPOCH_B, EPOCH_JOBS, EPOCH_GAP, EPOCH_REPS = 50, 48, 3.0, 64
GOLDEN_EPOCH = ROOT / "tests" / "golden" / "epoch_scan_frontier.json"
# the dynamic policies on the churned-planning scenario: the in-scan
# replanner with examples/elastic_failover.py's ReplanConfig, from B = N;
# the replanner, the fold and plan_slo sample one fail/join pair a worker,
# which keeps the script in its time budget: a lane's steps follow its
# churn events
REPLAN_WINDOW, REPLAN_EVERY, REPLAN_MIN = 512, 128, 96
DYN_PAIRS = 1
# speculation as examples/speculative_backup.py runs it: N workers, jobs at
# t = 0 (half the example's 40, for the script's time), reps, the
# Speculation knobs, Pareto(1, SPEC_ALPHA), cancelling
SPEC_N, SPEC_JOBS, SPEC_REPS, SPEC_ALPHA = 10, 20, 200, 1.5
SPEC_INTERVAL, SPEC_THETA, SPEC_MIN_OBS = 0.4, 2.0, 3
# plan_slo on the churned cluster: one Pareto(1, 1.8) class, a p99 target at
# a Poisson rate that some but not all of the 9 candidates meet
SLO_DYN_JOBS, SLO_DYN_REPS, SLO_DYN_RATE, SLO_DYN_TARGET = 200, 8, 0.3, 4.0
GOLDEN_POLICIES = [ROOT / "tests" / "golden" / f"epoch_scan_{name}.json"
                   for name in ("replan", "speculation")]
# space sharing: benchmarks/cluster_bench.py bench_space_sharing at its own
# shape (N workers, workers a job, jobs at t = 0, reps of the response ratio,
# reps and stream length of the two backends' frontier), then space-shared
# planning on the churned cluster (workers a job, candidates)
SPACE_N, SPACE_WPJ, SPACE_JOBS, SPACE_RATIO_REPS = 16, 5, 24, 256
SPACE_REPS, SPACE_STREAM = 2048, 48
SPACE_PLAN_WPJ, SPACE_PLAN_CANDS, SPACE_CHECK_REPS = 20, (1, 2, 4, 5, 10, 20), 64
GOLDEN_SPACE = ROOT / "tests" / "golden" / "epoch_scan_space.json"
# the live runtime: benchmarks/runtime_bench.py's full configuration
# (_cfg(False)): thread workers, B batches, jobs of tasks at a nominal cost
# each, a per-worker skew (1 + wid * skew), the torch payload on the card;
# 6 jobs, not 8, keep the phase near its minute
LIVE_N, LIVE_B, LIVE_TASKS, LIVE_JOBS, LIVE_COST, LIVE_SKEW = 8, 4, 16, 6, 0.25, 0.5
# the subprocess kill: two workers on the card, B = 2; batch 1 is the victim's
LIVE_PROC_COSTS = (0.5, 2.0)
GOLDEN_RUNTIME = ROOT / "tests" / "golden" / "runtime_traces.json"
# simulate_fifo's workload: N workers in B batches (r = N / B), FIFO_JOBS jobs
FIFO_N, FIFO_B, FIFO_JOBS = 100, 10, 64
# the paper's batching schemes at full width: N workers = tasks, B batches
SCHEME_N, SCHEME_B, SCHEME_SAMPLES, ORDER_SAMPLES = 720, 24, 32768, 150_000
# the reference's §VII golden cluster-day (tests/test_stream.py DAY_CFG / DAY_RUN)
DAY_JOBS, DAY_SECONDS, DAY_SEED = 10_000, 86_400.0, 7
DAY_WORKERS, DAY_POOL, DAY_B, DAY_REPS, DAY_SLAB = 13_824, 6, 3, 2, 1024
GOLDEN_DAY = ROOT / "tests" / "golden" / "trace_day_summary.json"
# plan_slo: two §VII trace classes, one arrival rate, a p99 target per class
SLO_N, SLO_JOBS, SLO_REPS, SLO_WIDTHS = 100, 2000, 16, (10, 20, 50)
SLO_RATE, SLO_TARGETS = 0.02, {"job1": 25.0, "job6": 120.0}
# the serving cell: qwen2-1.5b at full width and depth, batch 1
SERVE_ARCH = "qwen2-1.5b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN, SERVE_WORKERS = 4, 1024, 32, 8
# the model zoo: every other serving family at its published width, batch 1;
# qwen3-moe cut to 6 of its 94 layers (bf16 weights, 4.98 GB a layer), the rest whole
ZOO_SERVED = (("qwen3-moe-235b-a22b", 6), ("qwen2-vl-7b", None), ("recurrentgemma-2b", None),
              ("mamba2-2.7b", None))
ZOO_ENCODER = "hubert-xlarge"
ZOO_REQUESTS, ZOO_GEN = 2, 16
ZOO_D_INNER = 5120  # mamba2-2.7b's gated RMSNorm width
# every RMSNorm width the zoo serves: mamba2's d_inner, then the d_model of
# qwen3-moe, qwen2-vl, and recurrentgemma (plus_one) and mamba2
ZOO_NORM_WIDTHS = (ZOO_D_INNER, 4096, 3584, 2560)
# the float32 check's depth: 2 layers; recurrentgemma one (R, R, A) group and its (R, R) tail
ZOO_F32_DEPTH = {"qwen3-moe-235b-a22b": 2, "qwen2-vl-7b": 2, "recurrentgemma-2b": 5,
                 "mamba2-2.7b": 2, "hubert-xlarge": 2}
# tests/test_kernels.py's TOL (atol = rtol) by dtype name
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# attention and RMSNorm are also held element by element to a bound scaled by
# |want| plus the RMS of its output row (over the last axis): attention outputs
# averaged over 1024 keys are about 0.05, where TOL's 1 + |want| would pass a
# kernel that drops a 64-key tile; the attention phase checks that this bound
# fails such a result.  bf16: 4 units in the last place of bf16's 8-bit significand
ROW_RTOL = {"float32": 2e-5, "bfloat16": 2.0**-6}
# kernel B against its plain version, relative, for the laws with a log1p or a
# pow (libdevice's and torch's may differ by a few ulp; the min/max carries
# the chosen draw's error through unchanged); an empirical law is bitwise
PHILOX_RTOL = {"float32": 2e-6, "float64": 1e-14}
PHILOX_CHECK_REPS = 2048  # reps per checked range: the plain version holds its draws


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


T0 = time.perf_counter()
CARD = "not read"  # nvidia-smi's "name, power.limit", set by phase_card


def phase(name: str):
    print(f"\n== {name}  [{time.perf_counter() - T0:.1f} s into the script]", flush=True)


# --------------------------------------------------------------------------
# comparisons and timing
# --------------------------------------------------------------------------


def bitwise_equal(got, want) -> tuple[bool, float]:
    """Bit-for-bit equality (NaN matched by position) and the max |difference|."""
    import torch

    nan = torch.isnan(want)
    same_nan = bool(torch.equal(torch.isnan(got), nan))
    bits = torch.int32 if want.dtype == torch.float32 else torch.int64
    same_bits = bool(torch.equal(got[~nan].view(bits), want[~nan].view(bits)))
    finite = torch.isfinite(got) & torch.isfinite(want)
    err = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
    return same_nan and same_bits, err


def cover_bound_ms(n_cand: int, n_reps: int, n_slots: int, itemsize: int) -> tuple[float, str]:
    """Least time for one frontier pass: read x once, write out once, ~2 flops per element."""
    moved = (n_cand * n_reps * n_slots + n_cand * n_reps + n_cand) * itemsize + n_cand * 12
    by_bytes = moved / CARD_BYTES_PER_S * 1e3
    by_ops = 2.0 * n_cand * n_reps * n_slots / CARD_F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def close_to(got, want, dtype_name: str) -> tuple[bool, float]:
    """``|got - want| <= TOL * (1 + |want|)`` everywhere, and the max |difference|."""
    import torch

    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= tol + tol * w.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def close_by_row(got, want, dtype_name: str) -> tuple[bool, float]:
    """``|got - want| <= ROW_RTOL * (|want| + rms(want's row))`` everywhere,
    and the largest ``|got - want| / (|want| + rms(want's row))``."""
    import torch

    g, w = got.float(), want.float()
    scale = w.abs() + w.square().mean(-1, keepdim=True).sqrt()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= ROW_RTOL[dtype_name] * scale).all())
    return ok, float((err / scale.clamp_min(1e-30)).max())


def profile_device(fn, host: dict | None = None, counts: dict | None = None,
                   cpu: bool = True) -> tuple[float, dict]:
    """Host-clock ms of ``fn()`` up to a synchronise, and the microseconds the
    card spent in each kernel or copy meanwhile, by name, from a
    ``torch.profiler`` trace (empty when the trace shows no device activity).
    With ``host`` given, also sums each host-side operator's own (self) CPU
    microseconds into it, by name; with ``counts``, counts each kernel's
    launches into it, by name.  ``cpu=False`` traces the card only and reads
    the profiler's raw events back (no operator tree): a trace of a few
    hundred thousand launches then takes seconds, not minutes, to read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    if cpu:
        events = [(e.name, e.time_range.elapsed_us(), e.device_type == cuda, e)
                  for e in prof.events()]
    else:
        events = [(e.name(), e.duration_ns() / 1e3, e.device_type() == cuda, None)
                  for e in prof.profiler.kineto_results.events()]
    by_name: dict = {}
    for name, us, on_card, e in events:
        if on_card:
            by_name[name] = by_name.get(name, 0.0) + us
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1
        elif host is not None:
            host[name] = host.get(name, 0.0) + e.self_cpu_time_total
    return wall_ms, by_name


def device_ms_per_call(fn, iters: int = 20) -> float:
    """The card's busy time per call of ``fn`` (kernels and copies, from a
    ``torch.profiler`` trace of ``iters`` calls after a warm-up): the
    kernel's own time, free of the host's launch overhead that CUDA events
    around back-to-back calls also see when each call is short.  A trace
    that shows no device time is taken again, and after three the phase fails."""
    fn()
    for _ in range(3):
        _, by_name = profile_device(lambda: [fn() for _ in range(iters)])
        busy_us = sum(by_name.values())
        if busy_us > 0:
            return busy_us / 1e3 / iters
    check(False, f"three profiler traces of {iters} calls showed no device time")


def kernel_ms_cold(fn, name_part: str, iters: int = 20) -> float:
    """Device ms per launch of the kernels whose name holds ``name_part``,
    with the 50 MB L2 cache flushed (a 256 MB buffer zeroed) before each
    call of ``fn``, as a layer of a served step finds it after the weights
    of the layers before it have streamed through."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name_part in e.name]
    return sum(us) / 1e3 / iters if us else float("nan")


def device_busy_ms(fn) -> tuple[float, float]:
    """Host-clock ms of ``fn()`` up to a synchronise, and the ms the card spent
    in kernels and copies meanwhile (0 when the trace shows no device activity)."""
    wall_ms, by_name = profile_device(fn)
    return wall_ms, sum(by_name.values()) / 1e3


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the peak rate."""
    by_bytes = n_bytes / CARD_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_card() -> None:
    phase("card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    global CARD
    CARD = out.stdout.strip().splitlines()[0]
    print(CARD, flush=True)


def phase_build() -> None:
    from repro_torch.kernels import _build

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        print(f"[{name}] {_build.library_path(name)}")
        for line in logs[name].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "rror")):
                print("   ", line.strip())
    print(f"built {len(logs)} sources in {time.perf_counter() - t0:.3f} s", flush=True)


def _masked_case(torch, dtype, dev):
    import numpy as np

    x = np.random.default_rng(3).exponential(size=(37, 6, 4))
    x[3, 0, 0] = x[5, 5, 3] = np.nan
    x[7, 1, 1] = np.inf
    x[9, :, 0] = np.inf
    x[13, 4, 2] = -np.inf
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _frontier_case(torch, n_workers, candidates, n_reps, dtype, dev, gen):
    import numpy as np

    bs = np.asarray(candidates, dtype=np.int64)
    rs = n_workers // bs
    n_slots = int((bs * rs).max())
    x = torch.empty((len(bs), n_reps, n_slots), dtype=dtype, device=dev)
    x.exponential_(generator=gen)
    scales = torch.as_tensor(n_workers / bs, dtype=dtype, device=dev)
    return x, bs, rs, scales


def phase_kernel_vs_plain() -> dict:
    import torch

    from repro_torch._device import time_on_card
    from repro_torch.core import analysis
    from repro_torch.kernels import cover

    phase("kernel vs plain version (bitwise, on the card)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    record = None
    for dtype in (torch.float32, torch.float64):
        x = _masked_case(torch, dtype, dev)
        for b, r in [(6, 4), (3, 2), (2, 4), (6, 1), (1, 1), (1, 4)]:
            same, err = bitwise_equal(
                cover.masked_cover_times(x, b, r), cover.masked_cover_times_ref(x, b, r)
            )
            max_err = max(max_err, err)
            check(same, f"masked_cover_times {dtype} (b={b}, r={r}) differs from plain")
        small = [(12, [1, 2, 3, 4, 6, 12]), (10, [1, 3, 4, 10]), (7, [7]), (5, [1])]
        for n, cands in small:
            xs, bs, rs, scales = _frontier_case(torch, n, cands, 41, dtype, dev, gen)
            xs[0, 2, 0] = float("nan")
            xs[-1, 6, -1] = float("inf")
            same, err = bitwise_equal(
                cover.frontier_cover(xs, bs, rs, scales),
                cover.frontier_cover_ref(xs, bs, rs, scales),
            )
            max_err = max(max_err, err)
            check(same, f"frontier_cover {dtype} N={n} {cands} differs from plain")
        print(f"{dtype}: test shapes bitwise equal")

        # edge geometries: r = 1 and r = n_slots, rows off 16-byte boundaries,
        # batches wider than the kernel's shared-memory buffer, r past a warp
        edges = [([720, 1, 24, 5], [1, 720, 30, 144], 720), ([41, 1, 3], [1, 41, 13], 41),
                 ([1, 2], [1500, 700], 1500), ([3, 7], [33, 9], 100)]
        for bs, rs, n_slots in edges:
            xe = torch.rand((len(bs), 77, n_slots), generator=gen, device=dev, dtype=dtype)
            xe[0, 3, 0] = float("nan")
            xe[1, 9, :] = float("inf")
            sc = torch.as_tensor([2.0 + c for c in range(len(bs))], dtype=dtype, device=dev)
            same, err = bitwise_equal(cover.frontier_cover(xe, bs, rs, sc),
                                      cover.frontier_cover_ref(xe, bs, rs, sc))
            max_err = max(max_err, err)
            check(same, f"frontier_cover {dtype} edge {bs} x {rs} differs from plain")
        flat = torch.rand((1 + 200 * 35,), generator=gen, device=dev, dtype=dtype)
        xo = flat[1:].view(200, 5, 7)  # one element past the allocation's start
        xo[4, 0, 0] = float("nan")
        wide = torch.rand((40, 3, 1100), generator=gen, device=dev, dtype=dtype)
        for grid_, b, r in [(xo, 5, 7), (xo, 4, 3), (xo, 2, 1), (wide, 3, 1100), (wide, 3, 37)]:
            same, err = bitwise_equal(cover.masked_cover_times(grid_, b, r),
                                      cover.masked_cover_times_ref(grid_, b, r))
            max_err = max(max_err, err)
            check(same, f"masked_cover_times {dtype} {tuple(grid_.shape)} (b={b}, r={r}) "
                        "differs from plain")
        print(f"{dtype}: edge geometries bitwise equal")

        # every shape the main path gives the kernel: the frontier at each budget
        for n in BUDGETS:
            cands = analysis.feasible_B(n)
            xs, bs, rs, scales = _frontier_case(torch, n, cands, N_REPS, dtype, dev, gen)
            xs[1, 7, 0] = float("nan")
            xs[-1, 11, 0] = float("inf")
            same, err = bitwise_equal(
                cover.frontier_cover(xs, bs, rs, scales),
                cover.frontier_cover_ref(xs, bs, rs, scales),
            )
            max_err = max(max_err, err)
            check(same, f"frontier_cover {dtype} at the N={n} frontier {tuple(xs.shape)} "
                        "differs from plain")
            gbytes = xs.numel() * xs.element_size() / 1e9
            if n != max(BUDGETS):
                print(f"{dtype}: N={n} frontier {tuple(xs.shape)} ({gbytes:.3f} GB) bitwise equal")
                continue
            ms = time_on_card(lambda: cover.frontier_cover(xs, bs, rs, scales), iters=20)
            plain_ms = time_on_card(lambda: cover.frontier_cover_ref(xs, bs, rs, scales), iters=5)
            bound_ms, bound_by = cover_bound_ms(*xs.shape, xs.element_size())
            print(
                f"{dtype}: N={n} frontier {tuple(xs.shape)} ({gbytes:.3f} GB) bitwise equal; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), kernel at {bound_ms / ms:.1%} of bound",
                flush=True,
            )
            if dtype == torch.float32:  # the main path's dtype
                record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
            del xs
            torch.cuda.empty_cache()

        # simulate_fifo's grid, as gang_cover_times hands it over (jobs x reps
        # rows of one (B, r) gang, unmasked), and masked to the timing hook's 5 x 5
        r = FIFO_N // FIFO_B
        grid = torch.empty((FIFO_JOBS * N_REPS, FIFO_B, r), dtype=dtype, device=dev)
        grid.exponential_(generator=gen)
        grid[1000, 2, 2] = float("nan")
        grid[123456, 3, 7] = float("nan")  # outside the 5 x 5 mask
        grid[-1, 0, 1] = float("inf")
        for b, rr in [(FIFO_B, r), (FIFO_B // 2, r // 2)]:
            same, err = bitwise_equal(
                cover.masked_cover_times(grid, b, rr), cover.masked_cover_times_ref(grid, b, rr)
            )
            max_err = max(max_err, err)
            check(same, f"masked_cover_times {dtype} {tuple(grid.shape)} (b={b}, r={rr}) "
                        "differs from plain")
        print(f"{dtype}: simulate_fifo grid {tuple(grid.shape)} bitwise equal at "
              f"(b, r) = ({FIFO_B}, {r}) and ({FIFO_B // 2}, {r // 2})", flush=True)
        del grid
        torch.cuda.empty_cache()
    # the timing hook on simulate_fifo's shape
    reps = FIFO_JOBS * N_REPS
    hook = cover.bench_masked_cover(reps=reps, b_pad=FIFO_B, r_pad=FIFO_N // FIFO_B)
    print(f"bench_masked_cover ({reps}, {FIFO_B}, {FIFO_N // FIFO_B}) float32: "
          f"kernel {hook['kernel_ms']:.4f} ms, plain {hook['plain_ms']:.4f} ms", flush=True)
    record["max_abs_err"] = max_err
    return record


def main_path_dists():
    from repro_torch.core import traces
    from repro_torch.core.service_time import Empirical, Exponential, Pareto, ShiftedExponential

    job6 = next(j for j in traces.synthetic_google_jobs() if j.name == "job6")
    return [
        ("Exp(1)", Exponential(mu=1.0)),
        ("SExp(0.05, 1)", ShiftedExponential(delta=0.05, mu=1.0)),
        ("Pareto(1, 1.5)", Pareto(sigma=1.0, alpha=1.5)),
        ("job6", Empirical(samples=tuple(job6.task_times))),
    ]


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRANCH = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)")


def sass_functions(lib_path) -> dict:
    """Each kernel's SASS lines in a built library, by (unmangled) name."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[:300]}")
    funcs: dict = {}
    cur = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def loop_pass_instructions(lines) -> tuple[int, dict]:
    """Instructions on one pass through a kernel's main loop, and their count
    by opcode.  The main loop is the backward branch that spans the most
    code; the pass starts at its target and follows the code that takes no
    conditional branch (unconditional forward branches are followed) up to
    the branch back: the path of an iteration on which no special case of a
    math function arises.  NOPs are not counted."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        lm = _SASS_LABEL.match(line)
        if lm:
            pending.append(lm.group(1))
            continue
        im = _SASS_INSTR.search(line)
        if im:
            addr = int(im.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            instrs.append((addr, im.group(2).strip()))

    def target(text):
        m = _SASS_BRANCH.search(text)
        if not m:
            return None
        return labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)

    index = {a: i for i, (a, _) in enumerate(instrs)}
    backs = [(i, target(t)) for i, (a, t) in enumerate(instrs)
             if target(t) is not None and target(t) <= a]
    check(bool(backs), "no loop in the kernel's SASS")
    end, start = max(backs, key=lambda it: instrs[it[0]][0] - it[1])
    pos, count, ops = index[start], 0, {}
    for _ in range(len(instrs)):
        addr, text = instrs[pos]
        op = (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]
        if op != "NOP":
            count += 1
            ops[op] = ops.get(op, 0) + 1
        if pos == end:
            break
        tgt = target(text)
        if tgt is not None and not text.startswith("@") and tgt > addr:
            pos = index[tgt]
            continue
        pos += 1
    return count, ops


_LAW_NAMES = ("exponential", "shifted_exponential", "pareto", "empirical")


def phase_philox_vs_plain() -> dict:
    import numpy as np
    import torch

    from repro_torch._device import time_on_card
    from repro_torch.core import analysis
    from repro_torch.kernels import _build, cover, philox

    phase("cover kernel B (Philox sample-and-cover) vs plain version, on the card")
    dev = torch.device("cuda")
    dists = main_path_dists()
    max_err, worst_rel = 0.0, {"float32": 0.0, "float64": 0.0}
    ranges = [(0, PHILOX_CHECK_REPS), (N_REPS - PHILOX_CHECK_REPS, PHILOX_CHECK_REPS)]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for n in BUDGETS:
            cands = analysis.feasible_B(n)
            bs = np.asarray(cands)
            rs, scales = n // bs, n / bs
            for rep0, n_reps in ranges:
                # the uniforms the card draws are the plain version's, bit for bit
                got = cover.frontier_uniforms(SEED, len(cands), n_reps, n, rep0, dtype, dev)
                per = philox.draws_per_counter(philox.EXPONENTIAL, dtype)
                words = philox.stream_words(SEED, len(cands), rep0, n_reps, -(-n // per), dev)
                same, _ = bitwise_equal(got, philox.uniforms(words, dtype, n))
                check(same, f"Philox uniforms {name} N={n} reps from {rep0} differ from plain")
                del got, words
                for label, dist in dists:
                    args = (dist, bs, rs, scales, n_reps, SEED, rep0, dtype, dev)
                    got = cover.frontier_sample_cover(*args)
                    want = cover.frontier_sample_cover_ref(*args)
                    if dist.philox_law()[0] == philox.EMPIRICAL:
                        ok, err = bitwise_equal(got, want)
                        rel = 0.0
                    else:
                        diff = (got - want).abs()
                        err = float(diff.max())
                        # a cover time of 0 (a batch whose min draw is u = 0) has no
                        # relative error; compare it absolutely
                        tiny = torch.finfo(dtype).tiny
                        rel = float((diff / want.abs().clamp_min(tiny)).max())
                        ok = bool(torch.isfinite(got).all()) and rel <= PHILOX_RTOL[name]
                    max_err = max(max_err, err)
                    worst_rel[name] = max(worst_rel[name], rel)
                    check(ok, f"kernel B {name} {label} N={n} reps [{rep0}, {rep0 + n_reps}): "
                              f"max |err| {err}, max rel {rel} (limit {PHILOX_RTOL[name]})")
            torch.cuda.empty_cache()
        print(f"{name}: uniforms bitwise equal; cover times of {len(dists)} laws at N in "
              f"{BUDGETS}, reps {ranges} within limits (job6 bitwise); max |err| so far "
              f"{max_err:.3e}, max relative {worst_rel[name]:.3e} (limit {PHILOX_RTOL[name]})",
              flush=True)

    # instructions per Philox counter, from the compiled SASS, for the
    # operations bound; then each law at the main path's largest shape
    funcs = sass_functions(_build.library_path("cover"))
    n = max(BUDGETS)
    cands = analysis.feasible_B(n)
    bs = np.asarray(cands)
    rs, scales = n // bs, n / bs
    scales_t = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    by_law = {}
    for label, dist in dists:
        code, _, table = dist.philox_law()
        kname = f"sample_cover_f32_{_LAW_NAMES[code]}"
        check(kname in funcs, f"{kname} not found in the SASS of the cover library")
        per_counter, ops = loop_pass_instructions(funcs[kname])
        per = philox.draws_per_counter(code, torch.float32)
        counters = sum(-(-int(b * r) // per) for b, r in zip(bs, rs)) * N_REPS
        n_instr = per_counter * counters
        n_bytes = len(cands) * N_REPS * 4 + (0 if table is None else 4 * len(table)) \
            + len(cands) * 16
        bnd, by = bound_ms(n_bytes, n_instr, CARD_ISSUE_PER_S)
        args = (dist, bs, rs, scales, N_REPS, SEED, 0, torch.float32, dev)
        ms = time_on_card(lambda: cover.frontier_sample_cover(*args), iters=10)
        plain_ms = time_on_card(lambda: cover.frontier_sample_cover_ref(*args), iters=1,
                                warmup=1)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        shape = (len(cands), N_REPS, n)
        unfused_ms = time_on_card(
            lambda: cover.frontier_cover(dist.sample(gen, shape, dev, torch.float32), bs, rs,
                                         scales_t), iters=3)
        torch.cuda.empty_cache()
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8])
        print(f"{label:15s} float32 {shape}: kernel B {ms:.4f} ms; bound {bnd:.4f} ms ({by}: "
              f"{per_counter} instructions per counter of {per} draws from the SASS, "
              f"{n_instr:.4e} in all at {CARD_ISSUE_PER_S:.4e}/s), kernel at {bnd / ms:.1%} "
              f"of bound; plain {plain_ms:.4f} ms; unfused pass (dist.sample + kernel A) "
              f"{unfused_ms:.4f} ms; loop mix: {top}", flush=True)
        by_law[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                         "unfused_ms": unfused_ms, "instructions_per_counter": per_counter}
    rec = dict(by_law[dists[0][0]])  # the Exp law stands for the kernel in the kernels line
    rec.update(library_ms=None, max_abs_err=max_err, by_law=by_law)
    return rec


def phase_main_path() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster.vectorized import frontier_job_times
    from repro_torch.core import analysis
    from repro_torch.core.planner import RedundancyPlanner, _frontier_stats, plan_sweep
    from repro_torch.kernels import cover

    phase(f"main path: plan_sweep, budgets {BUDGETS}, {N_REPS} reps")
    dists = main_path_dists()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    t0 = time.perf_counter()
    plans = plan_sweep([d for _, d in dists], BUDGETS, n_reps=N_REPS, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    n_points = len(dists) * len(BUDGETS)
    print(f"plan_sweep: {n_points} grid points in {wall:.3f} s; cover launches by kernel "
          f"{launches}")
    check(launches == {"draws": 0, "philox": n_points},
          f"expected {n_points} kernel-B launches and none of kernel A, saw {launches}")
    print(f"plan_sweep peak device memory {torch.cuda.max_memory_allocated() / 1e9:.6f} GB")

    # the closed form holds for Exp / SExp: every candidate's Monte-Carlo mean
    # within 3 sigma, family-wise (Bonferroni over all candidates checked)
    checked = [
        (name, n, plans[i][j])
        for i, (name, _) in enumerate(dists[:2])
        for j, n in enumerate(BUDGETS)
    ]
    n_checks = sum(len(p.frontier_B) for _, _, p in checked)
    z_crit = statistics.NormalDist().inv_cdf(1.0 - 0.0027 / (2 * n_checks))
    z_max = 0.0
    for (name, n, plan), (_, dist) in zip(checked, [dists[0]] * 2 + [dists[1]] * 2):
        for b, m, cv in zip(plan.frontier_B, plan.frontier_mean, plan.frontier_cov):
            want = analysis.mean_T(dist, n, b)
            z = abs(m - want) / (m * cv / math.sqrt(N_REPS))
            z_max = max(z_max, z)
            check(z <= z_crit, f"{name} N={n} B={b}: mean {m} vs closed form {want} (z={z:.2f})")
    print(f"Exp/SExp frontier means vs closed form: {n_checks} candidates, "
          f"max |z| {z_max:.3f} <= {z_crit:.3f} (3 sigma family-wise)")

    # per grid point: B* and wall time of the same seeded pass, re-run alone
    for i, (name, dist) in enumerate(dists):
        for j, n in enumerate(BUDGETS):
            plan = plans[i][j]
            check(all(math.isfinite(m) and m > 0 for m in plan.frontier_mean),
                  f"{name} N={n}: a frontier mean is not finite and positive")
            seed = SEED + i * len(BUDGETS) + j
            t0 = time.perf_counter()
            again = RedundancyPlanner(n).plan_cluster(dist, n_reps=N_REPS, seed=seed)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(again == plan, f"{name} N={n}: re-run with the same seed gave another plan")
            print(f"{name:15s} N={n:4d}: B*={plan.n_batches:4d} r={plan.replication:4d} "
                  f"E[T]={plan.predicted_mean:.6g} CoV={plan.predicted_cov:.4f} "
                  f"wall {dt * 1e3:.3f} ms")

    # where a grid point's time goes at the largest budget: the frontier pass
    # (kernel B and the copy to the host) and the host's selection statistics
    # on the host clock, the pass's peak device memory, and the card's idle
    # share over one profiled plan_cluster
    n = max(BUDGETS)
    cands = analysis.feasible_B(n)
    for name, dist in dists:
        frontier_job_times(dist, n, cands, N_REPS, seed=SEED)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pass_ms, stats_ms = [], []
        for _ in range(5):  # host times vary between runs on a shared host
            t0 = time.perf_counter()
            rows = frontier_job_times(dist, n, cands, N_REPS, seed=SEED)  # ends in a copy
            pass_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _frontier_stats(rows)
            stats_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        wall_ms, busy_ms = device_busy_ms(
            lambda: RedundancyPlanner(n).plan_cluster(dist, n_reps=N_REPS, seed=SEED)
        )
        idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
        print(f"{name:15s} N={n}: frontier_job_times {statistics.median(pass_ms):.4f} ms, stats "
              f"{statistics.median(stats_ms):.4f} ms (host, median of 5; ranges "
              f"{min(pass_ms):.4f} to {max(pass_ms):.4f} and {min(stats_ms):.4f} to "
              f"{max(stats_ms):.4f}); pass peak device memory {peak / 1e6:.6f} MB above its "
              f"{base / 1e6:.3f} MB start; profiled plan_cluster {wall_ms:.4f} ms, card busy "
              f"{busy_ms:.4f} ms, idle share {idle}")

    # rep_chunk on the card: bit-identical to one launch
    one = frontier_job_times(dists[0][1], n, cands, N_REPS, seed=SEED)
    chunked = frontier_job_times(dists[0][1], n, cands, N_REPS, seed=SEED, rep_chunk=4096)
    check(one.shape == chunked.shape and np.array_equal(one, chunked),
          "frontier_job_times with rep_chunk=4096 differs from one launch")
    print(f"frontier_job_times rep_chunk=4096 ({N_REPS // 4096} launches) bitwise equal to "
          f"one launch at N={n}", flush=True)
    torch.cuda.empty_cache()
    return launches


def churn_scenario(**kw):
    import numpy as np

    from repro_torch.cluster import ChurnProcess, Scenario

    speeds = np.random.default_rng(0).uniform(0.5, 2.0, size=CHURN_N)
    return Scenario(churn=ChurnProcess(fail_rate=CHURN_FAIL_RATE, mean_downtime=CHURN_DOWNTIME),
                    speeds=tuple(float(x) for x in speeds), **kw)


def phase_churned_planning() -> dict:
    import warnings

    # the sampled churn horizon (2 pairs a worker, the reference benchmark's
    # choice) ends before most streams do; the warnings are counted and shown once
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        launches = _churned_planning()
    seen = sorted({str(w.message).split(":")[0] for w in caught
                   if issubclass(w.category, RuntimeWarning)})
    for text in seen:
        print(f"RuntimeWarning (expected, by the scenario's design): {text}")
    return launches


def _churned_planning() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster import ChurnProcess, Scenario, epoch_scan
    from repro_torch.cluster.epoch_scan import frontier_job_times_dynamic, simulate_epochs
    from repro_torch.core import RedundancyPlanner
    from repro_torch.core.service_time import Exponential, Pareto
    from repro_torch.kernels import cover

    n_streams = -(-CHURN_REPS // CHURN_STREAM)
    phase(f"churned planning on the epoch scan: N={CHURN_N}, {CHURN_REPS} reps "
          f"({n_streams} streams of {CHURN_STREAM} jobs), churn ({CHURN_FAIL_RATE}, "
          f"{CHURN_DOWNTIME}), {CHURN_PAIRS} pairs per worker, heterogeneous speeds, float32")
    sc = churn_scenario(churn_pairs_per_worker=CHURN_PAIRS, jobs_per_stream=CHURN_STREAM)
    planner = RedundancyPlanner(CHURN_N)
    cands = planner.candidates
    laws = [("Exp(1)", Exponential(mu=1.0)), ("Pareto(1, 1.8)", Pareto(sigma=1.0, alpha=1.8))]
    launches = {"draws": 0, "philox": 0}
    for name, dist in laws:
        planner.plan_cluster(dist, n_reps=CHURN_REPS, seed=SEED, scenario=sc)  # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cover.launches = cover.draws_launches = cover.philox_launches = 0
        epoch_scan.steps_run = 0
        walls = []
        for _ in range(3):  # host times vary between runs on a shared host
            t0 = time.perf_counter()
            plan = planner.plan_cluster(dist, n_reps=CHURN_REPS, seed=SEED, scenario=sc)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = epoch_scan.steps_run // 3
        got = {"draws": cover.draws_launches, "philox": cover.philox_launches}
        peak = torch.cuda.max_memory_allocated() - base
        check(got == {"draws": 0, "philox": 0}, f"{name}: a cover kernel ran: {got}")
        wall = statistics.median(walls)
        print(f"{name:15s}: B*={plan.n_batches} r={plan.replication} E[T]="
              f"{plan.predicted_mean:.6g}; plan_cluster {wall:.4f} s (median of 3, "
              f"{min(walls):.4f} to {max(walls):.4f}); {steps} steps, "
              f"{wall * 1e3 / steps:.4f} ms per step (host clock, host draws included); "
              f"peak device memory {peak / 1e6:.3f} MB above its {base / 1e6:.3f} MB start")
        check(all(math.isfinite(m) and m > 0 for m in plan.frontier_mean),
              f"{name}: a frontier mean is not finite and positive")
        # the host's share: drawing the 387 lanes with numpy, alone
        pairs = CHURN_PAIRS
        n_pad, jobs_pad, ev_pad, resc_cap, _ = epoch_scan._shapes(
            CHURN_N, CHURN_STREAM, sc.churn, None, pairs)
        lanes = np.arange(len(cands) * n_streams)
        t0 = time.perf_counter()
        epoch_scan._prepare_lanes(dist, CHURN_N, n_pad, lanes, len(lanes), jobs_pad, ev_pad,
                                  resc_cap, SEED, sc.churn, None, pairs, np.float32)
        draw_s = time.perf_counter() - t0
        print(f"{name:15s}: host numpy draws of the {len(lanes)} lanes alone {draw_s:.4f} s; the "
              f"lane loop's share of a call about {(wall - draw_s) * 1e3 / steps:.4f} ms per step")
        # the frontier rows and B*, card against CPU, bitwise
        rows = frontier_job_times_dynamic(dist, CHURN_N, cands, CHURN_REPS, seed=SEED, scenario=sc)
        t0 = time.perf_counter()
        cpu = frontier_job_times_dynamic(dist, CHURN_N, cands, CHURN_REPS, seed=SEED,
                                         scenario=sc, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(rows.shape == (len(cands), n_streams * CHURN_STREAM), f"rows shape {rows.shape}")
        check(np.array_equal(rows.view(np.uint64), cpu.view(np.uint64)),
              f"{name}: frontier rows differ card vs CPU")
        plan_cpu = planner.plan_cluster(dist, n_reps=CHURN_REPS, seed=SEED, scenario=sc,
                                        device="cpu")
        check(plan == plan_cpu, f"{name}: plan differs card vs CPU")
        print(f"{name:15s}: frontier rows {rows.shape} bitwise equal to the CPU's "
              f"({cpu_s:.3f} s there), {np.isfinite(rows).mean():.6f} finite; same plan")
        # where a call's time goes: launches per step, the card's idle share
        # (the card traced alone: reading a host trace back costs a minute)
        counts: dict = {}
        epoch_scan.steps_run = 0
        wall_ms, by_name = profile_device(
            lambda: planner.plan_cluster(dist, n_reps=CHURN_REPS, seed=SEED, scenario=sc),
            counts=counts, cpu=False)
        steps = epoch_scan.steps_run
        busy_ms = sum(by_name.values()) / 1e3
        n_kernels = sum(counts.values())
        idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
        print(f"{name:15s}: profiled plan_cluster {wall_ms:.4f} ms, card busy {busy_ms:.4f} ms, "
              f"idle share {idle}; {n_kernels} kernels and copies, "
              f"{n_kernels / steps:.2f} per step over {steps} steps")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
            print(f"    {us / 1e3:9.4f} ms  {counts[kname]:7d}x  {kname[:80]}")
        launches = {k: launches[k] + got[k] for k in launches}

    # rep_chunk: 1024 streams per pass covers all 43 in one; 16 splits them in three
    dist = laws[0][1]
    one = frontier_job_times_dynamic(dist, CHURN_N, cands, CHURN_REPS, seed=SEED, scenario=sc)
    for chunk in (1024, 16):
        part = frontier_job_times_dynamic(dist, CHURN_N, cands, CHURN_REPS, seed=SEED,
                                          scenario=sc.replace(rep_chunk=chunk))
        check(np.array_equal(one.view(np.uint64), part.view(np.uint64)),
              f"rep_chunk={chunk} differs from one call")
    print(f"rep_chunk 1024 ({-(-n_streams // 1024)} pass) and 16 ({-(-n_streams // 16)} passes) "
          "bitwise equal to one call")

    # the JAX package's frontier rows (float64, a small churned scenario)
    golden = json.loads(GOLDEN_EPOCH.read_text())
    g_sc = Scenario(churn=ChurnProcess(**golden["churn"]), speeds=tuple(golden["speeds"]),
                    **golden["scenario"])
    g_dist = {"Pareto": Pareto, "Exponential": Exponential}[golden["dist"]["kind"]](
        **golden["dist"]["fields"])
    g_rows = frontier_job_times_dynamic(g_dist, golden["n_workers"], golden["candidates"],
                                        golden["n_reps"], seed=golden["seed"], scenario=g_sc)
    want = np.array(golden["rows"], dtype=np.float64)
    check(np.array_equal(g_rows.view(np.uint64), want.view(np.uint64)),
          f"frontier rows differ from {GOLDEN_EPOCH.relative_to(ROOT)}")
    print(f"frontier rows {g_rows.shape} bitwise equal to {GOLDEN_EPOCH.relative_to(ROOT)} "
          "(the JAX package's output)")

    # simulate_epochs in float64: card against CPU
    arrivals = np.cumsum(np.random.default_rng(SEED).exponential(EPOCH_GAP, EPOCH_JOBS))
    e_sc = churn_scenario(cancel_redundant=True, size_dependent=False, dtype="float64")
    args = (Exponential(mu=1.0), CHURN_N, EPOCH_B, arrivals, EPOCH_REPS)
    epoch_scan.steps_run = 0
    t0 = time.perf_counter()
    card = simulate_epochs(*args, seed=SEED, scenario=e_sc)
    card_s = time.perf_counter() - t0
    steps = epoch_scan.steps_run
    t0 = time.perf_counter()
    cpu = simulate_epochs(*args, seed=SEED, scenario=e_sc, device="cpu")
    cpu_s = time.perf_counter() - t0
    for f in ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
              "n_worker_failures", "n_replicas_rescued", "n_replans"):
        a, b = getattr(card, f), getattr(cpu, f)
        bits = (lambda x: x.view(np.uint64)) if a.dtype == np.float64 else (lambda x: x)
        check(a.dtype == b.dtype and np.array_equal(bits(a), bits(b)),
              f"simulate_epochs {f} differs card vs CPU")
    worst = 0.0
    for f in ("worker_seconds", "cancelled_seconds_saved"):
        a, b = getattr(card, f), getattr(cpu, f)
        check(bool((np.abs(a - b) <= 1e-12 * np.abs(b)).all()),
              f"simulate_epochs {f}: card vs CPU beyond rtol 1e-12")
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
    check(np.isfinite(card.finishes).all(), "simulate_epochs: an unfinished job")
    check(card.n_replicas_rescued.sum() > 0, "simulate_epochs: no rescue in the run")
    print(f"simulate_epochs N={CHURN_N} B={EPOCH_B}, {EPOCH_JOBS} Poisson arrivals, "
          f"{EPOCH_REPS} reps, cancelling, float64: {card_s:.4f} s on the card ({steps} steps), "
          f"{cpu_s:.4f} s on the CPU; bitwise equal except the worker-second sums (max "
          f"relative {worst:.3e}); failures {int(card.n_worker_failures.sum())}, rescues "
          f"{int(card.n_replicas_rescued.sum())}, churn horizon outrun in "
          f"{int(card.churn_truncated.sum())} of {EPOCH_REPS} reps", flush=True)
    torch.cuda.empty_cache()
    return launches


def _measure(label: str, fn, repeats: int = 3, profiled=None):
    """Run ``fn`` ``repeats`` times on the card and ``profiled`` (default
    ``fn``) once more under ``torch.profiler``; print the median wall time,
    the steps of one call, host ms per step, kernel launches per step and the
    card's idle share (of the profiled call), and the peak device memory.
    Returns the first call's result."""
    import torch

    from repro_torch.cluster import epoch_scan

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls, first = [], None
    epoch_scan.steps_run = 0
    for i in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        first = out if i == 0 else first
    steps = epoch_scan.steps_run // repeats
    peak = torch.cuda.max_memory_allocated() - base
    counts: dict = {}
    epoch_scan.steps_run = 0
    t0 = time.perf_counter()
    wall_ms, by_name = profile_device(profiled or fn, counts=counts, cpu=False)
    read_s = time.perf_counter() - t0 - wall_ms / 1e3
    busy_ms = sum(by_name.values()) / 1e3
    n_kernels = sum(counts.values())
    idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
    wall = statistics.median(walls)
    print(f"{label}: {wall:.4f} s (median of {repeats}, {min(walls):.4f} to {max(walls):.4f}); "
          f"{steps} steps, {wall * 1e3 / max(steps, 1):.4f} host ms per step; "
          f"{n_kernels / max(epoch_scan.steps_run, 1):.2f} kernel launches and copies per step "
          f"({n_kernels} in a profiled call of {wall_ms:.1f} ms, read back in {read_s:.1f} s); "
          f"card idle {idle}; peak "
          f"device memory {peak / 1e6:.3f} MB above its {base / 1e6:.3f} MB start", flush=True)
    return first


def _same_report(card, cpu, what: str, fields, sums=()) -> None:
    """Integers and float64 times bitwise, the worker-second sums within rtol 1e-12."""
    import numpy as np

    for f in fields:
        a, b = getattr(card, f), getattr(cpu, f)
        if a is None and b is None:
            continue
        bits = (lambda x: x.view(np.uint64)) if a.dtype == np.float64 else (lambda x: x)
        check(a.dtype == b.dtype and np.array_equal(bits(a), bits(b)),
              f"{what}: {f} differs card vs CPU")
    for f in sums:
        a, b = getattr(card, f), getattr(cpu, f)
        check(bool((np.abs(a - b) <= 1e-12 * np.abs(b)).all()),
              f"{what}: {f} card vs CPU beyond rtol 1e-12")


def phase_dynamic_policies() -> dict:
    import warnings

    # the sampled churn horizon (2 pairs a worker) ends before most streams
    # do, as in the churned-planning phase; the warnings are shown once
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        launches = _dynamic_policies()
    seen = sorted({str(w.message).split(":")[0] for w in caught
                   if issubclass(w.category, RuntimeWarning)})
    for text in seen:
        print(f"RuntimeWarning (expected, by the scenario's design): {text}")
    return launches


def _dynamic_policies() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster import (
        SLO,
        ChurnProcess,
        ReplanConfig,
        Scenario,
        Speculation,
        epoch_stream_stats,
    )
    from repro_torch.cluster.epoch_scan import simulate_epochs
    from repro_torch.cluster.stream import _ACC_FIELDS
    from repro_torch.core import RedundancyPlanner, traces
    from repro_torch.core.service_time import Exponential, Pareto
    from repro_torch.kernels import cover

    replan = ReplanConfig(window=REPLAN_WINDOW, refit_every=REPLAN_EVERY,
                          min_observations=REPLAN_MIN)
    phase(f"dynamic policies on the epoch scan: the replanner ({replan}) at N={CHURN_N} on "
          f"the churned scenario ({DYN_PAIRS} fail/join pair a worker), speculation at "
          f"N={SPEC_N}, the streaming fold, plan_slo on the churned cluster")
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    decisions = ("n_replans", "n_batches_used", "replication_used")
    times = ("starts", "finishes", "epoch_times", "n_worker_failures", "n_replicas_rescued")
    sums = ("worker_seconds", "cancelled_seconds_saved")

    # -- the replanner in simulate_epochs, from B = N, float64
    arrivals = np.cumsum(np.random.default_rng(SEED).exponential(EPOCH_GAP, EPOCH_JOBS))
    r_sc = churn_scenario(cancel_redundant=True, size_dependent=False, dtype="float64",
                          churn_pairs_per_worker=DYN_PAIRS, replan=replan)
    law = Pareto(sigma=1.0, alpha=1.8)
    args = (law, CHURN_N, CHURN_N, arrivals, EPOCH_REPS)
    card = _measure(f"replanner simulate_epochs N={CHURN_N}, {EPOCH_JOBS} jobs, {EPOCH_REPS} "
                    "reps, float64", lambda: simulate_epochs(*args, seed=SEED, scenario=r_sc))
    t0 = time.perf_counter()
    cpu = simulate_epochs(*args, seed=SEED, scenario=r_sc, device="cpu")
    cpu_s = time.perf_counter() - t0
    _same_report(card, cpu, "replanner simulate_epochs", decisions + times, sums)
    check(bool((card.n_replans >= 1).all()), "replanner: a rep ran without a replan")
    check(np.isfinite(card.finishes).all(), "replanner: an unfinished job")
    print(f"replanner: decisions and times equal to the CPU's ({cpu_s:.4f} s there); replans "
          f"per rep {int(card.n_replans.min())} to {int(card.n_replans.max())}, final B "
          f"{sorted(set(card.final_n_batches.tolist()))}", flush=True)

    # -- the replanner while plan_cluster scores the frontier, float32
    p_sc = churn_scenario(churn_pairs_per_worker=DYN_PAIRS, jobs_per_stream=CHURN_STREAM,
                          replan=replan)
    planner = RedundancyPlanner(CHURN_N)
    plan = _measure(f"replanner plan_cluster N={CHURN_N}, {CHURN_REPS} reps, float32",
                    lambda: planner.plan_cluster(law, n_reps=CHURN_REPS, seed=SEED,
                                                 scenario=p_sc))
    t0 = time.perf_counter()
    plan_cpu = planner.plan_cluster(law, n_reps=CHURN_REPS, seed=SEED, scenario=p_sc,
                                    device="cpu")
    cpu_s = time.perf_counter() - t0
    check(plan.n_batches == plan_cpu.n_batches, f"replanner plan_cluster: B* {plan.n_batches} "
          f"on the card, {plan_cpu.n_batches} on the CPU")
    print(f"replanner plan_cluster: B*={plan.n_batches} as on the CPU ({cpu_s:.4f} s there); "
          f"whole plan equal: {plan == plan_cpu}", flush=True)

    # -- speculation as the reference's example runs it, float64
    s_sc = Scenario(speculation=Speculation(interval=SPEC_INTERVAL, theta=SPEC_THETA,
                                            min_observations=SPEC_MIN_OBS),
                    cancel_redundant=True, dtype="float64")
    s_law = Pareto(sigma=1.0, alpha=SPEC_ALPHA)
    b_star = RedundancyPlanner(SPEC_N).plan(s_law, objective="mean").n_batches
    s_fields = decisions + times + ("n_speculative",)
    for b in (SPEC_N, b_star):
        s_args = (s_law, SPEC_N, b, np.zeros(SPEC_JOBS), SPEC_REPS)
        label = f"speculation N={SPEC_N} B={b}, {SPEC_JOBS} jobs, {SPEC_REPS} reps, float64"
        run = lambda: simulate_epochs(*s_args, seed=SEED, scenario=s_sc)  # noqa: E731
        card = _measure(label, run) if b == SPEC_N else run()
        cpu = simulate_epochs(*s_args, seed=SEED, scenario=s_sc, device="cpu")
        _same_report(card, cpu, f"speculation B={b}", s_fields, sums)
        check(card.n_speculative.sum() > 0, f"speculation B={b}: no backup launched")
        msg = (f"speculation B={b}: bitwise equal to the CPU but the sums; backups per rep "
               f"{card.n_speculative.mean():.2f}; mean compute time "
               f"{card.compute_times.mean():.6f}")
        if b == SPEC_N:
            plain = simulate_epochs(*s_args, seed=SEED, scenario=s_sc.replace(speculation=None))
            check(card.compute_times.mean() < plain.compute_times.mean(),
                  "speculation did not cut the mean compute time at B = N")
            msg += f" against {plain.compute_times.mean():.6f} without backups"
        print(msg, flush=True)

    # -- the streaming fold on the churned case without the replanner
    f_sc = r_sc.replace(replan=None)
    stream = _measure(f"streaming fold simulate_epochs N={CHURN_N}, {EPOCH_JOBS} jobs, "
                      f"{EPOCH_REPS} reps, float64 (no replanner)",
                      lambda: simulate_epochs(*args, seed=SEED,
                                              scenario=f_sc.replace(outputs="stream")))
    full = simulate_epochs(*args, seed=SEED, scenario=f_sc)
    cpu = simulate_epochs(*args, seed=SEED, scenario=f_sc.replace(outputs="stream"),
                          device="cpu")
    host = epoch_stream_stats(full)
    for f in _ACC_FIELDS:
        a, h, c = getattr(stream.stats, f), getattr(host, f), getattr(cpu.stats, f)
        check(a.dtype == h.dtype and np.array_equal(a, h),
              f"stream {f} differs from the host fold of the card's full report")
        # busy_sum / saved_sum are the lane's worker-second sums: the card's
        # reduction picks their order, so against the CPU they hold to 1e-12
        same = (np.abs(a - c) <= 1e-12 * np.abs(c)).all() if f in ("busy_sum", "saved_sum") \
            else np.array_equal(a, c)
        check(a.dtype == c.dtype and bool(same), f"stream {f} differs from the CPU's stream")
    print(f"streaming fold: stats bitwise equal to epoch_stream_stats of the card's full report; "
          f"against the CPU's stream bitwise but the two worker-second sums (rtol 1e-12); "
          f"{int(stream.stats.count.sum())} jobs folded, {int(stream.n_unfinished.sum())} "
          "unfinished", flush=True)

    # -- plan_slo on the churned cluster, float64
    slo = SLO(quantile=0.99, target_s=SLO_DYN_TARGET, arrival_rate=SLO_DYN_RATE)
    d_sc = churn_scenario(cancel_redundant=True, size_dependent=False, dtype="float64",
                          churn_pairs_per_worker=DYN_PAIRS)
    kw = dict(scenario=d_sc, n_jobs=SLO_DYN_JOBS, n_reps=SLO_DYN_REPS, seed=SEED,
              schedulers=("fifo_gang",))
    # one call (its 9 candidates are 9 simulate_epochs calls), and the
    # profiler over one candidate's, B = 10: the phase's time budget
    stream_jobs = traces.poisson_stream(
        [traces.TraceJob(name="pareto", family="fitted", task_times=np.ones(1))],
        SLO_DYN_RATE, SLO_DYN_JOBS, seed=SEED).arrivals
    slo_plan = _measure(f"plan_slo N={CHURN_N} churned, Pareto(1, 1.8), p99 <= "
                        f"{SLO_DYN_TARGET} s at {SLO_DYN_RATE} jobs/s, {SLO_DYN_JOBS} jobs, "
                        f"{SLO_DYN_REPS} reps, float64 (profiled: the B=10 candidate)",
                        lambda: planner.plan_slo(law, slo, **kw), repeats=1,
                        profiled=lambda: simulate_epochs(law, CHURN_N, 10, stream_jobs,
                                                         SLO_DYN_REPS, seed=SEED,
                                                         scenario=d_sc))
    t0 = time.perf_counter()
    slo_cpu = planner.plan_slo(law, slo, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    n_ok, n_cand = sum(c.feasible for c in slo_plan.candidates), len(planner.candidates)
    check(slo_plan.source == "epoch_scan", f"plan_slo source {slo_plan.source}")
    check(len(slo_plan.candidates) == n_cand and 0 < n_ok < n_cand,
          f"{n_ok} of {len(slo_plan.candidates)} candidates feasible: want some but not all")
    check(slo_plan.feasible == slo_cpu.feasible and slo_plan.best.n_batches
          == slo_cpu.best.n_batches, "plan_slo: the card's best differs from the CPU's")
    for g, w in zip(slo_plan.candidates, slo_cpu.candidates):
        check((g.n_batches, g.feasible, g.achieved, g.mean_response)
              == (w.n_batches, w.feasible, w.achieved, w.mean_response)
              and abs(g.cost_worker_seconds - w.cost_worker_seconds)
              <= 1e-12 * abs(w.cost_worker_seconds), f"plan_slo candidate B={w.n_batches} "
              "differs card vs CPU")
    print(f"plan_slo: the card's SLOPlan equals the CPU's ({cpu_s:.3f} s there); {n_ok} of "
          f"{n_cand} feasible; best B={slo_plan.best.n_batches} at "
          f"{slo_plan.best.cost_worker_seconds:.6g} worker-seconds", flush=True)

    # -- the JAX package's float64 runs of one replanning and one churned
    # speculation scenario
    for path in GOLDEN_POLICIES:
        golden = json.loads(path.read_text())
        g_kw = dict(golden["scenario"], speeds=tuple(golden["speeds"]))
        if "replan" in golden:
            g_kw["replan"] = ReplanConfig(**golden["replan"])
        if "speculation" in golden:
            g_kw["speculation"] = Speculation(**golden["speculation"])
        if "churn" in golden:
            g_kw["churn"] = ChurnProcess(**golden["churn"])
        g_law = {"Pareto": Pareto, "Exponential": Exponential}[golden["dist"]["kind"]](
            **golden["dist"]["fields"])
        rep = simulate_epochs(g_law, golden["n_workers"], golden["n_batches"],
                              np.asarray(golden["arrivals"]), golden["n_reps"],
                              seed=golden["seed"], scenario=Scenario(**g_kw))
        for f in ("n_replans", "n_batches_used", "replication_used", "starts", "finishes",
                  "n_speculative", "n_worker_failures", "n_replicas_rescued", "epoch_times"):
            if f not in golden:
                continue
            got = np.asarray(getattr(rep, f))
            want = np.asarray(golden[f], dtype=got.dtype)
            bits = (lambda x: x.view(np.uint64)) if got.dtype == np.float64 else (lambda x: x)
            check(np.array_equal(bits(got), bits(want)), f"{path.name}: {f} differs")
        for f in sums:
            got, want = np.asarray(getattr(rep, f)), np.asarray(golden[f])
            check(bool((np.abs(got - want) <= 1e-12 * np.abs(want)).all()),
                  f"{path.name}: {f} beyond rtol 1e-12")
        print(f"{path.relative_to(ROOT)}: the card's run equals the JAX package's "
              "(bitwise but the sums, rtol 1e-12)", flush=True)
    got = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    check(got == {"draws": 0, "philox": 0}, f"a cover kernel ran: {got}")
    torch.cuda.empty_cache()
    return got


def phase_space_engine() -> dict:
    import warnings

    # the churned cluster's 2 pairs a worker end before most streams do, as in
    # the churned-planning phase; the warnings are shown once
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        launches = _space_engine()
    seen = sorted({str(w.message).split(":")[0] for w in caught
                   if issubclass(w.category, RuntimeWarning)})
    for text in seen:
        print(f"RuntimeWarning (expected, by the scenario's design): {text}")
    return launches


def _space_engine() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster import (
        ChurnProcess,
        ChurnSchedule,
        ClusterEngine,
        Job,
        JobPlan,
        Scenario,
    )
    from repro_torch.cluster.epoch_scan import frontier_job_times_dynamic, simulate_epochs
    from repro_torch.cluster.vectorized import simulate_fifo
    from repro_torch.core import RedundancyPlanner, analysis
    from repro_torch.core.service_time import Empirical, Exponential, Pareto
    from repro_torch.kernels import cover
    from test_torch_space_lane_cuda import engine_lane_mismatches

    phase(f"space sharing and the event engine: engine against the space lane (f64), the "
          f"golden, space-shared planning at N={CHURN_N} on the churned cluster, "
          f"bench_space_sharing at N={SPACE_N}")
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    sums = ("worker_seconds", "cancelled_seconds_saved")
    fields = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
              "n_worker_failures", "n_replicas_rescued")

    # -- the engine on the host against the space lane on the card, float64
    sched = ChurnSchedule(times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4), wids=(2, 5, 2, 0, 5, 0),
                          ups=(False, False, True, False, True, True))
    speeds = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)
    const = Empirical((1.3,))
    n_exact = 0
    for policy in ("fifo_gang", "packed", "balanced"):
        for cancel in (False, True):
            er = ClusterEngine(6, seed=3, n_batches=2, cancel_redundant=cancel, speeds=speeds,
                               churn_schedule=sched, scheduler=policy, workers_per_job=2).run(
                [Job(job_id=i, dist=const, n_tasks=6) for i in range(8)])
            vr = simulate_epochs(const, 6, 2, np.zeros(8), 1, seed=3, scenario=Scenario(
                cancel_redundant=cancel, speeds=speeds, churn_schedule=sched, scheduler=policy,
                workers_per_job=2, dtype="float64"))
            bad = engine_lane_mismatches(er, vr)
            check(not bad, f"{policy} cancel={cancel}: the lane differs from the engine in {bad}")
            check(policy == "fifo_gang" or er.n_replicas_rescued > 0,
                  f"{policy}: no rescue on the crafted schedule")
            n_exact += 1
    arr = np.array([0.0, 0.0, 0.8, 1.2, 2.9, 4.0, 5.5, 6.1, 8.0])
    rng = np.random.default_rng(4)  # tests/strategies.py seeded_job_plans(6, seed=4)
    plans = [JobPlan(workers=int(rng.integers(1, 7)), n_batches=int(rng.integers(1, 7)),
                     cancel_redundant=bool(rng.integers(0, 2))) for _ in range(2)] + [None]
    d17 = Empirical((1.7,))
    for policy in ("packed", "balanced"):
        er = ClusterEngine(6, seed=7, n_batches=3, speeds=speeds, churn_schedule=sched,
                           scheduler=policy, workers_per_job=2).run(
            [Job(job_id=i, dist=d17, n_tasks=6, arrival=float(arr[i]), plan=plans[i % 3])
             for i in range(9)])
        vr = simulate_epochs(d17, 6, 3, arr, 1, seed=7, scenario=Scenario(
            speeds=speeds, churn_schedule=sched, scheduler=policy, workers_per_job=2,
            job_plans=plans, dtype="float64"))
        bad = engine_lane_mismatches(er, vr)
        check(not bad, f"{policy} heterogeneous plans: the lane differs from the engine in {bad}")
        check(len({r.n_batches for r in er.records}) >= 2, "the plans ran one B")
        n_exact += 1
    print(f"engine (host) against the space lane (card), float64: {n_exact} runs, every "
          "trajectory, epoch time and counter equal", flush=True)

    # -- the JAX package's float64 space runs
    golden = json.loads(GOLDEN_SPACE.read_text())
    for name, g in golden.items():
        case = g["case"]
        kw = dict(case["scenario"], speeds=tuple(case["speeds"]),
                  churn=ChurnProcess(**case["churn"]))
        if case["job_plans"] is not None:
            kw["job_plans"] = [None if p is None else JobPlan(**p) for p in case["job_plans"]]
        law = {"Pareto": Pareto, "Exponential": Exponential}[case["dist"]["kind"]](
            **case["dist"]["fields"])
        rep = simulate_epochs(law, case["n_workers"], case["n_batches"],
                              np.asarray(case["arrivals"]), case["n_reps"], seed=case["seed"],
                              scenario=Scenario(**kw))
        for f in fields:
            got = np.asarray(getattr(rep, f))
            want = np.asarray(g[f], dtype=got.dtype)
            bits = (lambda x: x.view(np.uint64)) if got.dtype == np.float64 else (lambda x: x)
            check(np.array_equal(bits(got), bits(want)), f"{GOLDEN_SPACE.name} {name}: {f}")
        for f in sums:
            got, want = np.asarray(getattr(rep, f)), np.asarray(g[f])
            check(bool((np.abs(got - want) <= 1e-12 * np.abs(want)).all()),
                  f"{GOLDEN_SPACE.name} {name}: {f} beyond rtol 1e-12")
    print(f"{GOLDEN_SPACE.relative_to(ROOT)}: the card's runs equal the JAX package's "
          f"({len(golden)} cases, bitwise but the sums, rtol 1e-12)", flush=True)

    # -- space-shared planning on the churned cluster, float32
    law = Pareto(sigma=1.0, alpha=1.8)
    planner = RedundancyPlanner(CHURN_N, candidates=SPACE_PLAN_CANDS)
    n_streams = -(-CHURN_REPS // SPACE_STREAM)
    for policy in ("packed", "balanced"):
        sc = churn_scenario(churn_pairs_per_worker=CHURN_PAIRS, jobs_per_stream=SPACE_STREAM,
                            scheduler=policy, workers_per_job=SPACE_PLAN_WPJ)
        plan = _measure(f"space-shared plan_cluster {policy} N={CHURN_N}, {SPACE_PLAN_WPJ} "
                        f"workers a job, {len(SPACE_PLAN_CANDS)} candidates x {n_streams} "
                        f"streams of {SPACE_STREAM} jobs, {CHURN_REPS} reps, float32",
                        lambda: planner.plan_cluster(law, n_reps=CHURN_REPS, seed=SEED,
                                                     scenario=sc))
        t0 = time.perf_counter()
        plan_cpu = planner.plan_cluster(law, n_reps=CHURN_REPS, seed=SEED, scenario=sc,
                                        device="cpu")
        cpu_s = time.perf_counter() - t0
        check(plan == plan_cpu, f"space-shared plan_cluster {policy}: plan differs card vs CPU")
        check(all(math.isfinite(m) and m > 0 for m in plan.frontier_mean),
              f"{policy}: a frontier mean is not finite and positive")
        print(f"space-shared plan_cluster {policy}: B*={plan.n_batches}, E[T]="
              f"{plan.predicted_mean:.6g}; the same plan on the CPU in {cpu_s:.4f} s",
              flush=True)
        # the same call at SPACE_CHECK_REPS reps in float64: card against CPU
        sc64 = sc.replace(dtype="float64")
        rows = frontier_job_times_dynamic(law, CHURN_N, SPACE_PLAN_CANDS, SPACE_CHECK_REPS,
                                          seed=SEED, scenario=sc64)
        cpu = frontier_job_times_dynamic(law, CHURN_N, SPACE_PLAN_CANDS, SPACE_CHECK_REPS,
                                         seed=SEED, scenario=sc64, device="cpu")
        check(np.array_equal(rows.view(np.uint64), cpu.view(np.uint64)),
              f"{policy}: float64 frontier rows differ card vs CPU")
        check(bool(np.isfinite(rows).any()),
              f"{policy}: no job finished at {SPACE_CHECK_REPS} reps")
        print(f"{policy} at {SPACE_CHECK_REPS} reps, float64: frontier rows {rows.shape} bitwise "
              "equal to the CPU's", flush=True)

    # -- bench_space_sharing: the scheduling effect
    ratio_law, arr = Pareto(1.0, 1.8), np.zeros(SPACE_JOBS)
    gang = simulate_fifo(ratio_law, SPACE_N, 2, arr, SPACE_RATIO_REPS, seed=0)
    fifo_kw = dict(seed=0, scheduler="packed", workers_per_job=SPACE_WPJ, dtype="float64")
    packed = simulate_fifo(ratio_law, SPACE_N, 2, arr, SPACE_RATIO_REPS, **fifo_kw)
    packed_cpu = simulate_fifo(ratio_law, SPACE_N, 2, arr, SPACE_RATIO_REPS, device="cpu",
                               **fifo_kw)
    for f in ("starts", "finishes"):
        check(np.array_equal(getattr(packed, f).view(np.uint64),
                             getattr(packed_cpu, f).view(np.uint64)),
              f"packed simulate_fifo {f} differs card vs CPU")
    ratio = float(packed.response_times.mean() / gang.response_times.mean())
    check(ratio < 1.0, f"packed/gang mean response ratio {ratio:.6f} is not below 1")
    print(f"scheduling effect (simulate_fifo N={SPACE_N} B=2, {SPACE_JOBS} jobs at t=0, "
          f"{SPACE_RATIO_REPS} reps): packed ({SPACE_WPJ} workers a job, float64, bitwise equal "
          f"to the CPU) / fifo_gang mean response = {ratio:.6f}", flush=True)

    # -- bench_space_sharing: the two backends on the space-shared frontier
    cands = analysis.feasible_B(SPACE_WPJ)
    b_planner = RedundancyPlanner(SPACE_N, candidates=cands)
    b_sc = Scenario(scheduler="packed", workers_per_job=SPACE_WPJ, jobs_per_stream=SPACE_STREAM)
    for name, b_law in (("Exp(1)", Exponential(1.0)), ("Pareto(1, 1.8)", Pareto(1.0, 1.8))):
        kw = dict(n_reps=SPACE_REPS, seed=0, scenario=b_sc)
        b_planner.plan_cluster(b_law, **kw)  # warm
        warms = []
        for _ in range(3):
            t0 = time.perf_counter()
            p_torch = b_planner.plan_cluster(b_law, **kw)
            torch.cuda.synchronize()
            warms.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        p_py = b_planner.plan_cluster(b_law, backend="python", **kw)
        t_py = time.perf_counter() - t0
        check(p_py.source == "cluster_engine:python" and p_torch.source == "cluster_engine:torch",
              "plan sources")
        if name == "Exp(1)":
            check(p_py.n_batches == p_torch.n_batches,
                  f"Exp(1): B {p_py.n_batches} on the engine, {p_torch.n_batches} on the lane")
        print(f"two backends, {name}, N={SPACE_N}, candidates {cands}, {SPACE_REPS} reps: "
              f"python (engine, host) {t_py:.4f} s B={p_py.n_batches}; torch (space lane, card) "
              f"{min(warms):.4f} s best of 3 ({max(warms):.4f} worst) B={p_torch.n_batches}; "
              f"python / torch = {t_py / min(warms):.3f}", flush=True)
    got = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    # the fifo_gang side of the scheduling effect is the only cover-kernel pass
    check(got == {"draws": 1, "philox": 0}, f"cover kernels in the phase: {got}")
    torch.cuda.empty_cache()
    return got


@dataclasses.dataclass
class _Deterministic:
    """Constant service time: the engine's a-priori model of a known batch
    cost (``benchmarks/runtime_bench.py``'s predictor)."""

    value: float

    def sample_np(self, rng, shape):
        return self.value


def _twin_exact(report, events, what: str) -> None:
    """The trace fold, the port's engine replay and the live counters agree
    exactly, and so do the job records."""
    from test_torch_runtime_cuda import replay_mismatches

    _, bad = replay_mismatches(report, events)
    check(bad == [], f"{what}: {bad}")


def _live_breakdown(events) -> str:
    """Where a live run's time goes beyond the workload's own: each job's span
    over its earliest cover at full skew (batch B - 1 on wid B - 1), each
    finished replica's elapsed time over its planned duration (the worker's
    start lag, the last step's overshoot, the finish frame's way back), and
    the gap from one job's end to the next one's start."""
    ideal = LIVE_COST * (LIVE_TASKS // LIVE_B) * (1 + (LIVE_B - 1) * LIVE_SKEW)
    starts = {e["job"]: e["t"] for e in events if e["ev"] == "job_start"}
    dones = {e["job"]: e["t"] for e in events if e["ev"] == "job_done"}
    over = [dones[j] - starts[j] - ideal for j in sorted(dones) if j in starts]
    gaps = [starts[j + 1] - dones[j] for j in sorted(dones) if j + 1 in starts]
    open_, excess = {}, []
    for e in events:
        if e["ev"] == "dispatch":
            open_[e["wid"]] = e
        elif e["ev"] == "finish":
            d = open_.pop(e["wid"])
            excess.append(e["t"] - d["t"] - d["planned"])
        elif e["ev"] in ("cancel", "fail", "flush", "task_fail"):
            open_.pop(e["wid"], None)

    def ms(xs):
        return (f"mean {1e3 * statistics.fmean(xs):.2f} ms, max {1e3 * max(xs):.2f} ms"
                if xs else "none")

    return (f"job span over its {ideal} s cover: {ms(over)} ({len(over)} jobs); finished "
            f"replica over its plan: {ms(excess)} ({len(excess)}); job end to next start: "
            f"{ms(gaps)}")


def _cmdline(pid: int) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().decode().split("\0")


def phase_live_runtime() -> dict:
    """The live master-worker runtime with the torch payload on the card."""
    import asyncio
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch.cluster import ClusterEngine, Job, Scenario
    from repro_torch.cluster.runtime import (
        LiveJob,
        Runtime,
        RuntimeMaster,
        read_journal,
        replay_trace,
        spawn_worker_subprocess,
        spawn_worker_thread,
    )
    from repro_torch.cluster.runtime.worker import run_payload
    from repro_torch.kernels import cover, flash_attention, rmsnorm
    from test_torch_runtime_cuda import golden_mismatches

    phase(f"live runtime on the card: {LIVE_N} thread workers, B={LIVE_B}, {LIVE_JOBS} jobs of "
          f"{LIVE_TASKS} tasks at {LIVE_COST} s, skew {LIVE_SKEW}, payload torch; crash and "
          f"recover; a subprocess kill; the reference's traces")
    t_phase = time.perf_counter()
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    rmsnorm.launches = flash_attention.launches = 0
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-live-"))
    sc = Scenario(n_batches=LIVE_B, cancel_redundant=True)
    jobs = [LiveJob(job_id=i, costs=(LIVE_COST,) * LIVE_TASKS, skew=LIVE_SKEW,
                    name=f"bench-{i}", payload="torch") for i in range(LIVE_JOBS)]
    try:
        # -- the live run (journaled: it is also the recovery's uninterrupted run)
        plain_journal = str(tmp / "plain.jsonl")
        t0 = time.perf_counter()
        report = Runtime(LIVE_N, sc, journal=plain_journal, device="cuda").run(
            jobs, timeout_s=300.0)
        live_wall = time.perf_counter() - t0
        events = read_journal(plain_journal)
        check(events == json.loads(json.dumps(list(report.trace))), "journal != live trace")
        check(report.records[0].replication == LIVE_N // LIVE_B, "replication")
        _twin_exact(report, events, "live run")
        live_makespan = max(r.finish for r in report.records)
        batch_cost = LIVE_COST * (LIVE_TASKS // LIVE_B)
        predicted = ClusterEngine(LIVE_N, seed=0, n_batches=LIVE_B, cancel_redundant=True,
                                  size_dependent=False).run(
            [Job(job_id=j.job_id, dist=_Deterministic(batch_cost), n_tasks=LIVE_TASKS)
             for j in jobs])
        predicted_makespan = max(r.finish for r in predicted.records)
        print(f"live run: live_makespan_s {live_makespan!r}, predicted_makespan_s "
              f"{predicted_makespan!r}, live_over_predicted "
              f"{live_makespan / predicted_makespan!r}; wall {live_wall:.4f} s; "
              f"{len(events)} trace events; twin exact; accounting {report.accounting()}",
              flush=True)
        print(f"  {_live_breakdown(events)}", flush=True)

        # -- one job of it under the profiler: the card's busy share, steps
        one: list = []
        counts: dict = {}
        wall_ms, by_name = profile_device(
            lambda: one.append(Runtime(LIVE_N, sc, device="cuda").run(jobs[:1], timeout_s=120.0)),
            counts=counts, cpu=False)
        _twin_exact(one[0], one[0].trace, "profiled run")
        busy_ms = sum(by_name.values()) / 1e3
        copies = sum(n for name, n in counts.items() if "DtoH" in name)
        steps = copies - LIVE_N  # one synchronising copy a step; each worker's warm-up step
        ws = one[0].worker_seconds
        share = f"{busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
        alone = asyncio.run(run_payload("torch", (LIVE_COST,), 1.0, "cuda"))
        print(f"profiled one-job run (thread start and registration included): wall "
              f"{wall_ms:.1f} ms, card busy {busy_ms:.2f} ms, busy share {share}; "
              f"{sum(counts.values())} kernels and copies, {steps} payload steps over "
              f"{ws!r} worker-seconds: {steps * LIVE_COST / ws:.1f} steps per {LIVE_COST} s "
              f"task; one task alone on the card: {alone} steps "
              f"({LIVE_COST * 1e3 / alone:.4f} ms a step)", flush=True)

        # -- crash at half the plain makespan, recover from the journal, resume
        crash_journal = str(tmp / "crash.jsonl")

        async def join_threads(threads):
            loop = asyncio.get_running_loop()
            for t in threads:
                await loop.run_in_executor(None, t.join, 10.0)
            check(not any(t.is_alive() for t in threads), "a worker thread outlived its run")

        async def crashed_run():
            master = RuntimeMaster(LIVE_N, sc, journal=crash_journal)
            port = await master.start()
            threads = [spawn_worker_thread(master.host, port, "cuda") for _ in range(LIVE_N)]
            await master.wait_for_workers(60.0)
            run_task = asyncio.ensure_future(master.run(list(jobs), timeout_s=300.0))
            await asyncio.sleep(0.5 * live_makespan)
            check(not run_task.done(), "the workload beat the crash timer")
            run_task.cancel()
            try:
                await run_task
            except asyncio.CancelledError:
                pass
            alive = [w.wid for w in master.workers if w.alive]
            n_before = len(master.recorder.events)
            await master.crash()
            await join_threads(threads)
            master = RuntimeMaster.recover(crash_journal)
            port = await master.start()
            threads = [spawn_worker_thread(master.host, port, "cuda") for _ in range(LIVE_N)]
            try:
                rec = await master.resume(timeout_s=300.0)
            finally:
                await master.close()
                await join_threads(threads)
            return rec, alive, n_before

        t0 = time.perf_counter()
        recovered, alive, n_before = asyncio.run(crashed_run())
        recovered_wall = time.perf_counter() - t0
        events = read_journal(crash_journal)
        check(events == json.loads(json.dumps(list(recovered.trace))), "journal != trace")
        _twin_exact(recovered, events, "crash and recover")
        seam = events[n_before: n_before + len(alive) + 1]
        check([(e["ev"], e.get("wid"), e.get("cause")) for e in seam]
              == [("fail", w, "crash") for w in alive] + [("recover", None, None)],
              f"the crash seam: {seam}")
        check(bool(alive), "the crash struck no live worker")
        check(all(r.finish < math.inf for r in recovered.records)
              and len(recovered.records) == LIVE_JOBS, "a job did not complete after recovery")
        recovered_makespan = max(r.finish for r in recovered.records)
        print(f"crash at {0.5 * live_makespan:.4f} s, recovered: recovered_makespan_s "
              f"{recovered_makespan!r}, recovery_overhead "
              f"{recovered_makespan / live_makespan!r}; wall {recovered_wall:.4f} s; "
              f"{len(alive)} crash fails and the recover seam; journal replays exactly",
              flush=True)
        print(f"  {_live_breakdown(events)}", flush=True)

        # -- SIGKILL a subprocess worker mid-torch-task on the card
        async def proc_kill():
            master = RuntimeMaster(2, Scenario(n_batches=2), heartbeat_s=0.05,
                                   heartbeat_timeout_s=5.0)
            port = await master.start()
            procs = [spawn_worker_subprocess(master.host, port, "cuda") for _ in range(2)]
            try:
                t_start = time.perf_counter()
                await master.wait_for_workers(120.0)
                start_s = time.perf_counter() - t_start
                argvs = [_cmdline(w.pid) for w in master.workers]
                run_task = asyncio.ensure_future(master.run(
                    [LiveJob(job_id=0, costs=LIVE_PROC_COSTS, payload="torch")], timeout_s=120.0))
                victim = None
                for _ in range(2000):
                    victim = next((e["wid"] for e in master.recorder.events
                                   if e["ev"] == "dispatch" and e["batch"] == 1), None)
                    if victim is not None and (master.workers[victim].progress or 0.0) > 0.0:
                        break
                    await asyncio.sleep(0.01)
                check(victim is not None and master.workers[victim].progress > 0.0,
                      "the victim never reported progress on its torch task")
                os.kill(master.workers[victim].pid, signal.SIGKILL)
                rep = await run_task
            finally:
                await master.close()
                for p in procs:
                    try:
                        p.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait(timeout=10.0)
            return rep, victim, argvs, start_s

        killed, victim, argvs, start_s = asyncio.run(proc_kill())
        check(all(a[1:3] == ["-m", "repro_torch.cluster.runtime"] and "cuda" in a
                  for a in argvs), f"the spawned workers are not the port's: {argvs}")
        fails = [e for e in killed.trace if e["ev"] == "fail"]
        check([(e["wid"], e["cause"]) for e in fails] == [(victim, "eof")], f"fails {fails}")
        check((killed.n_worker_failures, killed.n_replicas_rescued) == (1, 1), "no rescue")
        check(killed.records[0].finish < math.inf, "the killed run did not complete")
        _twin_exact(killed, killed.trace, "subprocess kill")
        print(f"subprocess kill: 2 workers on the card registered in {start_s:.2f} s; wid "
              f"{victim} SIGKILLed mid-task, batch 1 rescued, finish "
              f"{killed.records[0].finish!r} s; twin exact", flush=True)

        # -- the reference's traces through the port's engine
        bad = golden_mismatches(replay_trace, GOLDEN_RUNTIME)
        check(bad == [], f"golden runtime traces: {bad}")
        n_golden = len(json.loads(GOLDEN_RUNTIME.read_text())["traces"])
        print(f"{GOLDEN_RUNTIME.relative_to(ROOT)}: {n_golden} reference traces replay exactly "
              "through the port's engine", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    check(got == {"draws": 0, "philox": 0} and rmsnorm.launches == 0
          and flash_attention.launches == 0, f"a kernel ran in the live phase: {got}")
    print(f"live runtime phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return got


def phase_fifo() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster.vectorized import simulate_fifo
    from repro_torch.core import analysis
    from repro_torch.core.service_time import Exponential
    from repro_torch.kernels import cover

    n, b, n_jobs, reps = FIFO_N, FIFO_B, FIFO_JOBS, N_REPS
    phase(f"simulate_fifo: N={n} B={b}, {n_jobs} jobs, {reps} reps")
    dist = Exponential(mu=1.0)
    arrivals = np.arange(n_jobs) * 2.0
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    t0 = time.perf_counter()
    on = simulate_fifo(dist, n, b, arrivals, reps, seed=SEED + 1, cancel_redundant=True)
    off = simulate_fifo(dist, n, b, arrivals, reps, seed=SEED + 1, cancel_redundant=False)
    wall = time.perf_counter() - t0
    launches = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    print(f"two runs in {wall:.3f} s; cover launches by kernel {launches}")
    check(launches == {"draws": 2, "philox": 0},
          f"expected 2 kernel-A cover launches, saw {launches}")
    for rep in (on, off):
        check(np.isfinite(rep.finishes).all(), "non-finite finish times")
    check(np.array_equal(on.compute_times, off.compute_times), "same seed, other compute times")
    check(np.allclose(on.worker_seconds + on.cancelled_seconds_saved, off.worker_seconds,
                      rtol=1e-5), "worker_seconds(on) + saved != worker_seconds(off)")
    check((on.cancelled_seconds_saved > 0).all() and (off.cancelled_seconds_saved == 0).all(),
          "cancellation saved nothing, or saved without cancelling")
    check(on.response_times.mean() < off.response_times.mean(), "cancelling did not help")
    ct = on.compute_times.ravel()
    want = analysis.mean_T(dist, n, b)
    z = abs(ct.mean() - want) / (ct.std() / math.sqrt(ct.size))
    check(z <= 3.0, f"compute-time mean {ct.mean()} vs closed form {want} (z={z:.2f})")
    print(f"invariant holds; compute-time mean {ct.mean():.6f} vs closed form {want:.6f} "
          f"(z={z:.3f}); mean response on {on.response_times.mean():.4f} "
          f"off {off.response_times.mean():.4f}")
    return launches


def check_cover_grids(shapes, dtype) -> None:
    """Kernel A bitwise equal to its plain version on exponential draws at each
    ``(rows, B, r)`` grid, unmasked, as ``gang_cover_times`` hands it over."""
    import torch

    from repro_torch.kernels import cover

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for rows, b, r in shapes:
        x = torch.empty((rows, b, r), dtype=dtype, device="cuda").exponential_(generator=gen)
        same, _ = bitwise_equal(cover.masked_cover_times(x, b, r),
                                cover.masked_cover_times_ref(x, b, r))
        check(same, f"kernel A {dtype} ({rows}, {b}, {r}) differs from its plain version")
    print(f"kernel A bitwise equal to its plain version at {len(shapes)} grid(s) {dtype}: "
          f"{shapes[:4]}{' ...' if len(shapes) > 4 else ''}")


def _z(a, b) -> float:
    """|mean(a) - mean(b)| over the standard error of the difference."""
    return abs(a.mean() - b.mean()) / math.sqrt(a.var() / a.size + b.var() / b.size)


def phase_schemes() -> dict:
    import numpy as np
    import torch

    from repro_torch.core import analysis, batching, simulator
    from repro_torch.core.service_time import Exponential, ShiftedExponential
    from repro_torch.kernels import cover

    n, b, reps = SCHEME_N, SCHEME_B, SCHEME_SAMPLES
    phase(f"batching schemes: simulate_membership at N={n} B={b} (s = r = {n // b}), "
          f"{reps} samples, Exp(1), float32")
    dist = Exponential(mu=1.0)
    schemes = {name: getattr(batching, name)(n, b)
               for name in ("non_overlapping", "hybrid", "cyclic")}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    cover.launches = cover.draws_launches = cover.philox_launches = 0
    t0 = time.perf_counter()
    times = {name: simulator.simulate_membership(gen(SEED + i), dist, m, reps)
             for i, (name, m) in enumerate(schemes.items())}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    chunk = max(1, simulator._MEMBERSHIP_CHUNK_ELEMENTS // (n * (n // b)))
    want = {"draws": len(schemes) * -(-reps // chunk), "philox": 0}
    print(f"three schemes in {wall:.3f} s; cover launches by kernel {launches} "
          f"({-(-reps // chunk)} chunks of at most {chunk} samples a scheme)")
    check(launches == want, f"expected {want}, saw {launches}")
    for name, t in times.items():
        check(t.shape == (reps,) and bool(np.isfinite(t).all()) and bool((t > 0).all()),
              f"{name}: job times not finite and positive")
    t3 = times["non_overlapping"].astype(np.float64)
    closed = analysis.mean_T(dist, n, b)
    z = abs(t3.mean() - closed) / (t3.std() / math.sqrt(t3.size))
    check(z <= 3.0, f"non_overlapping mean {t3.mean()} vs closed form {closed} (z={z:.2f})")
    means = {name: float(t.mean()) for name, t in times.items()}
    order = " < ".join(f"{k} {v:.6f}" for k, v in sorted(means.items(), key=lambda kv: kv[1]))
    print(f"non_overlapping mean {t3.mean():.6f} vs closed form {closed:.6f} (z={z:.3f}); "
          f"ordering at N={n}: {order}")

    # the kernel on the main path's grids: the same seeded draws through the
    # membership cover on the card and on the CPU, bitwise
    for i, (name, m) in enumerate(schemes.items()):
        draws = dist.sample(gen(SEED + i), (reps, n), torch.device("cuda"), torch.float32)
        draws = draws * torch.as_tensor(m.sum(axis=1), dtype=torch.float32, device="cuda")
        card = simulator.membership_cover_times(draws, m)
        same, _ = bitwise_equal(card.cpu(), simulator.membership_cover_times(draws.cpu(), m))
        check(same, f"{name}: membership cover on the card differs from the CPU")
        check(np.array_equal(card.cpu().numpy(), times[name]),
              f"{name}: simulate_membership differs from its own draws' cover")
    print(f"membership cover on the card bitwise equal to the CPU for all three schemes "
          f"({reps} x {n} times)")

    # Fig. 6 at (6, 3) and (12, 4): non-overlapping beats both overlapping
    # schemes; hybrid deals the cyclic batches (a row permutation), so their
    # means agree in law
    for (nn, bb), law in [((6, 3), dist), ((6, 3), ShiftedExponential(0.2, 2.0)),
                          ((12, 4), dist)]:
        t = {name: simulator.simulate_membership(
                gen(SEED + 10 + k), law, getattr(batching, name)(nn, bb), ORDER_SAMPLES
             ).astype(np.float64)
             for k, name in enumerate(("cyclic", "hybrid", "non_overlapping"))}
        e1, e2, e3 = (t[k].mean() for k in ("cyclic", "hybrid", "non_overlapping"))
        z31, z32, z12 = (_z(t["non_overlapping"], t["cyclic"]),
                         _z(t["non_overlapping"], t["hybrid"]), _z(t["cyclic"], t["hybrid"]))
        check(e3 < e2 and e3 < e1 and z31 > 3.0 and z32 > 3.0,
              f"({nn}, {bb}) {law}: non-overlapping {e3} not below hybrid {e2} and cyclic {e1}")
        check(z12 < 4.0, f"({nn}, {bb}) {law}: hybrid {e2} and cyclic {e1} differ (z={z12:.2f})")
        print(f"({nn}, {bb}) {type(law).__name__}: E[T3] non_overlapping {e3:.6f} < E[T2] hybrid "
              f"{e2:.6f} (z={z32:.1f}), E[T1] cyclic {e1:.6f} (z={z31:.1f}); hybrid vs cyclic "
              f"z={z12:.2f}", flush=True)
    return launches


def phase_stream() -> dict:
    import numpy as np
    import torch

    from repro_torch.cluster import Scenario, fold_stream_stats, simulate_stream
    from repro_torch.cluster.stream import _ACC_FIELDS, _CLASS_FIELDS
    from repro_torch.core import traces
    from repro_torch.kernels import cover

    phase(f"simulate_stream: the golden cluster-day, {DAY_JOBS} jobs on {DAY_WORKERS} workers "
          f"({DAY_WORKERS // DAY_POOL} packed pools of {DAY_POOL}), B={DAY_B}, {DAY_REPS} reps, "
          f"slab {DAY_SLAB}, float32")
    day = traces.synthetic_cluster_day(n_jobs=DAY_JOBS, duration=DAY_SECONDS, seed=DAY_SEED)

    def run(stream, **kw):
        sc = Scenario(scheduler="packed", workers_per_job=DAY_POOL, cancel_redundant=True, **kw)
        return simulate_stream(stream, DAY_WORKERS, DAY_B, DAY_REPS, scenario=sc, slab=DAY_SLAB)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    t0 = time.perf_counter()
    stats = run(day, outputs="stream")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    n_slabs = -(-DAY_JOBS // DAY_SLAB)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"cluster-day in {wall:.4f} s, {wall * 1e3 / DAY_JOBS:.5f} ms per job step (host "
          f"clock, host draws included); cover launches by kernel {launches}; peak device "
          f"memory {peak / 1e6:.3f} MB above its {base / 1e6:.3f} MB start")
    check(launches == {"draws": n_slabs, "philox": 0},
          f"expected {n_slabs} kernel-A launches (one per slab), saw {launches}")
    golden = json.loads(GOLDEN_DAY.read_text())
    summary = stats.summary()
    check(set(summary) == set(golden), f"summary keys {sorted(summary)} vs {sorted(golden)}")
    check(summary["n_jobs_done"] == golden["n_jobs_done"] == DAY_JOBS * DAY_REPS,
          f"n_jobs_done {summary['n_jobs_done']} vs {golden['n_jobs_done']}")
    worst = 0.0
    for k, want in golden.items():
        rel = abs(summary[k] - want) / abs(want) if want else abs(summary[k])
        worst = max(worst, rel)
        check(rel <= 1e-5, f"golden day {k}: {summary[k]} vs {want} (relative {rel:.3e})")
    print(f"summary matches {GOLDEN_DAY.relative_to(ROOT)} (max relative difference "
          f"{worst:.3e}, limit 1e-5): {json.dumps(summary)}")

    # where a slab's time goes: the card's idle share over one slab of the day
    one = traces.TraceStream(day.arrivals[:DAY_SLAB], day.job_ids[:DAY_SLAB], day.sources,
                             day.seed)
    run(one, outputs="stream")  # warm
    t0 = time.perf_counter()
    run(one, outputs="stream")
    torch.cuda.synchronize()
    slab_ms = (time.perf_counter() - t0) * 1e3
    host: dict = {}
    wall_ms, by_name = profile_device(lambda: run(one, outputs="stream"), host)
    busy_ms = sum(by_name.values()) / 1e3
    idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
    print(f"one slab ({DAY_SLAB} jobs): {slab_ms:.4f} ms unprofiled, "
          f"{slab_ms / DAY_SLAB:.5f} ms per job step; profiled {wall_ms:.4f} ms, card busy "
          f"{busy_ms:.4f} ms, idle share {idle}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {us / 1e3:9.4f} ms  {name[:90]}")
    print("  host operators by own CPU time:")
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:9.4f} ms  {name[:90]}")

    # collect=True at slab 1024: the host fold of the per-job outputs equals
    # the accumulators the same run carried, and the streaming run's
    full = run(day, outputs="full")
    folded = fold_stream_stats(full.waits, full.t_job, full.busy_j, full.planned_j,
                               full.saved_j, class_ids=day.job_ids, classes=full.stats.classes)
    for f in _ACC_FIELDS + _CLASS_FIELDS:
        check(np.array_equal(getattr(folded, f), getattr(full.stats, f)),
              f"cluster-day {f}: fold of the full outputs differs from the carried accumulators")
        check(np.array_equal(getattr(stats, f), getattr(full.stats, f)),
              f"cluster-day {f}: outputs='stream' differs from outputs='full'")
    print(f"outputs='full' ({full.waits.shape} per-job arrays): fold_stream_stats equals the "
          "carried accumulators and the streaming run's, every field", flush=True)

    # kernel A against its plain version at the day's slab grid, as
    # gang_cover_times hands it over: (reps x slab, B, r), float32
    check_cover_grids([(DAY_REPS * DAY_SLAB, DAY_B, DAY_POOL // DAY_B)], torch.float32)

    # float64 on the card, bitwise the port's CPU run, in all four scheduler cases
    n_jobs, reps, n_workers, pool = 2000, 4, 120, 6
    small = traces.synthetic_cluster_day(n_jobs=n_jobs, duration=40.0 * n_jobs, seed=11)
    check_cover_grids([(reps * DAY_SLAB, 3, n_workers // 3), (reps * DAY_SLAB, 3, pool // 3)],
                      torch.float64)
    for sched, wpj, cancel in [("fifo_gang", None, True), ("fifo_gang", None, False),
                               ("packed", pool, True), ("balanced", pool, False)]:
        sc = Scenario(outputs="full", scheduler=sched, workers_per_job=wpj,
                      cancel_redundant=cancel, dtype="float64")
        t0 = time.perf_counter()
        card = simulate_stream(small, n_workers, 3, reps, scenario=sc, slab=DAY_SLAB)
        card_s = time.perf_counter() - t0
        cpu = simulate_stream(small, n_workers, 3, reps, scenario=sc, slab=DAY_SLAB, device="cpu")
        for f in _ACC_FIELDS + _CLASS_FIELDS:
            same = np.array_equal(getattr(card.stats, f).view(np.uint8),
                                  getattr(cpu.stats, f).view(np.uint8))
            check(same, f"float64 stream {sched} cancel={cancel}: {f} differs card vs CPU")
        for f in ("waits", "t_job", "busy_j", "planned_j", "saved_j"):
            check(np.array_equal(getattr(card, f).view(np.uint64), getattr(cpu, f).view(np.uint64)),
                  f"float64 stream {sched} cancel={cancel}: {f} differs card vs CPU")
        print(f"float64 {n_jobs} jobs x {reps} reps on {n_workers} workers, {sched} "
              f"(pool {wpj or n_workers}), cancel={cancel}: card bitwise equal to CPU "
              f"({card_s:.3f} s on the card)", flush=True)
    return launches


def phase_slo() -> dict:
    import torch

    from repro_torch.cluster import SLO, Scenario
    from repro_torch.core import RedundancyPlanner, traces
    from repro_torch.kernels import cover

    phase(f"plan_slo: N={SLO_N}, classes job1 + job6, p99 targets {SLO_TARGETS} at "
          f"{SLO_RATE} jobs/s, {SLO_JOBS} jobs, {SLO_REPS} reps, pool widths {SLO_WIDTHS}, "
          "float64")
    jobs = {j.name: j for j in traces.synthetic_google_jobs(2020)}
    workload = [jobs[name] for name in SLO_TARGETS]
    slos = tuple(SLO(quantile=0.99, target_s=t, arrival_rate=SLO_RATE, job_class=name)
                 for name, t in SLO_TARGETS.items())
    kw = dict(scenario=Scenario(size_dependent=False, dtype="float64"), n_jobs=SLO_JOBS,
              n_reps=SLO_REPS, seed=SEED, schedulers=("fifo_gang", "packed", "balanced"),
              pool_widths=SLO_WIDTHS)
    planner = RedundancyPlanner(SLO_N)
    cover.launches = cover.draws_launches = cover.philox_launches = 0
    t0 = time.perf_counter()
    plan = planner.plan_slo(workload, slos, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    n_cand = len(plan.candidates)
    want = {"draws": n_cand * -(-SLO_JOBS // 1024), "philox": 0}
    n_ok = sum(c.feasible for c in plan.candidates)
    print(f"{n_cand} candidates in {wall:.3f} s ({wall / n_cand:.4f} s per candidate); cover "
          f"launches by kernel {launches}; {n_ok} feasible; best {plan.best}")
    check(n_cand == 41, f"expected 41 candidates, saw {n_cand}")
    check(launches == want, f"expected {want} (one kernel-A launch per slab), saw {launches}")
    check(0 < n_ok < n_cand, f"{n_ok} of {n_cand} feasible: the grid should hold both kinds")
    # kernel A against its plain version at every slab grid of the sweep
    grids = sorted({(SLO_REPS * 1024, c.n_batches, c.replication) for c in plan.candidates})
    check_cover_grids(grids, torch.float64)
    t0 = time.perf_counter()
    cpu = planner.plan_slo(workload, slos, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    check(plan == cpu, "plan_slo on the card differs from the same call on the CPU")
    mean_opt = min(plan.candidates, key=lambda c: c.mean_response)
    print(f"the card's SLOPlan equals the CPU's ({cpu_s:.3f} s there), every candidate "
          f"bitwise; mean-optimal candidate {mean_opt.scheduler}/{mean_opt.workers_per_job}/"
          f"B={mean_opt.n_batches}", flush=True)
    return launches


def _randn(torch, shape, dtype, seed, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def phase_rmsnorm_vs_plain() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch._device import time_on_card
    from repro_torch.kernels import rmsnorm

    phase("RMSNorm kernel vs plain version (TOL and ROW_RTOL, on the card)")
    rows, d = SERVE_PROMPT, 1536  # a qwen2-1.5b prefill: 1024 tokens of d_model 1536
    max_err, record = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for shape in [(rows, d), (1, d)]:  # prefill and decode
            x = _randn(torch, shape, dtype, SEED)
            for w_dtype in (dtype, torch.float32):  # the final norm keeps a float32 weight
                w = _randn(torch, (d,), w_dtype, SEED + 1, 0.1)
                for plus_one in (False, True):
                    got = rmsnorm.rms_norm_fused(x, w, plus_one=plus_one)
                    want = rmsnorm.rms_norm_ref(x, w, plus_one=plus_one)
                    what = f"rmsnorm {name} {shape} w {w_dtype} plus_one={plus_one}"
                    ok, err = close_to(got, want, name)
                    max_err = max(max_err, err)
                    check(ok, f"{what}: max |err| {err} beyond TOL {TOL[name]}")
                    ok, row = close_by_row(got, want, name)
                    check(ok, f"{what}: beyond ROW_RTOL ({row})")
        x = _randn(torch, (rows, d), dtype, SEED)
        w = _randn(torch, (d,), dtype, SEED + 1, 0.1)
        ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(x, w), iters=50)
        call_ms = time_on_card(lambda: rmsnorm.rms_norm_fused(x, w), iters=50)
        plain_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(x, w), iters=50)
        lib_ms = device_ms_per_call(lambda: F.rms_norm(x, (d,), w, eps=1e-6), iters=50) \
            if hasattr(F, "rms_norm") else None
        n_bytes = 2 * x.numel() * x.element_size() + d * w.element_size()
        bnd, by = bound_ms(n_bytes, 4 * x.numel(), CARD_F32_FLOP_PER_S)
        lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "not available"
        print(f"{name}: ({rows}, {d}) within TOL; device time per call: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, F.rms_norm {lib}; bound {bnd:.5f} ms ({by}), kernel "
              f"at {bnd / ms:.1%} of bound; back-to-back wrapper calls (CUDA events, host "
              f"launch cost included) {call_ms:.5f} ms", flush=True)
        dx = _randn(torch, (1, d), dtype, SEED)
        d_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(dx, w), iters=50)
        d_plain = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(dx, w), iters=50)
        d_lib = device_ms_per_call(lambda: F.rms_norm(dx, (d,), w, eps=1e-6), iters=50) \
            if hasattr(F, "rms_norm") else None
        d_bnd, d_by = bound_ms(2 * dx.numel() * dx.element_size() + d * w.element_size(),
                               4 * dx.numel(), CARD_F32_FLOP_PER_S)
        d_lib_s = f"{d_lib:.5f} ms" if d_lib is not None else "not available"
        print(f"{name}: decode (1, {d}) device time per call: kernel {d_ms:.5f} ms, plain "
              f"{d_plain:.5f} ms, F.rms_norm {d_lib_s}; bound {d_bnd:.5f} ms ({d_by})")
        if dtype == torch.bfloat16:  # the served path's dtype
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                      "library_ms": lib_ms,
                      "decode": {"ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bnd,
                                 "bound_by": d_by, "library_ms": d_lib}}
    record["max_abs_err"] = max_err
    return record


def _visible_pairs(torch, q_pos, kv_pos, causal, window) -> int:
    # (B, Sq, Sk): without a causal or window term the mask must still span the queries
    mask = (kv_pos[:, None, :] >= 0).expand(q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1])
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return int(mask.sum())


def _attention_bound(torch, q, k, q_pos, kv_pos, causal, window) -> tuple[float, str]:
    """q, k, v read once, o written once, positions read once; 4 * hd flops per
    visible (query, key) pair and query head, at the rate of the inputs' type."""
    b, sq, h, hd = q.shape
    n_bytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() \
        + 4 * (q_pos.numel() + kv_pos.numel())
    n_ops = 4.0 * hd * h * _visible_pairs(torch, q_pos, kv_pos, causal, window)
    rate = CARD_BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else CARD_F32_FLOP_PER_S
    return bound_ms(n_bytes, n_ops, rate)


def _sdpa_ms(torch, q, k, v, causal, iters, mask=None):
    """Device time of one scaled_dot_product_attention call on (B, H, S, hd)
    copies, GQA by enable_gqa where this torch has it, else on repeated kv
    heads; with ``mask`` (B, Sq, Sk: visible pairs) in place of ``causal``."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = {"is_causal": causal} if mask is None else {"attn_mask": mask[:, None]}
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        kw["enable_gqa"] = True
    except TypeError:
        g = qt.shape[1] // kt.shape[1]
        kt, vt = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1)
    return device_ms_per_call(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
                              iters=iters)


def _ring_positions(torch, w, t, n_written):
    pos = torch.full((w,), -1, dtype=torch.int32)
    for p in range(t - n_written + 1, t + 1):
        pos[p % w] = p
    return pos.cuda()[None]


def _attention_path(flash, before) -> str:
    """Which attention kernel ran since the per-kernel counts were ``before``."""
    after = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
    ran = [name for name, a, b in zip(("splitkv", "wgmma", "simt"), after, before) if a != b]
    return ran[0] if len(ran) == 1 else f"{ran}"


def _zoo_attention_cases() -> list:
    """Each served zoo family's attention as its served path calls it, in
    phase_attention_vs_plain's case form: the prefill over the prompt's own
    keys, and the last decode step against the full ring of prompt + gen slots
    (the window's, where shorter)."""
    from repro_torch.models import transformer

    n_ctx = SERVE_PROMPT + ZOO_GEN
    cases = []
    for arch in [a for a, _ in ZOO_SERVED] + [ZOO_ENCODER]:
        cfg = _zoo_config(arch)
        if cfg.family == "ssm":  # no attention
            continue
        lay = transformer._layout(cfg)
        head = (lay.h_pad, lay.k_pad, cfg.head_dim)
        cases.append((f"{arch} prefill", *head, SERVE_PROMPT, SERVE_PROMPT, cfg.is_causal,
                      cfg.window, None))
        if cfg.is_causal:  # the encoder does not decode
            slots = min(n_ctx, cfg.window) if cfg.window else n_ctx
            cases.append((f"{arch} decode", *head, 1, slots, True, cfg.window, (slots, n_ctx)))
    return cases


def phase_attention_vs_plain() -> dict:
    import torch

    from repro_torch._device import time_on_card
    from repro_torch.kernels import flash_attention as flash

    phase("flash-attention kernels vs plain version (TOL and ROW_RTOL, on the card), the "
          "model zoo's shapes included")
    max_err, record = 0.0, {"zoo": {}}
    w_cache = SERVE_PROMPT + SERVE_GEN
    # (label, H, KH, hd, Sq, Sk, causal, window, kv positions): None = arange
    # prompt; ("prompt", n) = a prompt of n tokens in the first n of Sk slots,
    # the rest -1; (slots, n) = one new token at n - 1 against a ring
    cases = [
        ("qwen2 prefill", 12, 2, 128, SERVE_PROMPT, w_cache, True, None, ("prompt", SERVE_PROMPT)),
        ("qwen2 prefill, arange", 12, 2, 128, SERVE_PROMPT, SERVE_PROMPT, True, None, None),
        ("qwen2 decode", 12, 2, 128, 1, w_cache, True, None, (w_cache, SERVE_PROMPT + 6)),
        ("gemma hd 256 prefill", 16, 16, 256, 256, 256, True, None, None),
        ("gemma hd 256 decode", 16, 16, 256, 1, 300, True, None, (300, 280)),
        ("window 128", 8, 2, 128, 512, 512, True, 128, None),
        ("window 128 decode, wrapped ring", 8, 2, 128, 1, 128, True, 128, (128, 700)),
    ] + _zoo_attention_cases()
    timed = ("qwen2 prefill, arange", "qwen2 decode", f"{ZOO_ENCODER} prefill")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        worst_row = 0.0
        for label, h, kh, hd, sq, sk, causal, window, ring in cases:
            q = _randn(torch, (1, sq, h, hd), dtype, SEED + 2)
            k = _randn(torch, (1, sk, kh, hd), dtype, SEED + 3)
            v = _randn(torch, (1, sk, kh, hd), dtype, SEED + 4)
            if ring is None:  # a prompt: positions arange
                q_pos = torch.arange(sq, dtype=torch.int32, device="cuda")[None]
                kv_pos = torch.arange(sk, dtype=torch.int32, device="cuda")[None]
            elif ring[0] == "prompt":  # the served prefill: the cache's tail unwritten
                q_pos = torch.arange(sq, dtype=torch.int32, device="cuda")[None]
                kv_pos = _ring_positions(torch, sk, ring[1] - 1, ring[1])
            else:  # one new token at t against a ring of sk slots, n written
                t = ring[1] - 1
                kv_pos = _ring_positions(torch, sk, t, min(ring[1], sk))
                q_pos = torch.full((1, 1), t, dtype=torch.int32, device="cuda")
            want = flash.attention_ref(q, k, v, q_pos, kv_pos, causal, window)
            before = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
            got = flash.attention(q, k, v, q_pos, kv_pos, causal, window)
            path = _attention_path(flash, before)
            ok, err = close_to(got, want, name)
            max_err = max(max_err, err)
            check(ok, f"attention {name} {label}: max |err| {err} beyond TOL {TOL[name]}")
            ok, row = close_by_row(got, want, name)
            worst_row = max(worst_row, row)
            check(ok, f"attention {name} {label}: |err| / (|want| + row RMS) reaches {row}, "
                      f"beyond ROW_RTOL {ROW_RTOL[name]}")
            # the bound's power: the plain result with one 64-slot tile hidden,
            # in the middle of the keys, fails it
            mid = sk // 2 // 64 * 64
            hidden = kv_pos.clone()
            hidden[:, mid: mid + 64] = -1
            dropped = flash.attention_ref(q, k, v, q_pos, hidden, causal, window)
            check(not close_by_row(dropped, want, name)[0],
                  f"attention {name} {label}: ROW_RTOL passes a result with 64 keys dropped")
            want_path = "splitkv" if sq == 1 else ("wgmma" if dtype == torch.bfloat16 else "simt")
            check(path == want_path, f"attention {name} {label} ran {path}, not {want_path}")
            if ring is None:  # the Pallas-signature entry, (B, H, S, hd) through its strides
                got = flash.flash_attention_fwd(*(t_.transpose(1, 2) for t_ in (q, k, v)),
                                                causal=causal, window=window).transpose(1, 2)
                ok, err = close_to(got, want, name)
                max_err = max(max_err, err)
                check(ok, f"flash_attention_fwd {name} {label}: max |err| {err} beyond TOL")
                ok, row = close_by_row(got, want, name)
                worst_row = max(worst_row, row)
                check(ok, f"flash_attention_fwd {name} {label}: beyond ROW_RTOL ({row})")
            shapes = f"q {tuple(q.shape)} kv {tuple(k.shape)}"
            if label in timed:
                ms = device_ms_per_call(
                    lambda: flash.attention(q, k, v, q_pos, kv_pos, causal, window), iters=20)
                call_ms = time_on_card(
                    lambda: flash.attention(q, k, v, q_pos, kv_pos, causal, window), iters=20)
                plain_ms = device_ms_per_call(
                    lambda: flash.attention_ref(q, k, v, q_pos, kv_pos, causal, window), iters=5)
                # the same function in one library call: top-left causal for the
                # prompt (the unwritten tail lies past every query), the
                # positions' mask for decode
                mask = None if sq > 1 else flash._visible(q_pos, kv_pos, causal, window)
                lib_ms = _sdpa_ms(torch, q, k, v, causal=causal and sq > 1, iters=20, mask=mask)
                bnd, by = _attention_bound(torch, q, k, q_pos, kv_pos, causal, window)
                cold_ms = kernel_ms_cold(
                    lambda: flash.attention(q, k, v, q_pos, kv_pos, causal, window), path)
                print(f"{name}: {label} {shapes} within TOL on {path}; device time per call: "
                      f"kernel {ms:.5f} ms ({cold_ms:.5f} ms with L2 flushed before each call), "
                      f"plain {plain_ms:.5f} ms, SDPA {lib_ms:.5f} ms; bound {bnd:.5f} ms "
                      f"({by}), kernel at {bnd / ms:.2%} of bound; back-to-back wrapper calls "
                      f"{call_ms:.5f} ms  [{CARD}]", flush=True)
                if sq == 1 and dtype == torch.bfloat16:
                    # the split count: slots a split at least (16 is the wrapper's)
                    sweep = []
                    for min_keys in (16, 32, 64):
                        flash.SPLITKV_MIN_KEYS = min_keys
                        split_ms = device_ms_per_call(
                            lambda: flash.attention(q, k, v, q_pos, kv_pos, causal, window),
                            iters=20)
                        sweep.append(f"{flash.splitkv_plan(1, kh, sk, 132)[0]} splits "
                                     f"{split_ms:.5f} ms")
                    flash.SPLITKV_MIN_KEYS = 16
                    print(f"{name}: {label} by split count (132 SMs): {'; '.join(sweep)}")
                if dtype == torch.bfloat16:
                    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                           "library_ms": lib_ms}
                    if label.startswith(ZOO_ENCODER):
                        record["zoo"]["hubert prefill"] = dict(rec, shape=list(q.shape))
                    else:
                        record["prefill" if sq > 1 else "decode"] = rec
            elif dtype == torch.bfloat16 and label.startswith(tuple(a for a, _ in ZOO_SERVED)):
                ms = device_ms_per_call(
                    lambda: flash.attention(q, k, v, q_pos, kv_pos, causal, window), iters=20)
                bnd, by = _attention_bound(torch, q, k, q_pos, kv_pos, causal, window)
                print(f"{name}: {label} {shapes} within TOL on {path}; device time per call: "
                      f"kernel {ms:.5f} ms; bound {bnd:.5f} ms ({by}), kernel at "
                      f"{bnd / ms:.2%} of bound  [{CARD}]", flush=True)
            else:
                print(f"{name}: {label} {shapes} within TOL on {path}")
            del q, k, v, want, got, dropped
        print(f"{name}: every case within ROW_RTOL {ROW_RTOL[name]}: the largest |err| / "
              f"(|want| + row RMS) {worst_row:.3e}; a 64-key tile dropped fails it in every case")
        torch.cuda.empty_cache()
    out = dict(record["prefill"], decode=record["decode"], zoo=record["zoo"])
    out["max_abs_err"] = max_err
    return out


class _Tee(io.TextIOBase):
    """Writes through to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def phase_serve() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cover, flash_attention, rmsnorm
    from repro_torch.launch import serve

    cfg = get_config(SERVE_ARCH)
    phase(f"serving path: launch.serve.main, {SERVE_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), {SERVE_REQUESTS} requests, prompt {SERVE_PROMPT}, gen {SERVE_GEN}")
    argv = ["--arch", SERVE_ARCH, "--requests", str(SERVE_REQUESTS),
            "--prompt-len", str(SERVE_PROMPT), "--gen", str(SERVE_GEN),
            "--workers", str(SERVE_WORKERS), "--seed", str(SEED)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = serve.main(argv)
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.launches, "flash_attention": flash_attention.launches,
                "masked_cover": cover.launches}
    by_kernel = {"splitkv": flash_attention.splitkv_launches,
                 "wgmma": flash_attention.wgmma_launches,
                 "simt": flash_attention.simt_launches}
    cover_by_kernel = {"draws": cover.draws_launches, "philox": cover.philox_launches}
    check(rc == 0, f"serve.main returned {rc}")
    forwards = SERVE_REQUESTS * (1 + SERVE_GEN)
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * forwards,
            "flash_attention": cfg.n_layers * forwards, "masked_cover": 2}
    want_by_kernel = {"splitkv": cfg.n_layers * SERVE_REQUESTS * SERVE_GEN,
                      "wgmma": cfg.n_layers * SERVE_REQUESTS, "simt": 0}
    print(f"serve.main in {wall:.3f} s (weights made and cast included); launches {launches}, "
          f"expected {want} ({forwards} forwards); attention by kernel {by_kernel}, expected "
          f"{want_by_kernel}")
    check(launches == want, f"serving launches {launches}, expected {want}")
    check(by_kernel == want_by_kernel,
          f"serving attention by kernel {by_kernel}, expected {want_by_kernel}")
    # the planner's simulate_balanced draws with a torch.Generator: kernel A
    check(cover_by_kernel == {"draws": 2, "philox": 0},
          f"serving cover launches by kernel {cover_by_kernel}, expected 2 of kernel A")
    launches["flash_attention_by_kernel"] = by_kernel
    launches["masked_cover_by_kernel"] = cover_by_kernel
    out = tee.copy.getvalue()
    reqs = [tuple(map(float, m)) for m in re.findall(
        r"request \d+: ([\d.]+)ms \(prefill ([\d.]+)ms, decode ([\d.]+)ms/token\)", out)]
    check(len(reqs) == SERVE_REQUESTS, f"expected {SERVE_REQUESTS} request lines, saw {len(reqs)}")
    check("[plan]" in out, "no [plan] line")
    total, pre, dec = zip(*reqs)
    print(f"per request: {statistics.mean(total):.3f} ms mean ({min(total):.3f} to "
          f"{max(total):.3f}); prefill {statistics.mean(pre):.3f} ms mean; decode "
          f"{statistics.mean(dec):.3f} ms/token mean; the first request includes the warm-up")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    return launches


def phase_decode_profile() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    phase(f"one decode step of the served {SERVE_ARCH}: the card's idle share")
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    with torch.inference_mode():
        logits, cache, t = model.prefill(params, {"tokens": tokens}, SERVE_PROMPT + SERVE_GEN)
        check(logits.shape == (1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite of (1, {cfg.padded_vocab})")
        tok = logits.argmax(-1)[:, None].int()
        for _ in range(2):  # warm
            logits, cache, t = model.decode_step(params, cache, tok, t)
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok, t)
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3
        host: dict = {}
        counts: dict = {}
        wall_ms, by_name = profile_device(lambda: model.decode_step(params, cache, tok, t), host,
                                          counts)
    busy_ms = sum(by_name.values()) / 1e3
    idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
    print(f"decode step {plain_wall:.4f} ms unprofiled; profiled {wall_ms:.4f} ms, card busy "
          f"{busy_ms:.4f} ms, idle share {idle}")
    print("  device time by kernel:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3:9.4f} ms  {counts[name]:4d} launches, "
              f"{us / 1e3 / counts[name]:.5f} ms each  {name[:90]}")
    print(f"  host operators by own CPU time (sum {sum(host.values()) / 1e3:.4f} ms, the "
          "profiler's cost included):")
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.4f} ms  {name[:100]}")
    del params, cache
    torch.cuda.empty_cache()


def phase_cache_check() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer

    n_pre, n_dec = 8, 4
    phase(f"KV cache at full width: {SERVE_ARCH} float32, prefill {n_pre} + decode {n_dec} "
          "against teacher forcing (2e-3)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE_ARCH, compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (1, n_pre + n_dec), generator=gen, device="cuda",
                           dtype=torch.int32)
    worst = 0.0
    with torch.inference_mode():
        full, _, _ = transformer.forward(params, cfg, tokens=tokens)
        logits, cache, t = model.prefill(params, {"tokens": tokens[:, :n_pre]}, n_pre + n_dec)
        steps = [(logits, full[:, n_pre - 1])]
        for i in range(n_dec):
            logits, cache, t = model.decode_step(
                params, cache, tokens[:, n_pre + i: n_pre + i + 1], t)
            steps.append((logits, full[:, n_pre + i]))
        for i, (got, want) in enumerate(steps):
            err = (got - want).abs()
            ok = bool(torch.isfinite(got).all()) and bool((err <= 2e-3 + 2e-3 * want.abs()).all())
            worst = max(worst, float(err.max()))
            check(ok, f"step {i}: logits differ from teacher forcing by {float(err.max())}")
    print(f"prefill and {n_dec} decode steps match the teacher-forced forward: max |err| "
          f"{worst:.3e} over {cfg.padded_vocab} logits per step")
    del params, cache
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the model zoo: every serving family at full published width
# --------------------------------------------------------------------------


def _zoo_per_forward(cfg) -> tuple[int, int]:
    """(RMSNorm, attention) kernel launches of one forward of ``cfg``."""
    if cfg.family == "ssm":  # norm1 and the gated norm over d_inner a layer, the final norm
        return 2 * cfg.n_layers + 1, 0
    rms = 0 if cfg.norm_type == "layer" else 2 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_attn = (cfg.n_layers // len(pat)) * pat.count("attn") \
            + pat[: cfg.n_layers % len(pat)].count("attn")
        return rms, n_attn
    return rms, cfg.n_layers


def _zoo_config(arch: str, depth=None, **overrides):
    from repro_torch.configs import get_config

    cfg = get_config(arch, **overrides)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def _reset_counts() -> None:
    from repro_torch.kernels import cover, flash_attention, rmsnorm

    cover.launches = rmsnorm.launches = flash_attention.launches = 0
    cover.draws_launches = cover.philox_launches = 0
    flash_attention.splitkv_launches = flash_attention.wgmma_launches = 0
    flash_attention.simt_launches = 0


def _counts() -> dict:
    from repro_torch.kernels import cover, flash_attention, rmsnorm

    return {"rmsnorm": rmsnorm.launches, "flash_attention": flash_attention.launches,
            "masked_cover": cover.launches, "splitkv": flash_attention.splitkv_launches,
            "wgmma": flash_attention.wgmma_launches, "simt": flash_attention.simt_launches,
            "draws": cover.draws_launches, "philox": cover.philox_launches}


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_zoo_rmsnorm() -> dict:
    """RMSNorm at every width the zoo serves, prefill and decode rows, against
    its plain version within TOL and ROW_RTOL; timed at mamba2's d_inner 5120,
    the width that takes the kernel's scalar path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm

    phase(f"model zoo RMSNorm vs plain version at d {ZOO_NORM_WIDTHS} (TOL and ROW_RTOL, on "
          "the card)")
    out = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        worst_row = 0.0
        for d in ZOO_NORM_WIDTHS:
            for rows in (SERVE_PROMPT, 1):  # a prefill and a decode step
                x = _randn(torch, (rows, d), dtype, SEED + 7)
                for w_dtype in (dtype, torch.float32):  # the final norm keeps a float32 weight
                    w = _randn(torch, (d,), w_dtype, SEED + 8, 0.1)
                    for plus_one in (False, True):
                        got = rmsnorm.rms_norm_fused(x, w, plus_one=plus_one)
                        want = rmsnorm.rms_norm_ref(x, w, plus_one=plus_one)
                        what = f"rmsnorm {name} ({rows}, {d}) w {w_dtype} plus_one={plus_one}"
                        ok, err = close_to(got, want, name)
                        out["max_abs_err"] = max(out["max_abs_err"], err)
                        check(ok, f"{what}: max |err| {err} beyond TOL {TOL[name]}")
                        ok, row = close_by_row(got, want, name)
                        worst_row = max(worst_row, row)
                        check(ok, f"{what}: beyond ROW_RTOL ({row})")
                if dtype != torch.bfloat16 or d != ZOO_D_INNER:
                    continue
                w = _randn(torch, (d,), dtype, SEED + 8, 0.1)
                ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(x, w), iters=50)
                plain_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(x, w), iters=50)
                lib_ms = device_ms_per_call(lambda: F.rms_norm(x, (d,), w, eps=1e-6),
                                            iters=50) if hasattr(F, "rms_norm") else None
                bnd, by = bound_ms(2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                                   4 * x.numel(), CARD_F32_FLOP_PER_S)
                lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "not available"
                print(f"rmsnorm {name} ({rows}, {d}) device time per call: kernel {ms:.5f} ms, "
                      f"plain {plain_ms:.5f} ms, F.rms_norm {lib}; bound {bnd:.5f} ms ({by}), "
                      f"kernel at {bnd / ms:.1%} of bound  [{CARD}]", flush=True)
                out["prefill" if rows > 1 else "decode"] = {
                    "shape": [rows, d], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                    "bound_by": by, "library_ms": lib_ms}
        print(f"{name}: every width, row count, weight dtype and plus_one within TOL and "
              f"ROW_RTOL {ROW_RTOL[name]}: the largest |err| / (|want| + row RMS) {worst_row:.3e}")
    _free()
    return out


def phase_model_zoo() -> dict:
    """Serve each decoder family through ``launch.serve.serve`` at full width and
    run hubert-xlarge's forward, the launch counts checked family by family."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import build_model, transformer

    phase(f"model zoo: launch.serve.serve at full width, {ZOO_REQUESTS} requests, prompt "
          f"{SERVE_PROMPT}, gen {ZOO_GEN}, batch 1, bf16 weights; hubert-xlarge forward over "
          f"{SERVE_PROMPT} frames")
    t_phase = time.perf_counter()
    total = dict.fromkeys(_counts(), 0)
    for arch, depth in ZOO_SERVED:
        cfg = _zoo_config(arch, depth, param_dtype="bfloat16")
        rms_f, att_f = _zoo_per_forward(cfg)
        forwards = ZOO_REQUESTS * (1 + ZOO_GEN)
        want = {"rmsnorm": rms_f * forwards, "flash_attention": att_f * forwards,
                "masked_cover": 2, "splitkv": att_f * ZOO_REQUESTS * ZOO_GEN,
                "wgmma": att_f * ZOO_REQUESTS, "simt": 0, "draws": 2, "philox": 0}
        cut = f"{depth} of {_zoo_config(arch).n_layers} layers" if depth else \
            f"{cfg.n_layers} layers"
        print(f"-- {arch} ({cut}, d_model {cfg.d_model}): {rms_f} RMSNorm and {att_f} attention "
              f"launches a forward", flush=True)
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _reset_counts()
        records = serve.serve(cfg, requests=ZOO_REQUESTS, prompt_len=SERVE_PROMPT, gen=ZOO_GEN,
                              workers=SERVE_WORKERS, seed=SEED)
        got = _counts()
        wall = time.perf_counter() - t0
        check(got == want, f"{arch}: launches {got}, expected {want}")
        check(len(records) == ZOO_REQUESTS, f"{arch}: {len(records)} requests served")
        for key in total:
            total[key] += got[key]
        peak = torch.cuda.max_memory_allocated() / 1e9
        for r, (tot, pre, dec) in enumerate(records):
            print(f"{arch} request {r}: prefill {pre * 1e3:.3f} ms, decode {dec * 1e3:.3f} "
                  f"ms/token, total {tot * 1e3:.3f} ms  [{CARD}]")
        print(f"{arch}: launches as expected {got}; peak device memory {peak:.3f} GB; "
              f"serve in {wall:.3f} s (weights made included)  [{CARD}]", flush=True)

    cfg = _zoo_config(ZOO_ENCODER, param_dtype="bfloat16")
    rms_f, att_f = _zoo_per_forward(cfg)
    _free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    embeds = _randn(torch, (1, SERVE_PROMPT, cfg.d_model), torch.bfloat16, SEED + 12)
    with torch.inference_mode():
        transformer.forward(params, cfg, embeds=embeds)  # warm
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        logits, _, _ = transformer.forward(params, cfg, embeds=embeds)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _counts()
    want = dict.fromkeys(got, 0)
    want.update(rmsnorm=rms_f, flash_attention=att_f, wgmma=att_f)
    check(got == want, f"{ZOO_ENCODER}: launches {got}, expected {want}")
    check(logits.shape == (1, SERVE_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"{ZOO_ENCODER}: logits {tuple(logits.shape)} not finite")
    for key in total:
        total[key] += got[key]
    print(f"{ZOO_ENCODER} ({cfg.n_layers} layers, d_model {cfg.d_model}, 16 heads of 80, "
          f"non-causal): forward over {SERVE_PROMPT} frames {ms:.3f} ms (host clock to a "
          f"synchronise, warm); launches {got}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB  [{CARD}]", flush=True)
    del params, model, logits, embeds
    _free()
    print(f"model zoo serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase_zoo_decode_profile() -> None:
    """One profiled decode step of each served zoo family after a 1024-token
    prefill: the card's busy time and idle share, and where the device time goes."""
    import torch

    from repro_torch.models import build_model

    phase("model zoo: one profiled decode step of each served family (bf16, after a "
          f"{SERVE_PROMPT}-token prefill)")
    for arch, depth in ZOO_SERVED:
        cfg = _zoo_config(arch, depth, param_dtype="bfloat16")
        _free()
        model = build_model(cfg)
        params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        tokens = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            logits, cache, t = model.prefill(params, {"tokens": tokens}, SERVE_PROMPT + 8)
            tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None].int()
            for _ in range(2):  # warm
                logits, cache, t = model.decode_step(params, cache, tok, t)
            counts: dict = {}
            wall_ms, by_name = profile_device(lambda: model.decode_step(params, cache, tok, t),
                                              counts=counts, cpu=False)
        busy_ms = sum(by_name.values()) / 1e3
        idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
        print(f"{arch}: decode step profiled {wall_ms:.3f} ms, card busy {busy_ms:.3f} ms in "
              f"{sum(counts.values())} kernels and copies, idle share {idle}  [{CARD}]")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"    {us / 1e3:9.4f} ms  {counts[name]:4d} launches  {name[:90]}")
        sys.stdout.flush()
        del params, model, cache, logits
    _free()


def phase_zoo_f32() -> None:
    """Each family at full width, cut depth, float32 with TF32 off: prefill and
    decode against the teacher-forced forward; hubert's forward against the
    same forward through the plain attention."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import build_model, hybrid, mamba, transformer

    n_pre, n_dec = 8, 4
    phase(f"model zoo at full width in float32: prefill {n_pre} + decode {n_dec} against "
          "teacher forcing (2e-3)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, _ in ZOO_SERVED:
        depth = ZOO_F32_DEPTH[arch]
        kw = dict(param_dtype="float32", compute_dtype="float32")
        base = _zoo_config(arch)
        if base.is_moe:  # nothing dropped: capacity covers every assignment
            kw["capacity_factor"] = base.n_experts / base.n_experts_per_tok
        cfg = _zoo_config(arch, depth, **kw)
        _free()
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        tokens = torch.randint(0, cfg.vocab_size, (1, n_pre + n_dec), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            if cfg.family == "hybrid":
                full, _ = hybrid.forward(params, cfg, tokens)
            elif cfg.family == "ssm":
                full, _ = mamba.forward(params, cfg, tokens)
            else:
                kw_in = {}
                if cfg.family == "vlm":  # text: t = h = w = the position
                    kw_in["mrope_positions"] = torch.arange(
                        n_pre + n_dec, dtype=torch.int32, device="cuda")[None, :, None].expand(
                        1, -1, 3).contiguous()
                full, _, _ = transformer.forward(params, cfg, tokens=tokens, **kw_in)
            if cfg.family == "vlm":  # as serving sends it: embeddings and M-RoPE ids
                batch = {"embeds": params["embed"][tokens[:, :n_pre].long()],
                         "mrope_positions": kw_in["mrope_positions"][:, :n_pre].contiguous()}
            else:
                batch = {"tokens": tokens[:, :n_pre]}
            logits, cache, t = model.prefill(params, batch, n_pre + n_dec)
            steps = [(logits, full[:, n_pre - 1])]
            for i in range(n_dec):
                logits, cache, t = model.decode_step(
                    params, cache, tokens[:, n_pre + i: n_pre + i + 1], t)
                steps.append((logits, full[:, n_pre + i]))
            worst = 0.0
            for i, (got, want) in enumerate(steps):
                err = (got - want).abs()
                worst = max(worst, float(err.max()))
                check(bool(torch.isfinite(got).all())
                      and bool((err <= 2e-3 + 2e-3 * want.abs()).all()),
                      f"{arch} f32 step {i}: logits differ from teacher forcing by "
                      f"{float(err.max())}")
        print(f"{arch} ({depth} layers, d_model {cfg.d_model}, float32): prefill and {n_dec} "
              f"decode steps match the teacher-forced forward, max |err| {worst:.3e} over "
              f"{cfg.padded_vocab} logits a step", flush=True)
        del params, model, cache, full, logits, steps
    # hubert: the kernels' forward against the same forward through the plain attention
    cfg = _zoo_config(ZOO_ENCODER, ZOO_F32_DEPTH[ZOO_ENCODER], param_dtype="float32",
                      compute_dtype="float32")
    _free()
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(SEED))
    embeds = _randn(torch, (1, SERVE_PROMPT, cfg.d_model), torch.float32, SEED + 14)
    with torch.inference_mode():
        got, _, _ = transformer.forward(params, cfg, embeds=embeds)
        kernel = transformer.flash_attention
        transformer.flash_attention = lambda q, k, v, qp, kp, causal=True, window=None: \
            flash.attention_ref(q, k, v, qp, kp, causal, window)
        try:
            want, _, _ = transformer.forward(params, cfg, embeds=embeds)
        finally:
            transformer.flash_attention = kernel
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()) and bool((err <= 2e-3 + 2e-3 * want.abs()).all()),
          f"{ZOO_ENCODER} f32 forward differs from its plain-attention forward by "
          f"{float(err.max())}")
    print(f"{ZOO_ENCODER} ({cfg.n_layers} layers, float32) forward over {SERVE_PROMPT} frames "
          f"matches the same forward through the plain attention: max |err| "
          f"{float(err.max()):.3e}", flush=True)
    del params, got, want
    _free()


def phase_zoo_moe_card_vs_cpu() -> None:
    """The MoE smoke models on the card against the CPU: equal top-k expert ids,
    logits within the model tests' 1e-4."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe, transformer

    phase("MoE smoke models: the card against the CPU (top-k ids equal, logits 1e-4)")
    for arch in ("dbrx-132b", "qwen3-moe-235b-a22b"):
        base = get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32",
                         capacity_factor=base.n_experts / base.n_experts_per_tok)
        params = build_model(cfg).init(torch.Generator().manual_seed(SEED))
        tokens = torch.randint(0, cfg.vocab_size, (2, 11), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(SEED + 1))
        x = params["embed"][tokens.long()]
        router = params["layers"][0]["moe"]["router"]
        ids, _ = moe._route(x @ router, cfg.n_experts_per_tok)
        ids_c, _ = moe._route(x.cuda() @ router.cuda(), cfg.n_experts_per_tok)
        check(torch.equal(ids_c.cpu(), ids), f"{arch}: top-k ids differ card vs CPU")
        want, _, want_aux = transformer.forward(params, cfg, tokens=tokens)
        got, _, aux = transformer.forward(params.cuda(), cfg, tokens=tokens.cuda())
        err = float((got.cpu() - want).abs().max())
        check(err <= 1e-4 + 1e-4 * float(want.abs().max()),
              f"{arch}: logits card vs CPU differ by {err}")
        print(f"{arch} smoke: top-k ids equal card vs CPU; logits max |err| {err:.3e}; aux "
              f"{float(aux):.6f} card, {float(want_aux):.6f} CPU", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port, and tests/ for the engine-against-lane contract (jax-free)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this script: {e}", file=sys.stderr)
        return 1

    try:
        phase_card()
        phase_build()
        cover_rec = phase_kernel_vs_plain()
        philox_rec = phase_philox_vs_plain()
        rms_rec = phase_rmsnorm_vs_plain()
        att_rec = phase_attention_vs_plain()
        zoo_rms_rec = phase_zoo_rmsnorm()
        plan_launches = phase_main_path()
        path_launches = [plan_launches, phase_churned_planning(), phase_dynamic_policies(),
                         phase_space_engine(), phase_live_runtime(), phase_fifo(),
                         phase_schemes(), phase_stream(), phase_slo()]
        serve_launches = phase_serve()
        phase_decode_profile()
        phase_cache_check()
        t_zoo = time.perf_counter()
        zoo_launches = phase_model_zoo()
        phase_zoo_decode_profile()
        phase_zoo_f32()
        phase_zoo_moe_card_vs_cpu()
        print(f"\nmodel zoo: {time.perf_counter() - t_zoo:.1f} s; the whole script "
              f"{time.perf_counter() - T0:.1f} s so far", flush=True)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    rows = [
        # name, record, launches on the main paths, replaces
        ("masked_cover", cover_rec,
         sum(sum(d.values()) for d in path_launches) + serve_launches["masked_cover"]
         + zoo_launches["masked_cover"],
         "cover.cu", "src/repro/kernels/cover.py:47"),
        ("rmsnorm", dict(rms_rec, max_abs_err=max(rms_rec["max_abs_err"],
                                                  zoo_rms_rec["max_abs_err"])),
         serve_launches["rmsnorm"] + zoo_launches["rmsnorm"],
         "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:31"),
        ("flash_attention", att_rec,
         serve_launches["flash_attention"] + zoo_launches["flash_attention"],
         "flash_attention.cu", "src/repro/kernels/flash_attention.py:104"),
    ]
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        # no single PyTorch call computes the masked max-min
        "library_ms": rec.get("library_ms"),
    } for name, rec, launches, src, replaces in rows]
    # the served decode shapes beside the prefill ones, and which attention
    # kernel the served path launched (split-KV for decode, wgmma for prefill)
    kernels[1]["decode"] = rms_rec["decode"]
    kernels[2]["decode"] = att_rec["decode"]
    kernels[2]["launches_by_kernel"] = {
        k: serve_launches["flash_attention_by_kernel"][k] + zoo_launches[k]
        for k in ("splitkv", "wgmma", "simt")}
    # the model zoo's new shapes: RMSNorm at d_inner 5120, attention at hd 80
    kernels[1]["zoo"] = {k: zoo_rms_rec[k] for k in ("prefill", "decode")}
    kernels[2]["zoo"] = att_rec["zoo"]
    kernels[1]["launches_by_path"] = {"serve": serve_launches["rmsnorm"],
                                      "zoo": zoo_launches["rmsnorm"]}
    kernels[2]["launches_by_path"] = {"serve": serve_launches["flash_attention"],
                                      "zoo": zoo_launches["flash_attention"]}
    # cover: kernel A (draws in) above, kernel B (Philox sample-and-cover,
    # every frontier pass of the planning path) beside it
    kernels[0]["philox"] = philox_rec
    kernels[0]["launches_by_kernel"] = {
        k: sum(d[k] for d in path_launches) + serve_launches["masked_cover_by_kernel"][k]
        + zoo_launches[k] for k in ("draws", "philox")}
    print()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
