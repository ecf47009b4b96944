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
15. runs the training path: the two kernels' autograd Functions at the
   training shapes (RMSNorm (8, 128, 1536) bf16 and float32, bf16 and
   float32 weights, plain and ``plus_one``; attention q (8, 128, 12, 128)
   over 2 KV heads, causal on wgmma in bf16 and on the CUDA cores in
   float32, and a window of 32), each forward held to the plain version
   (``TOL``, ``ROW_RTOL``) and its gradients to autograd through the plain
   version on the card (float32 2e-5, bf16 2**-6 of each tensor's
   largest), with the forward kernel's and the plain-torch backward's
   device times beside their bounds (the RMSNorm forwards over copies of
   their inputs taken in turn, read from memory, not L2); qwen2-1.5b at
   full width and depth
   trained through ``launch.train.train`` with the launcher's defaults
   (global batch 8, seq 128, 20 steps, no checkpoint), the counters set to
   0 just before and read just after (113 RMSNorm and 56 attention
   launches a step: forward and remat recompute, every attention on
   wgmma), its step ms, tokens/s, share of 989 TFLOP/s, loss, grad norms
   and peak memory, and one step profiled whole and by part (forward,
   backward, AdamW: the card's busy ms, idle share and device time by
   kernel class); one train step at full width cut to 2 layers, float32,
   batch 2 x 128, on the card against the CPU from the same weights
   (``tests/test_torch_train_cuda.py::train_step_mismatches``); and restart
   determinism at 2 layers in bf16 (a checkpoint at step 3 of 6 restored
   from disk into fresh state continues with bitwise equal losses);
16. runs the mesh paths (``distributed/`` on ``torch.distributed``) in a
   world of one on NCCL, initialised through a ``file://`` store:
   qwen2-1.5b whole through ``jit_init_state`` / ``jit_train_step`` on the
   (1, 1) ("data", "model") mesh and on ``make_rdp_mesh`` of the launcher's
   (B, r) cut to one rank, each bitwise equal to ``make_train_step`` from
   the same state (loss, grad norm, every leaf of the parameters and both
   moments), 113 RMSNorm and 56 attention launches a mesh step, the step's
   median ms beside the plain step's and the peak memory; qwen2-1.5b served
   with the sequence-sharded true-KV cache through ``jit_prefill`` /
   ``jit_serve_step`` (prompt 1024, 32 teacher-forced tokens) against the
   plain ring's logits, in float32 within 2e-3 + 2e-3 |want| and in bf16
   timed (decode ms per token beside the plain ring's); the int8
   compressed all-reduce over a (151936, 1536) leaf, ``q``, ``scale`` and
   the error feedback bitwise the CPU's arithmetic, timed beside its bytes
   bound; a mesh state at 2 layers saved and restored onto the RDP mesh,
   bitwise;
17. runs tensor parallelism over "model" (``distributed/tensor_parallel.py``):
   the plain ring through ``jit_prefill`` / ``jit_serve_step`` on (1, 1),
   bitwise the plain model's logits; then every model rank of a TP group side
   by side on the one card, one thread a rank (``tests/torch_tp_threads.py``):
   qwen2-1.5b whole served at TP 2 and at TP 4 with ``pad_heads_to=4``
   (float32 within 2e-3 + 2e-3 |want| of the plain path, bf16 reported; 1
   request, prompt 1024, 16 tokens), qwen3-moe-235b-a22b at 2 of 94 layers
   served at TP 4 (16 query heads over 1 KV head a rank, 32 experts a rank),
   one train step at TP 2 (full width, 2 layers, float32) held to the plain
   step under ``train_step_mismatches`` with every gradient assembled from
   the rank shards; each path's launches by kernel; each rank-local
   attention shape the phase launched held against its plain version
   (``close_by_row``) and timed beside its bound;
18. runs tensor parallelism for the state-space and RG-LRU families: the
   split-row RMSNorm (``rmsnorm_sumsq`` + ``rmsnorm_scaled``) against its
   plain version at mamba2's rank shapes (d_inner 5120 over TP 2 and 4, 1024
   rows and one, bf16 and float32; ``TOL``, ``ROW_RTOL``, and the ranks'
   columns against the whole row's norm), timed beside its bound and
   ``F.rms_norm`` on the whole row; mamba2-2.7b (64 layers) and
   recurrentgemma-2b (26) served at TP 2 and 4 (the hybrid's TP 4 with
   ``pad_heads_to=4``), bf16 whole and float32 at 16 and 5 layers, prompt
   1024, 16 tokens, every rank's logits equal and float32 within 2e-3 +
   2e-3 |want| of the plain path, launches by kernel checked (mamba2's gated norm two split-row
   launches a layer); a TP 2 train step of each (mamba2 2 layers, the hybrid
   3) under ``train_step_mismatches``; the hybrid's rank-local attention
   shapes against their plain versions and timed;
19. runs sequence parallelism: qwen2-1.5b whole at TP 2 with
   ``sequence_parallel=True``, a prefill of 1024 tokens (512 rows a rank
   between the regions) within the same bound of the plain path, and a
   2-layer TP 2 train step with it under ``train_step_mismatches``;
20. holds the dry run (``launch/dryrun.py``) against the card: qwen2-1.5b
   whole at phase 15's training shape through ``jit_train_step`` on (1, 1),
   the prediction on ``meta`` tensors against one step on the card -- the
   launches by kernel (profiler trace and wrappers' counts) and the FLOPs
   (``FlopCounterMode``) exactly, the peak of live bytes beside
   ``torch.cuda.max_memory_allocated()`` -- the device memory constant the
   dry run holds cells to, a TP 2 thread-rank step (2 layers, float32)
   under ``remat_policy="block_outs"`` bitwise ``"full"``'s with no sum over
   the model group in its recompute, and each custom operator's host µs a
   call against the direct launch it wraps;
21. prints the kernels line, then, last, the one-line JSON result.

Every device time is read from a ``torch.profiler`` trace, which can drop
device events: a trace counts only if it holds as many events for each
call, no fewer kernels than the calls launched (the runtime's and the
driver's launch calls, the wrappers' counts) and no less time than the
work's bound where that is given; else it is taken again, and after three
the script fails.  Every record of the kernels line is checked at or above
its bound before the line is printed.

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

# sentinel kernels either side of a timed profiler trace (see _trace_calls),
# and what became of them over the run
TRACE_PAD = 64
TRACE_TALLY = {"traces": 0, "retaken": 0, "pad_lost_first": 0, "pad_lost_last": 0}

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
# the training cell: qwen2-1.5b at full width and depth through launch.train,
# the launcher's defaults (global batch 8, seq 128); steps, the first steps
# left out of the step-time statistics; the card-vs-CPU step and the restart
# check at 2 layers (batch 2 and 8); a windowed attention case at the
# training shapes
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = "qwen2-1.5b", 8, 128, 20, 2
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_WINDOW = 2, 2, 32
# the training cells' attention (perfbench/configs/qwen2-1.5b.json, one step's
# batch x seq): the backward kernels held and timed at each
BWD_CELLS = (("train.qwen2-1.5b.seq4k", 4, 4096), ("train.qwen2-1.5b.seq512", 32, 512))
BWD_CELL_HEADS = (12, 2, 128)  # query heads, kv heads, head dim
RESTART_STEPS, RESTART_AT = 6, 3
# the mesh train step: timed steps after TRAIN_WARM warm-up ones, mesh and plain
MESH_TIMED_STEPS = 5
# tensor parallelism, every rank of a group a thread on the one card: qwen2-1.5b
# served whole at (TP, pad_heads_to) (2, 0) and (4, 4), prompt SERVE_PROMPT and
# TP_GEN tokens; qwen3-moe at TP_MOE_DEPTH layers at TP 4; one train step at TP 2
TP_SERVE = ((2, 0), (4, 4))
TP_GEN = 16
TP_MOE_ARCH, TP_MOE_DEPTH, TP_MOE_SIZE = "qwen3-moe-235b-a22b", 2, 4
TP_TRAIN_SIZE = 2
# tensor parallelism for the state-space and RG-LRU families: mamba2-2.7b and
# recurrentgemma-2b served whole at (TP, pad_heads_to), prompt SERVE_PROMPT and
# TP_GEN tokens; a train step of each at TP_TRAIN_SIZE, cut to 2 layers (the
# hybrid to 3: one (R, R, A) group, so its attention layer is in the step)
TP_REC = (("mamba2-2.7b", ((2, 0), (4, 0))), ("recurrentgemma-2b", ((2, 0), (4, 4))))
TP_REC_TRAIN_LAYERS = {"mamba2-2.7b": 2, "recurrentgemma-2b": 3}
# the float32 comparison's depth (bf16 runs whole): the whole script reached
# 1048 s of its 1200 s on an H100 machine with both whole, and the
# ranks' host loops scale with depth; recurrentgemma one (R, R, A) group and
# its (R, R) tail
TP_REC_F32_DEPTH = {"mamba2-2.7b": 16, "recurrentgemma-2b": 5}
# sequence parallelism: qwen2-1.5b at TP SP_SIZE
SP_SIZE = 2
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


def _our_launches() -> int:
    """Every kernel launch the repo's wrappers have counted so far."""
    from repro_torch.kernels import cover, flash_attention, rmsnorm

    return cover.launches + rmsnorm.launches + flash_attention.launches


def _trace_calls(fn, iters: int, name_part: str | None = None) -> dict:
    """One card-only ``torch.profiler`` trace of ``iters`` calls of ``fn``:
    the device events (kernels, copies, sets; with ``name_part``, only the
    kernels whose name holds it) counted and their microseconds summed; the
    runtime's and the driver's kernel-launch calls counted; and the
    launches the repo's wrappers counted meanwhile.  Late in a script a
    trace came back short of 28 to 30 device events, the same count in
    every retake: ``TRACE_PAD`` sentinel kernels (``torch.cuda._sleep``)
    launched before and after the calls take that loss, are left out of
    the counts, and the ones missing are tallied by end in
    ``TRACE_TALLY``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = _our_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(0)
        for _ in range(iters):
            fn()
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    got = {"events": 0, "kernels": 0, "us": 0.0, "runtime": 0, "driver": 0,
           "ours": _our_launches() - before}
    by_name: dict = {}
    pads, starts = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if "spin_kernel" in name:
                pads.append(e.start_ns())
                continue
            if "Sync" in name or "Wait" in name or (name_part and name_part not in name):
                continue
            got["events"] += 1
            got["kernels"] += not name.startswith(("Memcpy", "Memset"))
            got["us"] += e.duration_ns() / 1e3
            by_name[name] = by_name.get(name, 0) + 1
            starts.append(e.start_ns())
        elif name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            got["runtime"] += 1
        elif name in ("cuLaunchKernel", "cuLaunchKernelEx"):
            got["driver"] += 1
    got["runtime"] = max(0, got["runtime"] - 2 * TRACE_PAD)  # the sentinels' launches
    first = min(starts, default=0)
    n_first = sum(1 for t in pads if t < first)
    got["pad_lost"] = [TRACE_PAD - n_first, TRACE_PAD - (len(pads) - n_first)]
    TRACE_TALLY["traces"] += 1
    TRACE_TALLY["pad_lost_first"] += got["pad_lost"][0]
    TRACE_TALLY["pad_lost_last"] += got["pad_lost"][1]
    # the device events that came a count no whole number of calls makes
    got["uneven"] = {name[:48]: n for name, n in by_name.items() if n % iters}
    return got


def _whole_trace(got: dict, iters: int, floor_ms: float, name_part: str | None) -> bool:
    """Whether a trace holds every kernel its calls launched: some device
    events, as many for each call (a multiple of ``iters``), no fewer
    kernels than the runtime's or the driver's launch calls or the repo's
    wrappers' counts (with ``name_part``, which leaves other kernels out:
    exactly the wrappers' count), and no fewer microseconds than the work's
    bound ``floor_ms`` a call."""
    if got["events"] == 0 or got["events"] % iters:
        return False
    if name_part is not None:
        whole = got["kernels"] == got["ours"]
    else:
        whole = got["kernels"] >= max(got["runtime"], got["driver"], got["ours"])
    return whole and got["us"] / 1e3 / iters >= floor_ms


def device_ms_per_call(fn, iters: int = 20, floor_ms: float = 0.0,
                       name_part: str | None = None, before=None) -> float:
    """The card's busy time per call of ``fn`` (kernels and copies, from a
    ``torch.profiler`` trace of ``iters`` calls after a warm-up): the
    kernel's own time, free of the host's launch overhead that CUDA events
    around back-to-back calls also see when each call is short.  With
    ``name_part``, only the kernels whose name holds it (the repo's own, as
    the wrappers count them); with ``before``, that is called ahead of each
    call, and its device work is not counted (an L2 flush: then
    ``name_part`` is needed).  The profiler can drop device events from a
    trace, so a trace counts only if :func:`_whole_trace` holds for it: a
    trace that misses kernels, or reads below ``floor_ms`` (the bound of
    the call's work), is taken again, and after three the phase fails."""
    import torch

    call = fn if before is None else (lambda: (before(), fn()))
    call()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        got = _trace_calls(call, iters, name_part)
        if _whole_trace(got, iters, floor_ms, name_part):
            return got["us"] / 1e3 / iters
        seen.append(got)
        TRACE_TALLY["retaken"] += 1
        print(f"a profiler trace of {iters} calls taken again: {got}, bound {floor_ms} ms a "
              f"call", flush=True)
    check(False, f"three profiler traces of {iters} calls each missed device events or read "
                 f"below the bound {floor_ms} ms: {seen}")


def kernel_ms_cold(fn, name_part: str, iters: int = 20) -> float:
    """Device ms per launch of the kernels whose name holds ``name_part``,
    with the 50 MB L2 cache flushed (a 256 MB buffer zeroed) before each
    call of ``fn``, as a layer of a served step finds it after the weights
    of the layers before it have streamed through."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    return device_ms_per_call(fn, iters, name_part=name_part, before=flush.zero_)


def from_memory(fn, *tensors, l2_bytes: int = 50 * 2**20):
    """``fn`` over copies of ``tensors`` taken in turn, enough copies that
    they pass twice the card's 50 MB L2 together: each call then reads its
    inputs from memory, as a layer of a training step finds them, and not
    from the L2 the previous call filled (where a read beats the memory
    rate that the bound assumes)."""
    import itertools

    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = [tuple(t.clone() for t in tensors) for _ in range(-(-2 * l2_bytes // n_bytes))]
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def device_busy_ms(fn) -> tuple[float, float]:
    """Host-clock ms of ``fn()`` up to a synchronise, and the ms the card spent
    in kernels and copies meanwhile (0 when the trace shows no device activity)."""
    wall_ms, by_name = profile_device(fn)
    return wall_ms, sum(by_name.values()) / 1e3


def rows_at_or_above_bound(rec, where: str = "kernels") -> None:
    """Fail unless every record in ``rec`` (the kernels line) that holds
    both ``ms`` and ``bound_ms`` reads at or above its bound: a reading
    below it is one the run did not measure."""
    if isinstance(rec, dict):
        ms, bnd = rec.get("ms"), rec.get("bound_ms")
        if isinstance(ms, (int, float)) and isinstance(bnd, (int, float)):
            check(ms >= bnd, f"{where}: {ms} ms below its bound {bnd} ms")
        for key, sub in rec.items():
            rows_at_or_above_bound(sub, f"{where}/{key}")
    elif isinstance(rec, list):
        for i, sub in enumerate(rec):
            rows_at_or_above_bound(sub, f"{where}[{i}]")


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
        n_bytes = 2 * x.numel() * x.element_size() + d * w.element_size()
        bnd, by = bound_ms(n_bytes, 4 * x.numel(), CARD_F32_FLOP_PER_S)
        ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(x, w), iters=50, floor_ms=bnd)
        call_ms = time_on_card(lambda: rmsnorm.rms_norm_fused(x, w), iters=50)
        plain_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(x, w), iters=50, floor_ms=bnd)
        lib_ms = device_ms_per_call(lambda: F.rms_norm(x, (d,), w, eps=1e-6), iters=50,
                                    floor_ms=bnd) if hasattr(F, "rms_norm") else None
        lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "not available"
        print(f"{name}: ({rows}, {d}) within TOL; device time per call: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, F.rms_norm {lib}; bound {bnd:.5f} ms ({by}), kernel "
              f"at {bnd / ms:.1%} of bound; back-to-back wrapper calls (CUDA events, host "
              f"launch cost included) {call_ms:.5f} ms", flush=True)
        dx = _randn(torch, (1, d), dtype, SEED)
        d_bnd, d_by = bound_ms(2 * dx.numel() * dx.element_size() + d * w.element_size(),
                               4 * dx.numel(), CARD_F32_FLOP_PER_S)
        d_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(dx, w), iters=50, floor_ms=d_bnd)
        d_plain = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(dx, w), iters=50,
                                     floor_ms=d_bnd)
        d_lib = device_ms_per_call(lambda: F.rms_norm(dx, (d,), w, eps=1e-6), iters=50,
                                   floor_ms=d_bnd) if hasattr(F, "rms_norm") else None
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
    rmsnorm.sumsq_launches = rmsnorm.scaled_launches = 0
    cover.draws_launches = cover.philox_launches = 0
    flash_attention.splitkv_launches = flash_attention.wgmma_launches = 0
    flash_attention.simt_launches = flash_attention.bwd_launches = 0


def _counts() -> dict:
    from repro_torch.kernels import cover, flash_attention, rmsnorm

    return {"rmsnorm": rmsnorm.launches, "flash_attention": flash_attention.launches,
            "masked_cover": cover.launches, "splitkv": flash_attention.splitkv_launches,
            "wgmma": flash_attention.wgmma_launches, "simt": flash_attention.simt_launches,
            "bwd": flash_attention.bwd_launches,  # backward calls, three kernels each
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
                bnd, by = bound_ms(2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                                   4 * x.numel(), CARD_F32_FLOP_PER_S)
                ms = device_ms_per_call(lambda: rmsnorm.rms_norm_fused(x, w), iters=50,
                                        floor_ms=bnd)
                plain_ms = device_ms_per_call(lambda: rmsnorm.rms_norm_ref(x, w), iters=50,
                                              floor_ms=bnd)
                lib_ms = device_ms_per_call(lambda: F.rms_norm(x, (d,), w, eps=1e-6), iters=50,
                                            floor_ms=bnd) if hasattr(F, "rms_norm") else None
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
                "wgmma": att_f * ZOO_REQUESTS, "simt": 0, "bwd": 0, "draws": 2, "philox": 0}
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


# --------------------------------------------------------------------------
# the training path: qwen2-1.5b at full width and depth
# --------------------------------------------------------------------------


def _kernel_class(name: str) -> str:
    """A device kernel's class in the training profile, by its name."""
    if "rmsnorm_kernel" in name:
        return "RMSNorm kernel"
    if "flash_bwd::" in name:
        return "attention backward kernels"
    if any(k in name for k in ("wgmma_kernel", "simt_kernel", "splitkv_kernel")):
        return "attention kernel"
    if any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmuls (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and fills"
    return "other (elementwise, reductions)"


def _by_class(by_name: dict) -> dict:
    out: dict = {}
    for name, us in by_name.items():
        cls = _kernel_class(name)
        out[cls] = out.get(cls, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_train_kernels() -> dict:
    """The kernels' autograd Functions at the training path's shapes: forward
    against the plain version (TOL, ROW_RTOL), gradients against autograd
    through the plain version on the card, the kernel each call ran, and the
    forward kernel's, the backward kernels' (bf16 on wgmma) and the
    plain-torch backward's device times."""
    import torch
    import torch.nn.functional as F
    from test_torch_train_cuda import GRAD_RTOL, relative_error

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm

    b, s, d = TRAIN_BATCH, TRAIN_SEQ, 1536
    h, kh, hd = 12, 2, 128
    phase(f"training shapes: RMSNorm ({b}, {s}, {d}) and attention q ({b}, {s}, {h}, {hd}) "
          f"k/v ({b}, {s}, {kh}, {hd}) through their autograd Functions; gradients against "
          f"autograd through the plain versions on the card (f32 {GRAD_RTOL[torch.float32]}, "
          f"bf16 {GRAD_RTOL[torch.bfloat16]:.3e} of each tensor's max)")
    rec: dict = {"rmsnorm": {}, "flash_attention": {}}
    max_err = {"rmsnorm": 0.0, "flash_attention": 0.0}
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        # layer norms in the compute dtype, the final norm's weight in float32
        for w_dtype in dict.fromkeys((dtype, torch.float32)):
            for plus_one in (False, True):
                x = _randn(torch, (b, s, d), dtype, SEED).requires_grad_(True)
                w = _randn(torch, (d,), w_dtype, SEED + 1, 0.1).requires_grad_(True)
                g = _randn(torch, (b, s, d), dtype, SEED + 2)
                what = f"rmsnorm {name} w {w_dtype} plus_one={plus_one}"
                before = rmsnorm.launches
                out = rmsnorm.RMSNormFunction.apply(x, w, 1e-6, plus_one)
                check(rmsnorm.launches == before + 1, f"{what}: the forward launched no kernel")
                want = rmsnorm.rms_norm_ref(x, w, 1e-6, plus_one)
                ok, err = close_to(out.detach(), want.detach(), name)
                max_err["rmsnorm"] = max(max_err["rmsnorm"], err)
                check(ok, f"{what}: forward max |err| {err} beyond TOL")
                check(close_by_row(out.detach(), want.detach(), name)[0],
                      f"{what}: forward beyond ROW_RTOL")
                got_g = torch.autograd.grad(out, (x, w), g)
                want_g = torch.autograd.grad(want, (x, w), g)
                for gname, a, r in zip(("dx", "dw"), got_g, want_g):
                    rel = relative_error(a, r)
                    worst[("rmsnorm", name, gname)] = max(worst.get(("rmsnorm", name, gname), 0),
                                                          rel)
                    check(a.dtype == r.dtype and rel <= GRAD_RTOL[dtype],
                          f"{what}: {gname} {rel:.3e} of its max from autograd's")
        x = _randn(torch, (b, s, d), dtype, SEED)
        w = _randn(torch, (d,), dtype, SEED + 1, 0.1)
        g = _randn(torch, (b, s, d), dtype, SEED + 2)
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        size, n = x.element_size(), x.numel()
        f_bnd, f_by = bound_ms(2 * n * size + d * w.element_size(), 4 * n, CARD_F32_FLOP_PER_S)
        # backward: read g, x, w once, write dx, dw once; ~10 flops an element
        b_bnd, b_by = bound_ms(3 * n * size + 2 * d * w.element_size(), 10 * n,
                               CARD_F32_FLOP_PER_S)
        # x (3 MB in bf16) would stay in the 50 MB L2 between back-to-back
        # calls and beat the memory rate: the forwards read copies in turn
        fwd = device_ms_per_call(from_memory(rmsnorm.rms_norm_fused, x, w), iters=50,
                                 floor_ms=f_bnd)
        cold = kernel_ms_cold(lambda: rmsnorm.rms_norm_fused(x, w), "rmsnorm_kernel")
        plain = device_ms_per_call(from_memory(rmsnorm.rms_norm_ref, x, w), iters=50,
                                   floor_ms=f_bnd)
        lib = device_ms_per_call(from_memory(lambda x, w: F.rms_norm(x, (d,), w, eps=1e-6), x, w),
                                 iters=50, floor_ms=f_bnd) if hasattr(F, "rms_norm") else None
        bwd = device_ms_per_call(lambda: rmsnorm.rms_norm_bwd(g, x, w), iters=50, floor_ms=b_bnd)
        plain_bwd = device_ms_per_call(lambda: torch.autograd.grad(
            rmsnorm.rms_norm_ref(xg, wg), (xg, wg), g), iters=50, floor_ms=b_bnd)
        lib_s = f"{lib:.5f} ms" if lib is not None else "not available"
        print(f"rmsnorm {name} ({b}, {s}, {d}): forward kernel {fwd:.5f} ms, inputs read from "
              f"memory ({cold:.5f} ms with L2 flushed before each call; plain {plain:.5f}, "
              f"F.rms_norm {lib_s}; bound {f_bnd:.5f} ms, {f_by}); backward rms_norm_bwd "
              f"{bwd:.5f} ms (plain version's forward + autograd {plain_bwd:.5f}; bound "
              f"{b_bnd:.5f} ms, {b_by})  [{CARD}]", flush=True)
        if dtype == torch.bfloat16:
            rec["rmsnorm"] = {"shape": [b, s, d], "ms": fwd, "cold_ms": cold, "plain_ms": plain,
                              "bound_ms": f_bnd, "bound_by": f_by, "library_ms": lib,
                              "backward": {"ms": bwd, "plain_ms": plain_bwd, "bound_ms": b_bnd,
                                           "bound_by": b_by}}

    pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s).contiguous()
    cases = [("causal", torch.bfloat16, True, None, "wgmma"),
             ("causal", torch.float32, True, None, "simt"),
             (f"window {TRAIN_WINDOW}", torch.bfloat16, True, TRAIN_WINDOW, "wgmma")]
    for label, dtype, causal, window, want_path in cases:
        name = str(dtype).removeprefix("torch.")
        q = _randn(torch, (b, s, h, hd), dtype, SEED + 3).requires_grad_(True)
        k = _randn(torch, (b, s, kh, hd), dtype, SEED + 4).requires_grad_(True)
        v = _randn(torch, (b, s, kh, hd), dtype, SEED + 5).requires_grad_(True)
        g = _randn(torch, (b, s, h, hd), dtype, SEED + 6)
        what = f"attention {name} {label}"
        before = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
        n_before, bwd_before = flash.launches, flash.bwd_launches
        out = flash.AttentionFunction.apply(q, k, v, pos, pos, causal, window, None)
        path = _attention_path(flash, before)
        check(flash.launches == n_before + 1 and path == want_path,
              f"{what}: ran {path} ({flash.launches - n_before} launches), not {want_path}")
        want = flash.attention_ref(q, k, v, pos, pos, causal, window)
        ok, err = close_to(out.detach(), want.detach(), name)
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        check(ok, f"{what}: forward max |err| {err} beyond TOL")
        check(close_by_row(out.detach(), want.detach(), name)[0],
              f"{what}: forward beyond ROW_RTOL")
        got_g = torch.autograd.grad(out, (q, k, v), g)
        kernels = path == "wgmma"  # its forward wrote lse: the backward kernels took it
        check(flash.bwd_launches == bwd_before + kernels,
              f"{what}: {flash.bwd_launches - bwd_before} backward kernel calls, not {kernels:d}")
        want_g = torch.autograd.grad(want, (q, k, v), g)
        rels = []
        for gname, a, r in zip(("dq", "dk", "dv"), got_g, want_g):
            rel = relative_error(a, r)
            rels.append(f"{gname} {rel:.3e}")
            check(a.dtype == r.dtype and rel <= GRAD_RTOL[dtype],
                  f"{what}: {gname} {rel:.3e} of its max from autograd's")
        qd, kd, vd, od = q.detach(), k.detach(), v.detach(), out.detach()
        fwd = device_ms_per_call(
            lambda: flash.attention(qd, kd, vd, pos, pos, causal, window), iters=20)
        cold = kernel_ms_cold(lambda: flash.attention(qd, kd, vd, pos, pos, causal, window), path)
        plain = device_ms_per_call(
            lambda: flash.attention_ref(qd, kd, vd, pos, pos, causal, window), iters=20)
        bwd = device_ms_per_call(lambda: flash.attention_bwd(g, qd, kd, vd, od, pos, pos, causal,
                                                             window), iters=20)
        bwd_kernels = None
        if kernels:
            _, lse = flash.attention_with_lse(qd, kd, vd, pos, pos, causal, window)
            bwd_kernels = device_ms_per_call(lambda: flash.attention_backward(
                g, qd, kd, vd, od, lse, pos, pos, causal, window), iters=20)
        plain_bwd = device_ms_per_call(lambda: torch.autograd.grad(
            flash.attention_ref(q, k, v, pos, pos, causal, window), (q, k, v), g), iters=20)
        f_bnd, f_by = _attention_bound(torch, qd, kd, pos, pos, causal, window)
        # backward: q, o, dO read and dq written (4 the size of q), k, v read and
        # dk, dv written (4 the size of k); per visible pair and query head, S
        # recomputed and dV, dP, dQ, dK: 10 * hd flops
        n_bytes = 4 * qd.numel() * qd.element_size() + 4 * kd.numel() * kd.element_size() \
            + 8 * pos.numel()
        pairs = _visible_pairs(torch, pos, pos, causal, window)
        rate = CARD_BF16_FLOP_PER_S if dtype == torch.bfloat16 else CARD_F32_FLOP_PER_S
        b_bnd, b_by = bound_ms(n_bytes, 10.0 * hd * h * pairs, rate)
        lib = _sdpa_ms(torch, qd, kd, vd, causal, iters=20) if window is None else None
        lib_s = f", SDPA {lib:.5f} ms" if lib is not None else ""
        print(f"{what} on {path}: gradients within bound ({', '.join(rels)}); forward kernel "
              f"{fwd:.5f} ms ({cold:.5f} ms with L2 flushed; plain {plain:.5f}{lib_s}; bound "
              f"{f_bnd:.5f} ms, {f_by}); "
              f"backward kernels "
              f"{'not taken' if bwd_kernels is None else f'{bwd_kernels:.5f} ms'}, closed form "
              f"attention_bwd {bwd:.5f} ms (plain version's forward + autograd "
              f"{plain_bwd:.5f}; bound {b_bnd:.5f} ms, {b_by})  [{CARD}]", flush=True)
        if label == "causal" and dtype == torch.bfloat16:
            rec["flash_attention"] = {
                "shape": [b, s, h, hd], "kv_heads": kh, "ms": fwd, "cold_ms": cold,
                "plain_ms": plain,
                "bound_ms": f_bnd, "bound_by": f_by, "library_ms": lib,
                "backward": {"ms": bwd_kernels, "closed_form_ms": bwd, "plain_ms": plain_bwd,
                             "bound_ms": b_bnd, "bound_by": b_by}}
        del q, k, v, g, out, want, got_g, want_g
    _free()
    rec["flash_attention"]["backward"]["cells"] = _attention_backward_cells(GRAD_RTOL,
                                                                            relative_error)
    for key, rel in sorted(worst.items()):
        print(f"{' '.join(key)}: largest gradient error {rel:.3e} of its max")
    for key in rec:
        rec[key]["max_abs_err"] = max_err[key]
    _free()
    return rec


def _attention_backward_cells(grad_rtol: dict, relative_error) -> dict:
    """The attention backward at the training cells' shapes (``BENCHMARK.json``:
    qwen2-1.5b, 12 query heads over 2, hd 128, causal): the kernels against the
    closed form :func:`attention_bwd` on the same bf16 inputs and the forward's
    ``lse`` within GRAD_RTOL, bitwise on a second call, then the kernels', the
    closed form's and the bound's times a layer."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    bf16, (h, kh, hd) = torch.bfloat16, BWD_CELL_HEADS
    out_rec: dict = {}
    for cell, b, s in BWD_CELLS:
        q, k, v, g = (_randn(torch, (b, s, n, hd), bf16, SEED + 20 + i)
                      for i, n in enumerate((h, kh, kh, h)))
        pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s).contiguous()
        args = (q, k, v)
        out, lse = flash.attention_with_lse(*args, pos, pos, True, None)
        what = f"attention backward at {cell}'s shape ({b}, {s}, {h} over {kh}, {hd}), causal"
        check(flash.backward_route(*args, lse) == "kernels", f"{what}: the kernels do not take it")
        n0 = flash.bwd_launches
        got = flash.attention_backward(g, *args, out, lse, pos, pos, True, None)
        again = flash.attention_backward(g, *args, out, lse, pos, pos, True, None)
        torch.cuda.synchronize()
        check(flash.bwd_launches == n0 + 2, f"{what}: {flash.bwd_launches - n0} calls, not 2")
        bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
        del again
        want = flash.attention_bwd(g, *args, out, pos, pos, True, None)
        rels = {n: relative_error(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, want)}
        del got, want
        _free()
        check(bitwise, f"{what}: a second call is not bitwise the first")
        check(all(r <= grad_rtol[bf16] for r in rels.values()),
              f"{what}: {rels} of each tensor's max from the closed form's, beyond "
              f"{grad_rtol[bf16]:.3e}")
        # the operations bound: S again, dV, dP, dQ, dK per visible pair and
        # query head (10 hd flops), at the bf16 tensor-core rate
        pairs = _visible_pairs(torch, pos, pos, True, None)
        n_bytes = 4 * q.numel() * q.element_size() + 4 * k.numel() * k.element_size() \
            + 8 * pos.numel()
        bnd, by = bound_ms(n_bytes, 10.0 * hd * h * pairs, CARD_BF16_FLOP_PER_S)
        ms = device_ms_per_call(lambda: flash.attention_backward(
            g, *args, out, lse, pos, pos, True, None), iters=20, floor_ms=bnd)
        closed = device_ms_per_call(lambda: flash.attention_bwd(
            g, *args, out, pos, pos, True, None), iters=5, floor_ms=bnd)
        print(f"{what}: dq, dk, dv within {grad_rtol[bf16]:.3e} of the closed form's max "
              f"({', '.join(f'{n} {r:.3e}' for n, r in rels.items())}), bitwise on a second "
              f"call; backward kernels {ms:.5f} ms, closed form attention_bwd {closed:.5f} ms "
              f"({closed / ms:.2f}x), bound {bnd:.5f} ms ({by}; kernels at {bnd / ms:.1%} of "
              f"it)  [{CARD}]", flush=True)
        out_rec[cell] = {"shape": [b, s, h, hd], "kv_heads": kh, "causal": True, "ms": ms,
                         "closed_form_ms": closed, "bound_ms": bnd, "bound_by": by,
                         "grad_rel": rels, "bitwise": bitwise}
        del q, k, v, g, out, lse, args
        _free()
    return out_rec


def phase_train_full() -> dict:
    """qwen2-1.5b at full width and depth trained through ``launch.train.train``
    (the launcher's defaults: global batch 8, seq 128, SyntheticLM, AdamW with
    ``cosine_with_warmup(3e-3, ...)``), the counters set to 0 just before and
    read just after; then one step profiled by part."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.launch import train as train_launch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, apply_updates, cosine_with_warmup
    from repro_torch.runtime.train import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    layers = cfg.n_layers
    phase(f"training path: launch.train.train, {TRAIN_ARCH} at full width and depth ({layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; f32 master weights, "
          f"{cfg.compute_dtype} compute, remat), {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens")
    _free()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        report = train_launch.train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, ckpt_dir=str(ROOT / "build" / "train"),
                                    ckpt_every=0, log_every=5, seed=SEED)
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = tee.copy.getvalue()
    for line in ("[plan]", "[model]", "[done]", "[report]"):
        check(line in out, f"no {line} line from launch.train")
    # per step: 2 per layer + the final norm in the forward, 2 per layer again
    # in the backward's recompute of each checkpointed block; attention 1 + 1;
    # the attention backward kernels once a layer
    per_step = {"rmsnorm": 2 * layers + 1 + 2 * layers, "flash_attention": 2 * layers,
                "bwd": layers}
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    got = {k: counts[k] for k in want}
    print(f"launch.train.train in {wall:.3f} s (weights made included); launches {got}, "
          f"expected {want} ({per_step} a step: {layers} layers x (forward + remat "
          f"recompute), the final norm once, the backward kernels once a layer); attention by "
          f"kernel wgmma {counts['wgmma']}, CUDA-core {counts['simt']}, split-KV "
          f"{counts['splitkv']}; backward kernel calls {counts['bwd']}")
    check(got == want, f"training launches {got}, expected {want}")
    check(counts["wgmma"] == want["flash_attention"] and counts["simt"] == 0
          and counts["splitkv"] == 0, "training attention did not run on wgmma alone")
    check(counts["bwd"] == TRAIN_STEPS * layers,
          f"{counts['bwd']} backward kernel calls in {TRAIN_STEPS} steps, not one a layer")
    check(counts["masked_cover"] == 0, "the training path launched a cover kernel")
    losses, norms = report["losses"], report["grad_norms"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses + norms),
          f"losses or grad norms not finite: {losses} {norms}")
    steps_ms = report["step_ms"][TRAIN_WARM:]
    med = statistics.median(steps_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = report["params"]
    flops = 6.0 * n_params * tokens
    print(f"step ms after {TRAIN_WARM} warm-up steps: median {med:.3f}, min {min(steps_ms):.3f}, "
          f"max {max(steps_ms):.3f} (first steps {report['step_ms'][:TRAIN_WARM]}); "
          f"{tokens / (med / 1e3):.1f} tokens/s; 6 N T = 6 x {n_params} x {tokens} = "
          f"{flops / 1e12:.3f} TFLOP a step (model FLOPs, the remat recompute not counted) "
          f"at {flops / (med / 1e3) / 1e12:.3f} TFLOP/s, "
          f"{flops / (med / 1e3) / CARD_BF16_FLOP_PER_S:.2%} of 989 TFLOP/s bf16  [{CARD}]")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (ceiling {report['loss_ceiling']:.3f}; "
          f"uniform {math.log(cfg.vocab_size):.3f}); grad norm {norms[0]:.3f} -> {norms[-1]:.3f} "
          f"(max {max(norms):.3f}); peak device memory {peak:.3f} GB", flush=True)

    # one step profiled: whole, then forward / backward / optimizer apart
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS))
    step_fn = make_train_step(model, opt)
    state = init_state(model, opt, torch.Generator(device="cuda").manual_seed(SEED))
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.global_batch(0).items()}
    state, _ = step_fn(state, batch)  # warm
    counts_step: dict = {}
    wall_ms, by_name = profile_device(lambda: step_fn(state, batch), counts=counts_step)
    busy = sum(by_name.values()) / 1e3
    idle = f"{1.0 - busy / wall_ms:.1%}" if busy > 0 else "not measured"
    print(f"one profiled step: {wall_ms:.3f} ms, card busy {busy:.3f} ms, idle share {idle}; "
          f"{sum(counts_step.values())} device kernels and copies")
    leaves = state.params.leaves()
    holder: dict = {}

    def forward():
        holder["loss"] = model.train_loss(state.params, batch)[0]

    def backward():
        holder["grads"] = torch.autograd.grad(holder.pop("loss"), list(leaves.values()))

    def optimizer():
        grads = dict(zip(leaves, holder.pop("grads")))
        upd, _, _ = opt.update(grads, state.opt_state, state.params)
        apply_updates(state.params, upd)

    for part, fn in (("forward", forward), ("backward (remat recompute included)", backward),
                     ("AdamW", optimizer)):
        p_counts: dict = {}
        p_wall, p_by = profile_device(fn, counts=p_counts)
        p_busy = sum(p_by.values()) / 1e3
        by_cls = ", ".join(f"{c} {ms:.3f} ms" for c, ms in _by_class(p_by).items())
        print(f"  {part}: {p_wall:.3f} ms on the host clock, card busy {p_busy:.3f} ms "
              f"({sum(p_counts.values())} kernels): {by_cls}")
        for name, us in sorted(p_by.items(), key=lambda kv: -kv[1])[:5]:
            print(f"      {us / 1e3:9.4f} ms  {p_counts[name]:4d} x  {name[:90]}")
    del state, holder
    _free()
    return {"rmsnorm": got["rmsnorm"], "flash_attention": got["flash_attention"],
            "wgmma": counts["wgmma"], "bwd": counts["bwd"], "step_ms_median": med, "idle": idle}


def phase_train_card_vs_cpu() -> None:
    """One train step of qwen2-1.5b at full width cut to 2 layers, float32
    compute, batch 2 x 128, on the card against the same step on the CPU from
    the same weights (``tests/test_torch_train_cuda.py::train_step_mismatches``)."""
    import copy

    import torch
    from test_torch_train_cuda import relative_error, step_record, train_step_mismatches

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.runtime.train import TrainState

    cfg = dataclasses.replace(get_config(TRAIN_ARCH, param_dtype="float32",
                                         compute_dtype="float32"), n_layers=TRAIN_CHECK_LAYERS)
    phase(f"one train step on the card against the CPU: {TRAIN_ARCH} at full width, "
          f"{cfg.n_layers} layers, float32 compute (TF32 off), batch {TRAIN_CHECK_BATCH} x "
          f"{TRAIN_SEQ}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 1, TRAIN_STEPS))
    params = model.init(torch.Generator().manual_seed(SEED)).trainable()
    cpu_state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    card_params = copy.deepcopy(params).to("cuda")
    card_state = TrainState(cpu_state.step.to("cuda"), card_params, opt.init(card_params))
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_CHECK_BATCH,
                                       seed=SEED)).global_batch(0)
    got = step_record(card_state, {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()},
                      model, opt)
    t0 = time.perf_counter()
    want = step_record(cpu_state, {k: torch.from_numpy(v) for k, v in batch.items()}, model, opt)
    cpu_s = time.perf_counter() - t0
    stats: dict = {}
    bad = train_step_mismatches(got, want, stats)
    check(not bad, f"card vs CPU train step: {bad[:6]}")
    worst = max((relative_error(got["grads"][k], w), k) for k, w in want["grads"].items())
    n_el = sum(w.numel() for w in want["params"].values())
    print(f"loss card {float(got['loss']):.7f}, CPU {float(want['loss']):.7f}; every gradient "
          f"and moment within bound (largest gradient error {worst[0]:.3e} of its leaf's max, "
          f"{worst[1]}); every parameter element within 1e-5 plus its gradient's first-step "
          f"allowance ({stats['beyond_param_tol']} of {n_el} elements beyond 1e-5 alone, "
          f"largest difference {stats['largest_param_diff']:.3e}); the CPU step took "
          f"{cpu_s:.1f} s", flush=True)
    del got, want, card_state, card_params
    _free()


def phase_train_restart() -> None:
    """Restart determinism on the card: qwen2-1.5b at full width, 2 layers,
    bf16 compute; a checkpoint at step 3 of 6 restored from disk into fresh
    state continues with the uninterrupted run's losses bit for bit."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.runtime.train import _value_and_grad, init_state, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    phase(f"restart determinism on the card: {TRAIN_ARCH} at full width, {cfg.n_layers} layers, "
          f"{cfg.compute_dtype} compute, checkpoint at step {RESTART_AT} of {RESTART_STEPS}")
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 1, RESTART_STEPS))
    step_fn = make_train_step(model, opt)
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))

    def batch(s):
        return {k: torch.from_numpy(v).to("cuda") for k, v in pipe.global_batch(s).items()}

    ckdir = ROOT / "build" / "train_restart"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(ckdir, keep=1)
    state = init_state(model, opt, torch.Generator(device="cuda").manual_seed(SEED))
    losses = []
    for s in range(RESTART_STEPS):
        state, m = step_fn(state, batch(s))
        losses.append(float(m["loss"]))
        if s == RESTART_AT - 1:
            t0 = time.perf_counter()
            mgr.save(RESTART_AT, state)
            save_s = time.perf_counter() - t0
    del state
    _free()
    t0 = time.perf_counter()
    fresh = init_state(model, opt, torch.Generator(device="cuda").manual_seed(SEED + 1))
    state, s0 = CheckpointManager(ckdir).restore(fresh)
    restore_s = time.perf_counter() - t0
    del fresh
    check(s0 == RESTART_AT and int(state.step) == RESTART_AT, f"restored step {s0}")
    # the same gradients twice from one state: what run-to-run determinism rests on
    _, _, g1 = _value_and_grad(model, state.params, batch(RESTART_AT))
    _, _, g2 = _value_and_grad(model, state.params, batch(RESTART_AT))
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    del g1, g2
    print(f"gradients recomputed from one state: {'bitwise equal' if not differ else differ}")
    resumed = []
    for s in range(RESTART_AT, RESTART_STEPS):
        state, m = step_fn(state, batch(s))
        resumed.append(float(m["loss"]))
    size = sum(p.stat().st_size for p in (ckdir / f"step_{RESTART_AT:08d}").iterdir()) / 1e9
    print(f"losses {losses}; resumed from disk {resumed}; checkpoint {size:.3f} GB, saved in "
          f"{save_s:.1f} s, verified and restored in {restore_s:.1f} s", flush=True)
    check(resumed == losses[RESTART_AT:],
          f"resumed losses {resumed} differ from the uninterrupted {losses[RESTART_AT:]}")
    del state
    shutil.rmtree(ckdir, ignore_errors=True)
    _free()


# --------------------------------------------------------------------------
# the mesh paths: distributed/ on torch.distributed, a world of one on NCCL
# --------------------------------------------------------------------------


def phase_mesh_init() -> None:
    """A world of one on NCCL over the card, through a ``file://`` store (no
    network): the process group every mesh phase runs on."""
    import torch
    import torch.distributed as dist

    phase("mesh: a world of one on NCCL (file:// store)")
    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)  # the communicator is made at the first collective
    torch.cuda.synchronize()
    check(dist.get_backend() == "nccl" and probe.tolist() == [1.0] * 4,
          f"NCCL world: backend {dist.get_backend()}, all_reduce {probe.tolist()}")
    print(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, world of "
          f"{dist.get_world_size()}, first all_reduce after {time.perf_counter() - t0:.3f} s",
          flush=True)


def _plain_alias(state):
    """The plain TrainState that shares a world-of-one mesh state's storage
    (every shard there is its whole leaf), its parameters trainable, as
    ``init_state`` makes them."""
    import torch

    from repro_torch.optim import OptState
    from repro_torch.runtime.train import TrainState

    params = state.params.replace_leaves(
        {k: torch.nn.Parameter(p.to_local(), requires_grad=True)
         for k, p in state.params.leaves().items()})
    opt = state.opt_state
    return TrainState(state.step, params, OptState(
        opt.count, {k: t.to_local() for k, t in opt.m.items()},
        {k: t.to_local() for k, t in opt.v.items()}))


def _state_leaves(state) -> dict:
    """Every tensor of a TrainState (plain or mesh) by key, local (whole) tensors."""
    out = {"step": state.step, "count": state.opt_state.count}
    for k, p in state.params.leaves().items():
        out["params." + k] = p.to_local() if hasattr(p, "to_local") else p
    for name in ("m", "v"):
        for k, t in getattr(state.opt_state, name).items():
            out[f"{name}.{k}"] = t.to_local() if hasattr(t, "to_local") else t
    return out


def _timed_steps(step_fn, state, batch, warm: int, steps: int):
    """Host ms of each of ``steps`` chained steps (each ends in a synchronise)
    after ``warm`` untimed ones, and the peak device memory meanwhile."""
    import torch

    for _ in range(warm):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated() / 1e9


def phase_mesh_train() -> dict:
    """qwen2-1.5b whole (28 layers, batch 8 x 128, bf16 compute, f32 master,
    remat) through ``jit_init_state`` / ``jit_train_step`` on the (1, 1)
    ("data", "model") mesh and on ``make_rdp_mesh`` of the launcher's plan cut
    to one rank, each held bitwise against ``make_train_step`` from the same
    state: the loss, the grad norm and every leaf of the parameters and both
    moments.  Then the step's median ms beside the plain step's, the peak
    memory, and the kernel launches of one mesh step (counts set to 0 just
    before, read just after)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.planner import RedundancyPlanner
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.distributed import rdp
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.runtime.train import jit_init_state, jit_train_step, make_train_step

    cfg = get_config(TRAIN_ARCH)
    layers = cfg.n_layers
    plan = RedundancyPlanner(8).plan(train_launch.DISTS["sexp"], "mean")
    one = dataclasses.replace(plan, n_workers=1, n_batches=1, replication=1)
    phase(f"mesh train step: {TRAIN_ARCH} whole ({layers} layers, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {cfg.compute_dtype} compute, f32 master, remat) through "
          f"jit_train_step on (1, 1) ('data', 'model') and on make_rdp_mesh of the launcher's "
          f"plan B={plan.n_batches} x r={plan.replication} cut to one rank (1, 1, 1), each "
          "bitwise against make_train_step from the same state")
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS))
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.global_batch(0).items()}
    plain_step = make_train_step(model, opt)
    meshes = [("(1, 1) data/model", make_mesh((1, 1), ("data", "model"))),
              ("RDP (1, 1, 1)", rdp.make_rdp_mesh(one, 1))]
    rec: dict = {"launches": {"rmsnorm": 0, "flash_attention": 0, "wgmma": 0, "bwd": 0}}
    for name, mesh in meshes:
        _free()
        init, st_sh = jit_init_state(mesh, model, opt)
        step, _, b_sh = jit_train_step(mesh, model, opt, shape)
        state = init(torch.Generator(device="cuda").manual_seed(SEED))
        # the plain step first, from the same storage; its result stays on the
        # card beside the mesh step's (about 62 GB at the peak, compared leaf by leaf)
        p_state, want_metrics = plain_step(_plain_alias(state), batch)
        want = {k: t.detach() for k, t in _state_leaves(p_state).items()}
        del p_state
        _reset_counts()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts = _counts()
        del state
        got = _state_leaves(new)
        check(set(got) == set(want), f"{name}: mesh state keys differ from the plain state's")
        differ = [k for k in want if not torch.equal(got[k].detach(), want[k])]
        for key in ("loss", "grad_norm", "lr", "loss_total"):
            if not torch.equal(metrics[key], want_metrics[key]):
                differ.append(f"metric {key}")
        placed = {str(s.spec) for s in st_sh.params.values()}
        print(f"{name}: batch {b_sh['tokens'].spec}, parameter specs {sorted(placed)}; "
              f"loss {float(metrics['loss']):.7f}, grad norm {float(metrics['grad_norm']):.7f}; "
              f"{len(want)} leaves and 4 metrics {'bitwise equal' if not differ else differ[:6]}")
        check(not differ, f"{name}: the mesh step differs from the plain step at {differ[:6]}")
        want_launch = {"rmsnorm": 2 * layers + 1 + 2 * layers, "flash_attention": 2 * layers,
                       "wgmma": 2 * layers, "bwd": layers}
        got_launch = {k: counts[k] for k in want_launch}
        print(f"  launches in one mesh step {got_launch}, expected {want_launch} (the plain "
              "step's: forward + remat recompute, the backward kernels once a layer)")
        check(got_launch == want_launch, f"{name}: launches {got_launch}, expected {want_launch}")
        for k in rec["launches"]:
            rec["launches"][k] += got_launch[k]
        del want, want_metrics, got, new, metrics
        _free()
        # each chain from a fresh state that only the chain holds
        gen = torch.Generator(device="cuda")
        mesh_ms, mesh_peak = _timed_steps(step, init(gen.manual_seed(SEED)), batch, TRAIN_WARM,
                                          MESH_TIMED_STEPS)
        _free()
        plain_ms, plain_peak = _timed_steps(plain_step, _plain_alias(init(gen.manual_seed(SEED))),
                                            batch, TRAIN_WARM, MESH_TIMED_STEPS)
        med, pmed = statistics.median(mesh_ms), statistics.median(plain_ms)
        print(f"  step ms over {MESH_TIMED_STEPS} after {TRAIN_WARM} warm-up: mesh median "
              f"{med:.3f} (min {min(mesh_ms):.3f}, max {max(mesh_ms):.3f}), plain median "
              f"{pmed:.3f} (min {min(plain_ms):.3f}, max {max(plain_ms):.3f}); mesh / plain "
              f"{med / pmed:.4f}; peak device memory mesh {mesh_peak:.3f} GB, plain "
              f"{plain_peak:.3f} GB  [{CARD}]", flush=True)
        rec[name] = {"mesh_ms": med, "plain_ms": pmed}
    _free()
    return rec


def phase_mesh_serve() -> dict:
    """qwen2-1.5b whole with the sequence-sharded true-KV cache through
    ``jit_prefill`` / ``jit_serve_step`` on (1, 1): in float32 (TF32 off), the
    logits of a prompt and every teacher-forced decode step against the plain
    ring cache's within the served tolerance (2e-3 + 2e-3 |want|); in bf16,
    the decode ms per token beside the plain cache's, and the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.serve import jit_prefill, jit_serve_step

    n = SERVE_PROMPT + SERVE_GEN
    phase(f"mesh serving: {SERVE_ARCH} whole, decode_kv_seq_sharded through jit_prefill / "
          f"jit_serve_step on (1, 1), prompt {SERVE_PROMPT} + {SERVE_GEN} teacher-forced tokens, "
          "against the plain ring cache (float32: 2e-3 + 2e-3 |want|; bf16: timed)")
    mesh = make_mesh((1, 1), ("data", "model"))
    rec: dict = {}
    for dtype in ("float32", "bfloat16"):
        _free()
        cfg_p = get_config(SERVE_ARCH, compute_dtype=dtype)
        cfg_s = dataclasses.replace(cfg_p, decode_kv_seq_sharded=True)
        plain, seq = build_model(cfg_p), build_model(cfg_s)
        params = plain.for_serving(plain.init(torch.Generator(device="cuda").manual_seed(SEED)))
        prefill, p_sh, _, c_sh = jit_prefill(mesh, seq, ShapeConfig("p", n, 1, "prefill"))
        step, _, _, _ = jit_serve_step(mesh, seq, ShapeConfig("d", n, 1, "decode"))
        dparams = params.replace_leaves({k: sharding.distribute(p, p_sh[k])
                                         for k, p in params.leaves().items()})
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        tokens = torch.randint(0, cfg_p.vocab_size, (1, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        worst, times = 0.0, {"plain": [], "seq": []}
        counts = {"rmsnorm": 0, "flash_attention": 0, "splitkv": 0, "wgmma": 0, "simt": 0}

        def seq_path(fn, *args):
            """``fn(*args)`` of the seq-sharded path, its launches counted alone."""
            _reset_counts()
            out = fn(*args)
            for k in counts:
                counts[k] += _counts()[k]
            return out

        with torch.inference_mode():
            a, ca, ta = plain.prefill(params, {"tokens": tokens[:, :SERVE_PROMPT]}, n)
            b, cb, tb = seq_path(prefill, dparams, {"tokens": tokens[:, :SERVE_PROMPT]})
            check("ks" in cb[0] and isinstance(cb[0]["ks"], torch.distributed.tensor.DTensor)
                  and str(c_sh[0]["ks"].spec) == "PartitionSpec('data', 'model', None, None)",
                  f"the served cache is not the sequence-sharded DTensor ring: {sorted(cb[0])}")
            pairs = [(b, a)]
            for i in range(SERVE_GEN - 1):
                tok = tokens[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a, ca, ta = plain.decode_step(params, ca, tok, ta)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                b, cb, tb = seq_path(step, dparams, cb, tok, tb)
                torch.cuda.synchronize()
                times["plain"].append((t1 - t0) * 1e3)
                times["seq"].append((time.perf_counter() - t1) * 1e3)
                pairs.append((b, a))
        for i, (got, want) in enumerate(pairs):
            err = (got.float() - want.float()).abs()
            worst = max(worst, float(err.max()))
            if dtype == "float32":
                check(bool(torch.isfinite(got).all())
                      and bool((err <= 2e-3 + 2e-3 * want.float().abs()).all()),
                      f"float32 step {i}: seq-sharded logits differ from the plain ring's by "
                      f"{float(err.max())}")
            else:
                check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                      f"bf16 step {i}: logits {tuple(got.shape)} not finite")
        steps = SERVE_GEN - 1
        # the seq-sharded path: every norm of the prefill and of each decode
        # step, the prefill's attention over the activations; its decode
        # attends by the einsum combine (no attention kernel)
        want_counts = {"rmsnorm": (1 + steps) * (2 * cfg_p.n_layers + 1),
                       "flash_attention": cfg_p.n_layers}
        med = {k: statistics.median(v[2:]) for k, v in times.items()}
        got_counts = {k: counts[k] for k in want_counts}
        print(f"{dtype}: prefill + {steps} decode steps, max |seq-sharded - plain ring| "
              f"{worst:.3e} over {cfg_p.padded_vocab} logits; decode ms/token median (after 2) "
              f"seq-sharded {med['seq']:.3f}, plain ring {med['plain']:.3f}; the seq-sharded "
              f"path's launches {counts}, expected {want_counts}  [{CARD}]", flush=True)
        check(got_counts == want_counts,
              f"{dtype} serving launches {got_counts}, expected {want_counts}")
        rec[dtype] = {"seq_ms": med["seq"], "plain_ms": med["plain"], "max_err": worst,
                      **counts}
        del params, dparams, ca, cb, pairs
    _free()
    return rec


def phase_mesh_allreduce() -> None:
    """``compressed_allreduce_mean`` on NCCL over qwen2-1.5b's largest leaf
    (the 151936 x 1536 embedding's shape): ``q``, ``scale`` and the new error
    feedback bitwise the plain arithmetic on the CPU, the mean within 1e-6 of
    the terms' size; its time beside its bytes bound."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives

    cfg = get_config(SERVE_ARCH)
    shape = (cfg.padded_vocab, cfg.d_model)
    phase(f"mesh: int8 compressed all-reduce on NCCL over a {shape} float32 leaf")
    _free()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    ef0 = torch.randn(shape, generator=gen, device="cuda") * 1e-6
    mean, ef = collectives.compressed_allreduce_mean(x, ef0, None)
    q, scale = collectives.quantize_int8(x + ef0)
    x_c, ef0_c = x.cpu(), ef0.cpu()
    y_c = x_c + ef0_c
    q_c, scale_c = collectives.quantize_int8(y_c)
    ef_c = y_c - collectives.dequantize_int8(q_c, scale_c)
    same = {"q": torch.equal(q.cpu(), q_c), "scale": torch.equal(scale.cpu(), scale_c),
            "ef": torch.equal(ef.cpu(), ef_c)}
    term = (scale_c.abs() * q_c.float().abs())
    mean_ok = bool(((mean.cpu() - scale_c * q_c.float()).abs() <= 1e-6 * term).all())
    print(f"card against the CPU's arithmetic: {same}; mean within 1e-6 of its term: {mean_ok}; "
          f"world {dist.get_world_size()}")
    check(all(same.values()) and mean_ok, f"compressed all-reduce differs: {same}, mean {mean_ok}")
    ms = device_ms_per_call(lambda: collectives.compressed_allreduce_mean(x, ef0, None), 10)
    bound = 16 * x.numel() / CARD_BYTES_PER_S * 1e3  # read x and ef, write mean and ef
    print(f"{ms:.4f} ms a call (card busy, profiled) against a bytes bound of {bound:.4f} ms "
          f"(x and ef read, mean and ef written, 16 B an element at 3.35 TB/s): "
          f"{bound / ms:.1%} of it  [{CARD}]", flush=True)
    del x, ef0, mean, ef, q
    _free()


def phase_mesh_checkpoint() -> None:
    """A mesh state of qwen2-1.5b at full width, 2 layers, one step on (1, 1),
    saved and restored onto the RDP (1, 1, 1) mesh: bitwise every leaf."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.runtime.train import jit_init_state, jit_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CHECK_LAYERS)
    phase(f"mesh checkpoint: {TRAIN_ARCH} at full width, {cfg.n_layers} layers, one step on "
          "(1, 1), saved, restored onto (1, 1, 1) ('replica', 'shard', 'model')")
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 1, RESTART_STEPS))
    mesh = make_mesh((1, 1), ("data", "model"))
    init, _ = jit_init_state(mesh, model, opt)
    step, _, _ = jit_train_step(mesh, model, opt, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                                                "train"))
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.global_batch(0).items()}
    state, _ = step(init(torch.Generator(device="cuda").manual_seed(SEED)), batch)
    ckdir = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    CheckpointManager(ckdir, keep=1).save(1, state)
    save_s = time.perf_counter() - t0
    rdp_mesh = make_mesh((1, 1, 1), ("replica", "shard", "model"))
    like = jit_init_state(rdp_mesh, model, opt)[0](
        torch.Generator(device="cuda").manual_seed(SEED + 1))
    restored, s = CheckpointManager(ckdir, keep=1).restore(like)
    want, got = _state_leaves(state), _state_leaves(restored)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    on_rdp = all(p.device_mesh.mesh_dim_names == ("replica", "shard", "model")
                 for p in restored.params.leaves().values())
    print(f"saved in {save_s:.2f} s; restored step {s} onto the RDP mesh ({on_rdp}): "
          f"{len(want)} leaves {'bitwise equal' if not differ else differ[:6]}", flush=True)
    check(s == 1 and on_rdp and not differ, f"mesh checkpoint restore differs at {differ[:6]}")
    del state, restored, like, want, got
    shutil.rmtree(ckdir, ignore_errors=True)
    _free()


# --------------------------------------------------------------------------
# tensor parallelism over "model": a group's ranks side by side on the card
# --------------------------------------------------------------------------


def _tp_serve(model, params, tokens, size: int):
    """Prefill the prompt, then TP_GEN - 1 teacher-forced decode steps: each
    step's whole logits.  ``size`` 1: the plain model; else every rank of a
    TP group of ``size``, one thread each, and every rank's logits."""
    import torch
    import torch_tp_threads as th

    def run(p):
        with torch.inference_mode():
            logits, cache, t = model.prefill(p, {"tokens": tokens[:, :SERVE_PROMPT]},
                                             SERVE_PROMPT + TP_GEN)
            out = [logits]
            for i in range(TP_GEN - 1):
                tok = tokens[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1]
                logits, cache, t = model.decode_step(p, cache, tok, t)
                out.append(logits)
        torch.cuda.synchronize()
        return out

    if size == 1:
        return run(params)
    trees = [th.rank_params(params, size, r) for r in range(size)]
    return th.run_ranks(size, lambda r, group: run(trees[r]))


def _tp_check_ranks(outs: list, want: list, dtype: str, what: str) -> float:
    """Every rank's logits the same; rank 0's against the plain path's (float32:
    2e-3 + 2e-3 |want|); the largest |difference|."""
    import torch

    worst = 0.0
    for r, got in enumerate(outs):
        check(all(torch.equal(a, b) for a, b in zip(got, outs[0])),
              f"{what}: rank {r}'s logits differ from rank 0's")
    for i, (g, w) in enumerate(zip(outs[0], want)):
        err = (g.float() - w.float()).abs()
        worst = max(worst, float(err.max()))
        check(bool(torch.isfinite(g).all()) and g.shape == w.shape,
              f"{what} step {i}: logits {tuple(g.shape)} not finite")
        if dtype == "float32":
            check(bool((err <= 2e-3 + 2e-3 * w.float().abs()).all()),
                  f"{what} step {i}: logits differ from the plain path's by {float(err.max())}")
    return worst


def _tp_attention_shapes(cfg, size: int) -> tuple:
    """(query slots, KV heads) of one rank's attention at TP ``size``."""
    from repro_torch.models import transformer

    lay = transformer._layout(cfg)
    hl = lay.h_pad // size  # rank 0's slots; in these layouts every rank's read one KV head
    return hl, (hl - 1) // lay.g_pad + 1, cfg.head_dim


# the kernels a TP phase counts by path: RMSNorm (the split row's two apart),
# attention (by kernel) and the attention backward kernels' calls
_TP_KERNELS = ("rmsnorm", "sumsq", "scaled", "flash_attention", "splitkv", "wgmma", "simt",
               "bwd")


def _launch_counter(total: dict):
    """``counted(fn, *args) -> (fn(*args), its launches)``: every count set to
    0 just before ``fn`` and read just after (synchronised), and added into
    ``total`` by kernel."""
    import torch

    from repro_torch.kernels import rmsnorm

    def counted(fn, *args):
        _reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        got = dict(_counts(), sumsq=rmsnorm.sumsq_launches, scaled=rmsnorm.scaled_launches)
        for k in _TP_KERNELS:
            total[k] += got[k]
        return out, {k: got[k] for k in _TP_KERNELS}

    return counted


def _tp_train_check(cfg, size: int, counted, seq: bool = False) -> dict:
    """One train step of ``cfg`` (float32, batch TRAIN_CHECK_BATCH x TRAIN_SEQ)
    on ``size`` thread ranks (``seq``: sequence parallelism on), every
    gradient, moment and parameter assembled from the rank shards and held
    to the plain step under ``train_step_mismatches``; the ranks' launches
    (through ``counted``, the plain step's not counted)."""
    import torch
    import torch_tp_threads as th
    from test_torch_train_cuda import LOSS_RTOL, step_record, train_step_mismatches

    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, apply_updates, cosine_with_warmup, global_norm
    from repro_torch.runtime.train import TrainState, _grad_norm, _value_and_grad

    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 1, TRAIN_STEPS))
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED)).trainable()
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(PipelineConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_CHECK_BATCH, seed=SEED)).global_batch(0).items()}
    state = TrainState(torch.zeros((), dtype=torch.int32, device="cuda"), params,
                       opt.init(params))
    want = step_record(state, batch, model, opt)
    want_norm = float(global_norm(want["grads"]))
    dims = th.sharded_dims(params.leaves(), size)

    def rank_step(r, group):
        p = th.rank_params(params, size, r, trainable=True)
        loss, _, grads = _value_and_grad(model, p, batch)
        gnorm = _grad_norm(grads, set(dims), group)
        updates, new, om = opt.update_shards(grads, opt.init(p), p, gnorm)
        return {"loss": loss, "grads": grads, "params": apply_updates(p.leaves(), updates),
                "m": new.m, "v": new.v, "old": p.leaves(), "count": new.count, "lr": om["lr"],
                "gnorm": gnorm}

    ranks, counts = counted(lambda: th.run_ranks(size, rank_step, seq=seq))
    got = {k: th.assemble([r[k] for r in ranks], dims) for k in ("grads", "params", "m", "v",
                                                                  "old")}
    got.update(loss=ranks[0]["loss"], count=ranks[0]["count"], lr=ranks[0]["lr"], opt=opt)
    stats: dict = {}
    bad = train_step_mismatches(got, want, stats)
    gnorm = float(ranks[0]["gnorm"])
    same = all(float(r["loss"]) == float(ranks[0]["loss"]) and float(r["gnorm"]) == gnorm
               for r in ranks)
    what = f"train step TP {size}{' with sequence parallelism' if seq else ''}"
    print(f"{what}: {cfg.name} full width, {cfg.n_layers} layers, float32, batch "
          f"{TRAIN_CHECK_BATCH} x {TRAIN_SEQ}: loss {float(got['loss']):.7f} vs plain "
          f"{float(want['loss']):.7f}, grad norm {gnorm:.7f} vs {want_norm:.7f}; {len(dims)} "
          f"leaves split over the ranks, every gradient assembled from the shards and held "
          f"with the moments and parameters under train_step_mismatches "
          f"({stats.get('beyond_param_tol')} elements held by their allowance); launches "
          f"{counts}  [{CARD}]", flush=True)
    check(not bad, f"{cfg.name} {what} against the plain step: {bad[:6]}")
    check(same and abs(gnorm - want_norm) <= LOSS_RTOL * want_norm,
          f"{cfg.name} {what}: grad norm {gnorm} (every rank the same: {same}) vs the plain "
          f"{want_norm}")
    del params, state, want, got, ranks
    return counts


def _tp_attention_vs_plain(seen_shapes, shapes_rec: dict, n: int) -> float:
    """Each rank-local attention shape ``(arch, size, pad, heads, kv_heads,
    head_dim, window)`` a TP run launched, prefill over SERVE_PROMPT keys and
    decode against the ``n``-slot ring, bf16 and float32, against its plain
    version (``close_by_row``) on the kernel the path takes; the bf16 shapes
    timed beside their bound into ``shapes_rec``.  Returns the max |err|."""
    import torch

    from repro_torch.kernels import flash_attention as flash

    max_err = 0.0
    for arch, size, pad, h, kh, hd, window in sorted(seen_shapes, key=str):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            for label, sq in (("prefill", SERVE_PROMPT), ("decode", 1)):
                q = _randn(torch, (1, sq, h, hd), dtype, SEED + 2)
                k = _randn(torch, (1, n if sq == 1 else sq, kh, hd), dtype, SEED + 3)
                v = _randn(torch, tuple(k.shape), dtype, SEED + 4)
                if sq == 1:
                    kv_pos = _ring_positions(torch, n, n - 1, n)
                    q_pos = torch.full((1, 1), n - 1, dtype=torch.int32, device="cuda")
                else:
                    q_pos = torch.arange(sq, dtype=torch.int32, device="cuda")[None]
                    kv_pos = q_pos.clone()
                want = flash.attention_ref(q, k, v, q_pos, kv_pos, True, window)
                before = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
                got = flash.attention(q, k, v, q_pos, kv_pos, True, window)
                path = _attention_path(flash, before)
                want_path = "splitkv" if sq == 1 else ("wgmma" if name == "bfloat16" else "simt")
                ok, row = close_by_row(got, want, name)
                err = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, err)
                tag = f"{arch} TP {size} {label} q {tuple(q.shape)} kv {tuple(k.shape)} {name}"
                check(ok and path == want_path, f"attention {tag}: on {path} (want {want_path}),"
                                                f" |err| / (|want| + row RMS) {row}")
                if name == "bfloat16":
                    ms = device_ms_per_call(
                        lambda: flash.attention(q, k, v, q_pos, kv_pos, True, window), iters=20)
                    plain_ms = device_ms_per_call(
                        lambda: flash.attention_ref(q, k, v, q_pos, kv_pos, True, window),
                        iters=5)
                    bnd, by = _attention_bound(torch, q, k, q_pos, kv_pos, True, window)
                    shapes_rec[f"{arch} tp{size} {label}"] = {
                        "shape": [list(q.shape), list(k.shape)], "path": path, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                        "max_abs_err": err}
                    print(f"{tag} on {path}: within ROW_RTOL ({row:.2e}); device ms kernel "
                          f"{ms:.5f}, plain {plain_ms:.5f}; bound {bnd:.5f} ({by}), kernel at "
                          f"{bnd / ms:.2%} of bound  [{CARD}]", flush=True)
                else:
                    print(f"{tag} on {path}: within ROW_RTOL ({row:.2e})", flush=True)
                del q, k, v, want, got
    _free()
    return max_err


def phase_tensor_parallel() -> dict:
    """Tensor parallelism over "model": size 1 through the mesh serve step;
    then qwen2-1.5b's serving at TP 2 and TP 4, qwen3-moe's at TP 4 and a
    qwen2-1.5b train step at TP 2, every rank a thread on the one card; the
    rank-local attention shapes against their plain versions."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.serve import jit_prefill, jit_serve_step

    t_phase = time.perf_counter()
    n = SERVE_PROMPT + TP_GEN
    phase(f"tensor parallelism over 'model': the plain ring on (1, 1) bitwise; {SERVE_ARCH} "
          f"served whole at TP {[s for s, _ in TP_SERVE]}, {TP_MOE_ARCH} at {TP_MOE_DEPTH} "
          f"layers at TP {TP_MOE_SIZE}, a train step at TP {TP_TRAIN_SIZE}; every rank a "
          "thread on the one card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec: dict = {"launches": dict.fromkeys(_TP_KERNELS, 0), "shapes": {}, "serve": {}}
    seen_shapes: set = set()

    counted = _launch_counter(rec["launches"])

    # size 1: the plain ring through the mesh serve step, bitwise the plain model
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    mesh = make_mesh((1, 1), ("data", "model"))
    prefill, p_sh, _, c_sh = jit_prefill(mesh, model, ShapeConfig("p", n, 1, "prefill"))
    step, _, _, _ = jit_serve_step(mesh, model, ShapeConfig("d", n, 1, "decode"))
    dparams = params.replace_leaves({k: sharding.distribute(p, p_sh[k])
                                     for k, p in params.leaves().items()})
    want = _tp_serve(model, params, tokens, 1)
    with torch.inference_mode():
        got, cache, t = prefill(dparams, {"tokens": tokens[:, :SERVE_PROMPT]})
        same = [torch.equal(got, want[0])]
        for i in range(TP_GEN - 1):
            got, cache, t = step(dparams, cache, tokens[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1],
                                 t)
            same.append(torch.equal(got, want[i + 1]))
    print(f"size 1: {SERVE_ARCH} bf16 plain ring through jit_prefill / jit_serve_step on (1, 1), "
          f"cache {c_sh[0]['k'].spec}: {sum(same)} of {len(same)} steps' logits bitwise the "
          "plain model's", flush=True)
    check(all(same), f"the size-1 mesh serve step differs from the plain model at steps "
                     f"{[i for i, ok in enumerate(same) if not ok]}")
    del params, dparams, cache, want
    _free()

    # every rank of a group side by side: qwen2-1.5b served whole
    for size, pad in TP_SERVE:
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(SERVE_ARCH, compute_dtype=dtype, pad_heads_to=pad)
            model = build_model(cfg)
            params = model.for_serving(model.init(
                torch.Generator(device="cuda").manual_seed(SEED)))
            t0 = time.perf_counter()
            want = _tp_serve(model, params, tokens, 1)
            plain_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs, counts = counted(_tp_serve, model, params, tokens, size)
            tp_s = time.perf_counter() - t0
            what = f"{SERVE_ARCH} {dtype} TP {size} (pad_heads_to={pad})"
            worst = _tp_check_ranks(outs, want, dtype, what)
            per = size * TP_GEN
            want_counts = {"rmsnorm": per * (2 * cfg.n_layers + 1),
                           "flash_attention": per * cfg.n_layers,
                           "splitkv": size * (TP_GEN - 1) * cfg.n_layers,
                           "wgmma" if dtype == "bfloat16" else "simt": size * cfg.n_layers}
            shape = _tp_attention_shapes(cfg, size)
            seen_shapes.add((SERVE_ARCH, size, pad) + shape + (None,))
            print(f"{what}: {shape[0]} query slots over {shape[1]} KV head(s) a rank; max "
                  f"|TP - plain| {worst:.3e} over {TP_GEN} steps' {cfg.padded_vocab} logits; "
                  f"launches {counts} (expected {want_counts}); host s: plain {plain_s:.2f}, "
                  f"{size} ranks {tp_s:.2f}  [{CARD}]", flush=True)
            check(all(counts[k] == v for k, v in want_counts.items()),
                  f"{what}: launches {counts}, expected {want_counts}")
            rec["serve"][f"{SERVE_ARCH} tp{size} {dtype}"] = worst
            del params, want, outs
            _free()

    # qwen3-moe at 2 layers, TP 4: 16 query heads over 1 KV head, 32 experts a rank
    for dtype in ("float32", "bfloat16"):
        cfg = _zoo_config(TP_MOE_ARCH, TP_MOE_DEPTH, compute_dtype=dtype,
                          param_dtype=dtype)
        model = build_model(cfg)
        params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
        want = _tp_serve(model, params, tokens, 1)
        outs, counts = counted(_tp_serve, model, params, tokens, TP_MOE_SIZE)
        what = f"{TP_MOE_ARCH} {TP_MOE_DEPTH} layers {dtype} TP {TP_MOE_SIZE}"
        worst = _tp_check_ranks(outs, want, dtype, what)
        shape = _tp_attention_shapes(cfg, TP_MOE_SIZE)
        seen_shapes.add((TP_MOE_ARCH, TP_MOE_SIZE, 0) + shape + (None,))
        experts = cfg.n_experts // TP_MOE_SIZE
        print(f"{what}: {shape[0]} query slots over {shape[1]} KV head(s) and {experts} experts "
              f"a rank; max |TP - plain| {worst:.3e}; launches {counts}  [{CARD}]", flush=True)
        check(counts["flash_attention"] == TP_MOE_SIZE * TP_GEN * cfg.n_layers
              and counts["splitkv"] == TP_MOE_SIZE * (TP_GEN - 1) * cfg.n_layers,
              f"{what}: launches {counts}")
        rec["serve"][f"{TP_MOE_ARCH} tp{TP_MOE_SIZE} {dtype}"] = worst
        del params, want, outs
        _free()

    # one train step at TP 2: full width, 2 layers, float32
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, param_dtype="float32",
                                         compute_dtype="float32"), n_layers=TRAIN_CHECK_LAYERS)
    counts = _tp_train_check(cfg, TP_TRAIN_SIZE, counted)
    # float32: the backward takes the plain closed form, no backward kernel
    check(counts["flash_attention"] == TP_TRAIN_SIZE * 2 * cfg.n_layers
          and counts["rmsnorm"] == TP_TRAIN_SIZE * (4 * cfg.n_layers + 1)
          and counts["bwd"] == 0, f"TP train step launches {counts}")
    _free()

    # the rank-local attention shapes, against their plain versions
    rec["max_abs_err"] = _tp_attention_vs_plain(seen_shapes, rec["shapes"], n)
    _free()
    print(f"tensor parallelism: {time.perf_counter() - t_phase:.1f} s; the TP path's launches "
          f"{rec['launches']}", flush=True)
    return rec


def _split_norm_vs_plain() -> dict:
    """The split-row RMSNorm (``rmsnorm_sumsq`` then ``rmsnorm_scaled``) at
    mamba2-2.7b's rank shapes: d_inner 5120 over TP 2 and 4 (2560 and 1280
    columns a rank), a prefill's 1024 rows and a decode's one, bf16 and
    float32, plain and ``plus_one``.  Each rank's row sums against the plain
    version's (relative ``TOL``), its normalised columns against the plain
    version on the same totals (``TOL`` and ``ROW_RTOL``), and the ranks'
    columns together against ``rms_norm_ref`` of the whole row; the bf16
    pair timed beside its bytes bound, its plain version and ``F.rms_norm``
    on the whole row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm

    out: dict = {"max_abs_err": 0.0, "shapes": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for rows in (SERVE_PROMPT, 1):
            x = _randn(torch, (rows, ZOO_D_INNER), dtype, SEED + 11)
            for size in (2, 4):
                d = ZOO_D_INNER // size
                parts = [x[:, r * d:(r + 1) * d].contiguous() for r in range(size)]
                sums = [rmsnorm.row_sumsq(xp) for xp in parts]
                for r, (xp, ss) in enumerate(zip(parts, sums)):
                    want = rmsnorm.row_sumsq_ref(xp)
                    rel = float(((ss - want).abs() / want.abs().clamp_min(1e-30)).max())
                    check(rel <= TOL["float32"], f"rmsnorm_sumsq {name} ({rows}, {d}) rank {r}: "
                                                 f"relative |err| {rel}")
                total = sum(sums)
                for w_dtype in (dtype, torch.float32):
                    w = _randn(torch, (ZOO_D_INNER,), w_dtype, SEED + 12, 0.1)
                    for plus_one in (False, True):
                        got = [rmsnorm.rms_norm_scaled(xp, w[r * d:(r + 1) * d].contiguous(),
                                                       total, ZOO_D_INNER, plus_one=plus_one)
                               for r, xp in enumerate(parts)]
                        what = (f"split-row rmsnorm {name} ({rows}, {d}) of {ZOO_D_INNER} w "
                                f"{w_dtype} plus_one={plus_one}")
                        for r, (g, xp) in enumerate(zip(got, parts)):
                            want = rmsnorm.rms_norm_split_ref(
                                xp, w[r * d:(r + 1) * d], total, ZOO_D_INNER, plus_one=plus_one)
                            ok, err = close_to(g, want, name)
                            out["max_abs_err"] = max(out["max_abs_err"], err)
                            check(ok, f"{what} rank {r}: max |err| {err} beyond TOL")
                            ok, row = close_by_row(g, want, name)
                            check(ok, f"{what} rank {r}: beyond ROW_RTOL ({row})")
                        whole = rmsnorm.rms_norm_ref(x, w, plus_one=plus_one)
                        ok, row = close_by_row(torch.cat(got, -1), whole, name)
                        check(ok, f"{what}: the ranks' columns against the whole row's norm, "
                                  f"beyond ROW_RTOL ({row})")
                if dtype != torch.bfloat16:
                    continue
                xp, wp = parts[0], _randn(torch, (d,), dtype, SEED + 12, 0.1)

                def kernel_pair(xp=xp, wp=wp, total=total):
                    rmsnorm.row_sumsq(xp)
                    return rmsnorm.rms_norm_scaled(xp, wp, total, ZOO_D_INNER)

                def plain_pair(xp=xp, wp=wp, total=total):
                    rmsnorm.row_sumsq_ref(xp)
                    return rmsnorm.rms_norm_split_ref(xp, wp, total, ZOO_D_INNER)

                # x read once, w read once, the rank's columns written once; the
                # row sums written and read back (float32)
                n_bytes = 2 * xp.numel() * xp.element_size() + d * wp.element_size() + 8 * rows
                bnd, by = bound_ms(n_bytes, 6 * xp.numel(), CARD_F32_FLOP_PER_S)
                ms = device_ms_per_call(kernel_pair, iters=50, floor_ms=bnd)
                plain_ms = device_ms_per_call(plain_pair, iters=50, floor_ms=bnd)
                ww = _randn(torch, (ZOO_D_INNER,), dtype, SEED + 12, 0.1)
                whole_bnd = bound_ms(2 * x.numel() * x.element_size() + ZOO_D_INNER
                                     * ww.element_size(), 4 * x.numel(), CARD_F32_FLOP_PER_S)[0]
                lib_ms = device_ms_per_call(lambda: F.rms_norm(x, (ZOO_D_INNER,), ww, eps=1e-6),
                                            iters=50, floor_ms=whole_bnd) \
                    if hasattr(F, "rms_norm") else None
                lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "not available"
                key = f"({rows}, {d})"
                out["shapes"][key] = {"shape": [rows, d], "width": ZOO_D_INNER, "ms": ms,
                                      "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                                      "library_ms": lib_ms}
                print(f"split-row rmsnorm bf16 {key} of {ZOO_D_INNER} (TP {size}): device time "
                      f"per call, rmsnorm_sumsq + rmsnorm_scaled {ms:.5f} ms, plain {plain_ms:.5f}"
                      f" ms, F.rms_norm on the whole ({rows}, {ZOO_D_INNER}) row {lib}; bound "
                      f"{bnd:.5f} ms ({by}), the pair at {bnd / ms:.1%} of bound  [{CARD}]",
                      flush=True)
        print(f"{name}: split-row rmsnorm at TP 2 and 4, 1024 rows and one, every weight dtype "
              f"and plus_one within TOL and ROW_RTOL", flush=True)
    _free()
    return out


def _tp_rec_counts(cfg, size: int) -> dict:
    """The launches of a served run (a prefill and TP_GEN - 1 decode steps)
    of ``cfg`` on ``size`` thread ranks: mamba2's norm1 a layer and the final
    norm fused, its gated norm a split row (``rmsnorm_sumsq`` +
    ``rmsnorm_scaled``) a layer; the hybrid's norms fused and its attention
    layers' kernels."""
    per = size * TP_GEN
    if cfg.family == "ssm":
        split = per * cfg.n_layers
        return {"rmsnorm": per * (cfg.n_layers + 1) + 2 * split, "sumsq": split,
                "scaled": split, "flash_attention": 0}
    rms, n_attn = _zoo_per_forward(cfg)
    dt = cfg.dtype("compute")
    return {"rmsnorm": per * rms, "sumsq": 0, "scaled": 0, "flash_attention": per * n_attn,
            "splitkv": size * (TP_GEN - 1) * n_attn,
            "wgmma" if str(dt) == "torch.bfloat16" else "simt": size * n_attn}


def phase_tp_recurrent() -> dict:
    """Tensor parallelism for the state-space and hybrid families: the
    split-row RMSNorm against its plain version at mamba2's rank shapes;
    mamba2-2.7b and recurrentgemma-2b served whole at TP 2 and 4 (the hybrid's
    TP 4 with ``pad_heads_to=4``), float32 and bf16, every rank a thread on the
    one card; a TP 2 train step of each; the hybrid's rank-local attention
    shapes against their plain versions."""
    import torch

    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    n = SERVE_PROMPT + TP_GEN
    phase(f"tensor parallelism for the state-space and RG-LRU families: the split-row RMSNorm "
          f"at d_inner {ZOO_D_INNER} / TP; {[a for a, _ in TP_REC]} served at TP "
          f"{[s for s, _ in TP_REC[0][1]]} (bf16 whole, float32 at {TP_REC_F32_DEPTH} layers; "
          f"prompt {SERVE_PROMPT}, {TP_GEN} tokens); a train step of each at TP {TP_TRAIN_SIZE}; "
          "every rank a thread on the one card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec: dict = {"launches": dict.fromkeys(_TP_KERNELS, 0), "shapes": {}, "serve": {},
                 "split": _split_norm_vs_plain()}
    print(f"split-row RMSNorm checks: {time.perf_counter() - t_phase:.1f} s", flush=True)
    counted = _launch_counter(rec["launches"])
    seen_shapes: set = set()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    vocab = min(_zoo_config(arch).vocab_size for arch, _ in TP_REC)
    tokens = torch.randint(0, vocab, (1, n), generator=gen, device="cuda", dtype=torch.int32)
    for arch, layouts in TP_REC:
        for dtype in ("float32", "bfloat16"):
            plain = None  # (pad, cfg, model, params, want, plain_s), reused across TP sizes
            for size, pad in layouts:
                if plain is None or plain[0] != pad:
                    plain = None
                    _free()
                    t_made = time.perf_counter()
                    depth = TP_REC_F32_DEPTH[arch] if dtype == "float32" else None
                    cfg = _zoo_config(arch, depth, compute_dtype=dtype, pad_heads_to=pad)
                    model = build_model(cfg)
                    params = model.for_serving(model.init(
                        torch.Generator(device="cuda").manual_seed(SEED)))
                    t0 = time.perf_counter()
                    want = _tp_serve(model, params, tokens, 1)
                    plain = (pad, cfg, model, params, want, time.perf_counter() - t0)
                    print(f"{arch} {dtype} weights made and served plain: "
                          f"{time.perf_counter() - t_made:.1f} s", flush=True)
                _, cfg, model, params, want, plain_s = plain
                t0 = time.perf_counter()
                outs, counts = counted(_tp_serve, model, params, tokens, size)
                tp_s = time.perf_counter() - t0
                what = f"{arch} {dtype} {cfg.n_layers} layers TP {size} (pad_heads_to={pad})"
                worst = _tp_check_ranks(outs, want, dtype, what)
                want_counts = _tp_rec_counts(cfg, size)
                if cfg.family == "hybrid":
                    heads = _tp_attention_shapes(cfg, size)
                    seen_shapes.add((arch, size, pad) + heads + (cfg.window,))
                    shape = f"{heads[0]} query slots over {heads[1]} KV head(s) a rank; "
                else:
                    shape = (f"{cfg.ssm_expand * cfg.d_model // size} d_inner channels and "
                             f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim // size} heads "
                             "a rank; ")
                print(f"{what}: {shape}max |TP - plain| {worst:.3e} over {TP_GEN} steps' "
                      f"{cfg.padded_vocab} logits; launches {counts} (expected {want_counts}); "
                      f"host s: plain {plain_s:.2f}, {size} ranks {tp_s:.2f}  [{CARD}]",
                      flush=True)
                check(all(counts[k] == v for k, v in want_counts.items()),
                      f"{what}: launches {counts}, expected {want_counts}")
                rec["serve"][f"{arch} tp{size} {dtype}"] = worst
                del params, want, outs, model
            del plain
            _free()
    for arch, _ in TP_REC:
        cfg = dataclasses.replace(_zoo_config(arch, param_dtype="float32",
                                              compute_dtype="float32"),
                                  n_layers=TP_REC_TRAIN_LAYERS[arch])
        t0 = time.perf_counter()
        counts = _tp_train_check(cfg, TP_TRAIN_SIZE, counted)
        print(f"{arch} train step check: {time.perf_counter() - t0:.1f} s", flush=True)
        remat = 2 if cfg.remat else 1  # each layer's forward again in the backward
        if cfg.family == "ssm":
            split = TP_TRAIN_SIZE * remat * cfg.n_layers
            check(counts["sumsq"] == counts["scaled"] == split
                  and counts["rmsnorm"] == 2 * split + TP_TRAIN_SIZE * (
                      remat * cfg.n_layers + 1),
                  f"{arch} TP train step launches {counts}")
        else:
            check(counts["flash_attention"] > 0 and counts["sumsq"] == 0 and counts["bwd"] == 0,
                  f"{arch} TP train step launches {counts}")
        _free()
    rec["max_abs_err"] = max(_tp_attention_vs_plain(seen_shapes, rec["shapes"], n),
                             rec["split"]["max_abs_err"])
    print(f"tensor parallelism, state-space and RG-LRU: {time.perf_counter() - t_phase:.1f} s; "
          f"the path's launches {rec['launches']}", flush=True)
    return rec


def phase_sequence_parallel() -> dict:
    """Sequence parallelism: qwen2-1.5b whole at TP SP_SIZE with
    ``sequence_parallel=True``, a prefill of SERVE_PROMPT tokens (the rows
    split over the ranks) within 2e-3 + 2e-3 |want| of the plain path
    (float32), every rank's logits the same; and a train step at 2 layers
    under ``train_step_mismatches``."""
    import torch
    import torch_tp_threads as th

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    phase(f"sequence parallelism: {SERVE_ARCH} whole at TP {SP_SIZE} with "
          f"sequence_parallel=True, a prefill of {SERVE_PROMPT} tokens (float32) against the "
          f"plain path, and a train step at {TRAIN_CHECK_LAYERS} layers")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec: dict = {"launches": dict.fromkeys(_TP_KERNELS, 0)}
    counted = _launch_counter(rec["launches"])
    cfg = get_config(SERVE_ARCH, compute_dtype="float32", sequence_parallel=True)
    model = build_model(cfg)
    params = model.for_serving(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    tokens = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)

    def prefill(p):
        with torch.inference_mode():
            logits, _, _ = model.prefill(p, {"tokens": tokens}, SERVE_PROMPT)
        torch.cuda.synchronize()
        return [logits]

    want = prefill(params)  # no context: the plain path
    trees = [th.rank_params(params, SP_SIZE, r) for r in range(SP_SIZE)]
    outs, counts = counted(lambda: th.run_ranks(SP_SIZE, lambda r, g: prefill(trees[r]),
                                                seq=True))
    worst = _tp_check_ranks(outs, want, "float32", f"{SERVE_ARCH} TP {SP_SIZE} SP prefill")
    per = SP_SIZE * (2 * cfg.n_layers + 1)
    print(f"{SERVE_ARCH} float32 TP {SP_SIZE} with sequence parallelism: a prefill of "
          f"{SERVE_PROMPT} tokens, {SERVE_PROMPT // SP_SIZE} rows a rank between the regions; "
          f"max |SP - plain| {worst:.3e} over {cfg.padded_vocab} logits; launches {counts}  "
          f"[{CARD}]", flush=True)
    check(counts["rmsnorm"] == per and counts["flash_attention"] == SP_SIZE * cfg.n_layers,
          f"SP prefill launches {counts}, expected {per} RMSNorm")
    rec["prefill_max_abs"] = worst
    del params, trees, want, outs, model
    _free()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, param_dtype="float32",
                                         compute_dtype="float32", sequence_parallel=True),
                              n_layers=TRAIN_CHECK_LAYERS)
    counts = _tp_train_check(cfg, SP_SIZE, counted, seq=True)
    check(counts["flash_attention"] == SP_SIZE * 2 * cfg.n_layers and counts["bwd"] == 0,
          f"SP train step launches {counts}")
    _free()
    print(f"sequence parallelism: {time.perf_counter() - t_phase:.1f} s; the path's launches "
          f"{rec['launches']}", flush=True)
    return rec


DRY_TP_LAYERS = 2  # the TP 2 remat-policy step: layers at full width, float32
OP_HOST_CALLS = 2000  # calls a host-time reading of a custom operator takes


def _op_host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn`` (launched back to back in batches
    of 200, each batch ended by a synchronise outside the clock)."""
    import torch

    total = 0.0
    for _ in range(calls // 200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (calls // 200 * 200) * 1e6


def _custom_op_host_cost() -> dict:
    """Host µs a call of each of the four custom operators through the
    dispatcher, of its public wrapper (which launches directly where no
    dispatch mode is on: ``flash_attention.unobserved``) and of the direct
    ctypes launch (``_launch``), at decode shapes (the host-bound path), in
    the order direct, operator, wrapper, wrapper, operator, direct; medians."""
    import torch

    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm

    dev = "cuda"
    x = _randn(torch, (1, 2560), torch.bfloat16, 31)
    w = _randn(torch, (2560,), torch.bfloat16, 32)
    total = rmsnorm.row_sumsq(x) * 2
    q = _randn(torch, (1, 1, 12, 128), torch.bfloat16, 33)
    k = _randn(torch, (1, 1056, 2, 128), torch.bfloat16, 34)
    qpos = torch.full((1, 1), 1055, dtype=torch.int32, device=dev)
    kpos = torch.arange(1056, dtype=torch.int32, device=dev)[None]
    out = torch.empty_like(q)
    ops = torch.ops.repro_torch
    cases = {
        "attention": (lambda: ops.attention(q, k, k, qpos, kpos, True, None, None, False),
                      lambda: flash.attention(q, k, k, qpos, kpos),
                      lambda: flash._launch(q, k, k, qpos, kpos, out, True, None, None)),
        "rms_norm": (lambda: ops.rms_norm(x, w, 1e-6, False),
                     lambda: rmsnorm.rms_norm_fused(x, w),
                     lambda: rmsnorm._launch(x, w, 1e-6, False)),
        "row_sumsq": (lambda: ops.row_sumsq(x), lambda: rmsnorm.row_sumsq(x),
                      lambda: rmsnorm._launch_sumsq(x)),
        "rms_norm_scaled": (lambda: ops.rms_norm_scaled(x, w, total, 5120, 1e-6, False),
                            lambda: rmsnorm.rms_norm_scaled(x, w, total, 5120),
                            lambda: rmsnorm._launch(x, w, 1e-6, False, total, 5120)),
    }
    rec = {}
    for name, (op, wrapper, direct) in cases.items():
        for fn in (op, wrapper, direct):  # warm every path
            fn()
        runs = {"direct": [], "op": [], "wrapper": []}
        for which in ("direct", "op", "wrapper", "wrapper", "op", "direct"):
            fn = {"direct": direct, "op": op, "wrapper": wrapper}[which]
            runs[which].append(_op_host_us(fn, OP_HOST_CALLS))
        rec[name] = {f"{k}_us": statistics.median(v) for k, v in runs.items()}
        rec[name]["runs"] = runs
        print(f"  custom op {name}: host µs a call, through the dispatcher "
              f"{rec[name]['op_us']:.2f} {runs['op']}, the wrapper {rec[name]['wrapper_us']:.2f} "
              f"{runs['wrapper']}, the direct launch {rec[name]['direct_us']:.2f} "
              f"{runs['direct']}; {OP_HOST_CALLS} calls each  [{CARD}]", flush=True)
    return rec


def phase_dryrun_vs_card() -> dict:
    """The dry run against the card (world of one, inside the mesh phases'
    NCCL group): qwen2-1.5b whole at phase 15's training shape (batch
    TRAIN_BATCH x TRAIN_SEQ, bf16 compute, f32 master weights, remat) through
    ``jit_train_step`` on (1, 1).  ``launch/dryrun.py::predict_step`` on
    ``meta`` tensors predicts the step; the same step then runs on the card
    (one warm-up step first) under ``FlopCounterMode`` and a profiler trace:
    the predicted launches by kernel equal the trace's kernels and the
    wrappers' counts exactly, the predicted FLOPs equal ``FlopCounterMode``'s
    exactly, and the predicted peak of live bytes is printed beside
    ``torch.cuda.max_memory_allocated()``.  Then a TP 2 thread-rank step
    (DRY_TP_LAYERS layers, float32) under ``remat_policy="block_outs"``:
    gradients bitwise ``"full"``'s, no sum over the model group in the
    recompute; and the custom operators' host µs a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from test_torch_dryrun_cuda import kernel_counts, remat_sums, smoke_batch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    phase(f"the dry run against the card: {TRAIN_ARCH} whole ({cfg.n_layers} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.compute_dtype} compute, f32 master, remat) "
          "through jit_train_step on (1, 1): the meta prediction against one step on the card; "
          f"block_outs at TP 2 ({DRY_TP_LAYERS} layers, float32); the custom ops' host cost")
    props = torch.cuda.get_device_properties(0)
    print(f"device memory: torch.cuda.get_device_properties(0).total_memory = "
          f"{props.total_memory} bytes; the dry run holds cells to "
          f"{dryrun.H100_MEMORY_BYTES}; {props.multi_processor_count} SMs  [{CARD}]", flush=True)
    check(props.total_memory == dryrun.H100_MEMORY_BYTES,
          f"the card reads {props.total_memory} bytes of device memory, the dry run's "
          f"constant is {dryrun.H100_MEMORY_BYTES}")
    check(props.multi_processor_count == flash.H100_SM_COUNT,
          f"the card has {props.multi_processor_count} SMs, the split-KV plan of a "
          f"meta tensor assumes {flash.H100_SM_COUNT}")
    model = build_model(cfg)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    pred = dryrun.predict_step(model, shape, mesh)
    pred_s = time.perf_counter() - t0
    want = pred["step_stats"]
    _free()
    step, args, roots, mem = dryrun.build_step(model, shape, mesh, device="cuda")
    del roots
    out = step(*args)  # warm-up: cuBLAS workspaces, the kernels' libraries
    del out
    torch.cuda.synchronize()
    measured = None
    for attempt in range(3):
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(0)
            with FlopCounterMode(display=False) as fc:
                out = step(*args)
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out
        wrappers = dict(_counts(), sumsq=rmsnorm.sumsq_launches, scaled=rmsnorm.scaled_launches)
        wrappers["rmsnorm"] -= wrappers["sumsq"] + wrappers["scaled"]
        # a backward call launches each of its three kernels once
        wrappers.update(dict.fromkeys(("bwd_delta", "bwd_dkdv", "bwd_dq"), wrappers["bwd"]))
        cuda = torch.autograd.DeviceType.CUDA
        traced = kernel_counts(e.name() for e in prof.profiler.kineto_results.events()
                               if e.device_type() == cuda)
        counted = {k: wrappers[k] for k in traced}
        if traced == counted:
            measured = traced
            break
        print(f"  the trace's kernels {traced} fall short of the wrappers' {counted}: the "
              "step traced again", flush=True)
    check(measured is not None, "three profiler traces of the step lost kernel events")
    flops = fc.get_total_flops()
    gap = (want["peak_bytes"] - peak) / peak * 100
    print(f"prediction ({pred_s:.2f} s on meta tensors): launches {want['launches_by_kernel']}, "
          f"FLOPs {want['flops']:.0f} (attention {want['attention_flops']:.0f}), peak "
          f"{want['peak_bytes'] / 1e9:.3f} GB of live bytes (state {mem['state_bytes'] / 1e9:.3f} "
          f"GB, batch {mem['batch_bytes']} B)", flush=True)
    print(f"the card: launches {measured} (profiler) and {counted} (wrappers), FLOPs "
          f"{flops:.0f} (FlopCounterMode), torch.cuda.max_memory_allocated() "
          f"{peak / 1e9:.3f} GB; the prediction's peak {gap:+.2f} % of the measured  [{CARD}]",
          flush=True)
    check(measured == want["launches_by_kernel"],
          f"launches by kernel: predicted {want['launches_by_kernel']}, the card {measured}")
    check(flops == want["flops"], f"FLOPs: predicted {want['flops']}, FlopCounterMode {flops}")
    check(measured["bwd_dq"] == cfg.n_layers,
          f"{measured['bwd_dq']} backward kernel calls in the dry run's step, not one a layer")
    rec = {"launches": {"rmsnorm": measured["rmsnorm"] + measured["sumsq"] + measured["scaled"],
                        "flash_attention": sum(measured[k] for k in ("splitkv", "wgmma", "simt")),
                        "bwd": measured["bwd_dq"], **measured},
           "flops": flops, "peak_bytes": peak, "predicted_peak_bytes": want["peak_bytes"],
           "peak_gap_pct": gap}
    del step, args, pred
    _free()

    # the remat policy at TP 2 on thread ranks
    out = {}
    for policy in ("full", "block_outs"):
        tcfg = dataclasses.replace(get_config(TRAIN_ARCH, param_dtype="float32",
                                              compute_dtype="float32", remat_policy=policy),
                                   n_layers=DRY_TP_LAYERS)
        tmodel = build_model(tcfg)
        params = tmodel.init(torch.Generator(device="cuda").manual_seed(SEED))
        out[policy] = remat_sums(tmodel, params, smoke_batch(tcfg, TRAIN_CHECK_BATCH, TRAIN_SEQ,
                                                             "cuda", SEED), 2)
        del params, tmodel
    sums = {p: [r[1] for r in out[p]] for p in out}
    differ = [k for f, b in zip(out["full"], out["block_outs"]) for k, g in f[3].items()
              if not torch.equal(g, b[3][k])]
    same_loss = all(torch.equal(f[2], b[2]) for f, b in zip(out["full"], out["block_outs"]))
    print(f"remat policy at TP 2 ({DRY_TP_LAYERS} layers, float32, batch {TRAIN_CHECK_BATCH} x "
          f"{TRAIN_SEQ}): sums over the model group in the backward's recompute, by rank: "
          f"'full' {sums['full']}, 'block_outs' {sums['block_outs']}; forward sums "
          f"{[r[0] for r in out['full']]}; gradients "
          f"{'bitwise equal' if not differ else differ[:4]}, loss "
          f"{'bitwise equal' if same_loss else 'differs'}  [{CARD}]", flush=True)
    check(not differ and same_loss, f"block_outs against full at TP 2: {differ[:4]}")
    check(all(n == 0 for n in sums["block_outs"]) and all(n == DRY_TP_LAYERS
                                                            for n in sums["full"]),
          f"recompute sums: full {sums['full']}, block_outs {sums['block_outs']}")
    rec["remat_sums"] = sums
    del out
    _free()
    rec["op_host_us"] = _custom_op_host_cost()
    print(f"dry run against the card: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rec


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
        t_train = time.perf_counter()
        train_rec = phase_train_kernels()
        train_launches = phase_train_full()
        phase_train_card_vs_cpu()
        phase_train_restart()
        print(f"\ntraining: {time.perf_counter() - t_train:.1f} s; the whole script "
              f"{time.perf_counter() - T0:.1f} s so far", flush=True)
        t_mesh = time.perf_counter()
        phase_mesh_init()
        try:
            mesh_train = phase_mesh_train()
            mesh_serve = phase_mesh_serve()
            phase_mesh_allreduce()
            phase_mesh_checkpoint()
            tp_rec = phase_tensor_parallel()
            rec_rec = phase_tp_recurrent()
            sp_rec = phase_sequence_parallel()
            dry_rec = phase_dryrun_vs_card()
        finally:
            torch.distributed.destroy_process_group()
        print(f"\nmesh paths: {time.perf_counter() - t_mesh:.1f} s; the whole script "
              f"{time.perf_counter() - T0:.1f} s so far", flush=True)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the mesh train steps' launches, and the seq-sharded serving path's (both dtypes)
    mesh_launches = {k: mesh_train["launches"][k] + sum(mesh_serve[d][k] for d in mesh_serve)
                     for k in ("rmsnorm", "flash_attention")}
    # tensor parallelism: the transformer families', the state-space and
    # hybrid families', and sequence parallelism's paths
    tp_launches = {k: tp_rec["launches"][k] + rec_rec["launches"][k] + sp_rec["launches"][k]
                   for k in _TP_KERNELS}
    # the dry run's real step on the card (phase 20)
    dry_launches = dry_rec["launches"]
    rows = [
        # name, record, launches on the main paths, replaces
        ("masked_cover", cover_rec,
         sum(sum(d.values()) for d in path_launches) + serve_launches["masked_cover"]
         + zoo_launches["masked_cover"],
         "cover.cu", "src/repro/kernels/cover.py:47"),
        ("rmsnorm", dict(rms_rec, max_abs_err=max(rms_rec["max_abs_err"],
                                                  zoo_rms_rec["max_abs_err"],
                                                  train_rec["rmsnorm"]["max_abs_err"],
                                                  rec_rec["split"]["max_abs_err"])),
         serve_launches["rmsnorm"] + zoo_launches["rmsnorm"] + train_launches["rmsnorm"]
         + mesh_launches["rmsnorm"] + tp_launches["rmsnorm"] + dry_launches["rmsnorm"],
         "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:31"),
        ("flash_attention", dict(att_rec, max_abs_err=max(
            att_rec["max_abs_err"], train_rec["flash_attention"]["max_abs_err"],
            tp_rec["max_abs_err"], rec_rec["max_abs_err"])),
         serve_launches["flash_attention"] + zoo_launches["flash_attention"]
         + train_launches["flash_attention"] + mesh_launches["flash_attention"]
         + tp_launches["flash_attention"] + dry_launches["flash_attention"],
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
        + (train_launches["wgmma"] + mesh_train["launches"]["wgmma"] if k == "wgmma" else 0)
        + sum(mesh_serve[d][k] for d in mesh_serve) + tp_launches[k] + dry_launches[k]
        for k in ("splitkv", "wgmma", "simt")}
    # the model zoo's new shapes: RMSNorm at d_inner 5120, attention at hd 80
    kernels[1]["zoo"] = {k: zoo_rms_rec[k] for k in ("prefill", "decode")}
    kernels[2]["zoo"] = att_rec["zoo"]
    kernels[1]["launches_by_path"] = {"serve": serve_launches["rmsnorm"],
                                      "zoo": zoo_launches["rmsnorm"],
                                      "train": train_launches["rmsnorm"],
                                      "mesh": mesh_launches["rmsnorm"],
                                      "tp": tp_rec["launches"]["rmsnorm"],
                                      "tp_recurrent": rec_rec["launches"]["rmsnorm"],
                                      "sp": sp_rec["launches"]["rmsnorm"],
                                      "dryrun": dry_launches["rmsnorm"]}
    # the split row (mamba2's gated norm over a rank's d_inner): its two
    # kernels' launches on the TP paths, and its rank shapes against the plain
    # version, the bound and F.rms_norm on the whole row
    kernels[1]["split"] = dict(rec_rec["split"]["shapes"],
                               launches={k: tp_launches[k] + dry_launches[k]
                                         for k in ("sumsq", "scaled")})
    kernels[2]["launches_by_path"] = {"serve": serve_launches["flash_attention"],
                                      "zoo": zoo_launches["flash_attention"],
                                      "train": train_launches["flash_attention"],
                                      "mesh": mesh_launches["flash_attention"],
                                      "tp": tp_rec["launches"]["flash_attention"],
                                      "tp_recurrent": rec_rec["launches"]["flash_attention"],
                                      "sp": sp_rec["launches"]["flash_attention"],
                                      "dryrun": dry_launches["flash_attention"]}
    # the backward kernels' calls (three launches each) by path; the TP and SP
    # train steps are float32 and take the plain backward
    kernels[2]["launches_by_path"]["backward"] = {
        "train": train_launches["bwd"], "mesh": mesh_train["launches"]["bwd"],
        "tp": tp_launches["bwd"], "dryrun": dry_launches["bwd"]}
    # the rank-local attention shapes of tensor parallelism (the hybrid's too)
    kernels[2]["tp"] = dict(tp_rec["shapes"], **rec_rec["shapes"])
    # the custom operators' host cost a call against the direct launch (phase 20)
    kernels[1]["op_host_us"] = {k: dry_rec["op_host_us"][k]
                                for k in ("rms_norm", "row_sumsq", "rms_norm_scaled")}
    kernels[2]["op_host_us"] = dry_rec["op_host_us"]["attention"]
    # the training shapes: the forward kernel and the plain-torch backward
    kernels[1]["train"] = train_rec["rmsnorm"]
    kernels[2]["train"] = train_rec["flash_attention"]
    # cover: kernel A (draws in) above, kernel B (Philox sample-and-cover,
    # every frontier pass of the planning path) beside it
    kernels[0]["philox"] = philox_rec
    kernels[0]["launches_by_kernel"] = {
        k: sum(d[k] for d in path_launches) + serve_launches["masked_cover_by_kernel"][k]
        + zoo_launches[k] for k in ("draws", "philox")}
    print(f"timed profiler traces: {TRACE_TALLY['traces']}, {TRACE_TALLY['retaken']} taken "
          f"again; of their {TRACE_PAD} sentinel kernels each side, "
          f"{TRACE_TALLY['pad_lost_first']} missing before the calls and "
          f"{TRACE_TALLY['pad_lost_last']} after", flush=True)
    try:
        rows_at_or_above_bound(kernels)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
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
