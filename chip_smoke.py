#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
``repro_torch`` from ``src/`` (never jax, never ``repro``) and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
3. holds each kernel bitwise equal to its plain PyTorch version on the card,
   in float32 and float64, at the shapes of ``tests/test_torch_cover.py``
   and at every shape the main path gives it: the frontier at each budget
   (N = 100: 9 x 32768 x 100; N = 720: 30 x 32768 x 720) and
   ``simulate_fifo``'s (64 * 32768, 10, 10) grid, unmasked and masked to
   5 x 5; times the largest frontier beside the kernel's memory bound;
4. runs the main path, ``plan_sweep`` over Exp, SExp, Pareto(1.5) and the
   §VII heavy-tail trace job ``job6`` across budgets N in {100, 720} with
   32768 reps, with the launch counter set to 0 just before and read just
   after (one kernel launch per grid point); checks the Exp and SExp
   frontier means against the closed form ``analysis.mean_T``; prints each
   grid point's B* and wall time, the sampler's share of a frontier pass,
   and the card's idle share over one ``plan_cluster`` (``torch.profiler``);
5. runs ``simulate_fifo`` on the card the same way and checks its accounting
   invariant;
6. prints the kernels line, then, last, the one-line JSON result.

Any failed phase exits non-zero and prints no result; so does a run without
a CUDA device or without the repo's sources beside the script.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
CARD_BYTES_PER_S = 3.35e12
CARD_F32_FLOP_PER_S = 67e12

N_REPS = 32768
BUDGETS = (100, 720)
SEED = 1
# simulate_fifo's workload: N workers in B batches (r = N / B), FIFO_JOBS jobs
FIFO_N, FIFO_B, FIFO_JOBS = 100, 10, 64


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def phase(name: str):
    print(f"\n== {name}", flush=True)


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


def device_busy_ms(fn) -> tuple[float, float]:
    """Host-clock ms of ``fn()`` up to a synchronise, and the ms the card spent
    in kernels and copies meanwhile, summed from a ``torch.profiler`` trace
    (0 when the trace shows no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(
        e.time_range.elapsed_us()
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return wall_ms, busy_us / 1e3


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
    print(out.stdout.strip().splitlines()[0], flush=True)


def phase_build() -> None:
    from repro_torch.kernels import _build

    phase("build")
    t0 = time.perf_counter()
    log = _build.build("cover")
    print(f"[cover] {_build.library_path('cover')}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("   ", line.strip())
    print(f"built in {time.perf_counter() - t0:.3f} s", flush=True)


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


def phase_main_path() -> int:
    import torch

    from repro_torch._device import time_on_card
    from repro_torch.cluster.vectorized import frontier_job_times
    from repro_torch.core import analysis
    from repro_torch.core.planner import RedundancyPlanner, _frontier_stats, plan_sweep
    from repro_torch.kernels import cover

    phase(f"main path: plan_sweep, budgets {BUDGETS}, {N_REPS} reps")
    dists = main_path_dists()
    torch.cuda.reset_peak_memory_stats()
    cover.launches = 0
    t0 = time.perf_counter()
    plans = plan_sweep([d for _, d in dists], BUDGETS, n_reps=N_REPS, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cover.launches
    n_points = len(dists) * len(BUDGETS)
    print(f"plan_sweep: {n_points} grid points in {wall:.3f} s; cover launches {launches}")
    check(launches == n_points, f"expected {n_points} cover launches, saw {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

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

    # where a grid point's time goes at the largest budget: the sampler and
    # the kernel on the card (CUDA events), the whole frontier pass and the
    # host's selection statistics on the host clock
    n = max(BUDGETS)
    cands = analysis.feasible_B(n)
    dev = torch.device("cuda")
    for name, dist in dists:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        bs = torch.tensor(cands)
        shape = (len(cands), N_REPS, n)
        x = dist.sample(gen, shape, dev, torch.float32)
        scales = (n / bs).to(dev, torch.float32)
        sample_ms = time_on_card(lambda: dist.sample(gen, shape, dev, torch.float32), iters=5)
        cover_ms = time_on_card(
            lambda: cover.frontier_cover(x, cands, [n // b for b in cands], scales), iters=5
        )
        del x
        frontier_job_times(dist, n, cands, N_REPS, seed=SEED)  # warm
        t0 = time.perf_counter()
        rows = frontier_job_times(dist, n, cands, N_REPS, seed=SEED)  # ends in a copy to host
        pass_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _frontier_stats(rows)
        stats_ms = (time.perf_counter() - t0) * 1e3
        wall_ms, busy_ms = device_busy_ms(
            lambda: RedundancyPlanner(n).plan_cluster(dist, n_reps=N_REPS, seed=SEED)
        )
        idle = f"{1.0 - busy_ms / wall_ms:.1%}" if busy_ms > 0 else "not measured"
        print(f"{name:15s} N={n}: sample {sample_ms:.4f} ms + cover {cover_ms:.4f} ms (card); "
              f"frontier_job_times {pass_ms:.4f} ms, stats {stats_ms:.4f} ms (host) "
              f"-> sampler share {sample_ms / pass_ms:.1%}, cover {cover_ms / pass_ms:.1%}; "
              f"profiled plan_cluster {wall_ms:.4f} ms, card busy {busy_ms:.4f} ms, "
              f"idle share {idle}")
    torch.cuda.empty_cache()
    return launches


def phase_fifo() -> None:
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
    cover.launches = 0
    t0 = time.perf_counter()
    on = simulate_fifo(dist, n, b, arrivals, reps, seed=SEED + 1, cancel_redundant=True)
    off = simulate_fifo(dist, n, b, arrivals, reps, seed=SEED + 1, cancel_redundant=False)
    wall = time.perf_counter() - t0
    launches = cover.launches
    print(f"two runs in {wall:.3f} s; cover launches {launches}")
    check(launches == 2, f"expected 2 cover launches, saw {launches}")
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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this script: {e}", file=sys.stderr)
        return 1

    try:
        phase_card()
        phase_build()
        record = phase_kernel_vs_plain()
        launches = phase_main_path()
        phase_fifo()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "masked_cover",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cover.cu",
        "replaces": "src/repro/kernels/cover.py:47",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this masked max-min
    }]
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
