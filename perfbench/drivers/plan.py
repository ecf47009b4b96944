"""The planner's entry: ``RedundancyPlanner.plan_cluster`` over the job classes, closed loop.

Set-up makes each class's observations from the seed
(:mod:`perfbench.google_jobs`), builds one ``RedundancyPlanner`` of the
configuration's N and warms the path up with one plan of every class.  The
window then plans request after request (:func:`perfbench.traffic.plan_requests`),
each timed on the host clock from the call to its return (the plan's frontier
statistics are on the host by then).  After the window a sample of the plans,
drawn from the seed, is planned again by the plain reference and compared.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from perfbench import google_jobs, traffic, work
from perfbench.harness import Outcome, load_module, HERE
from perfbench.trace import Tracer


def _record(plan) -> dict:
    return {"B": list(plan.frontier_B), "mean": np.asarray(plan.frontier_mean),
            "cov": np.asarray(plan.frontier_cov), "B_star": plan.n_batches}


def run(cell, seed: int, seconds: float, traced: bool, device, process_start: float) -> Outcome:
    import torch

    from repro_torch.core.planner import RedundancyPlanner
    from repro_torch.core.service_time import Empirical
    from repro_torch.kernels import cover

    cfg, mix = cell.config, cell.traffic
    n_workers, n_reps = int(cfg["n_workers"]), int(cfg["n_reps"])
    observations = google_jobs.task_times(cfg["classes"], traffic.derive(seed, "classes"))
    dists = [Empirical(tuple(float(x) for x in obs)) for obs in observations]
    planner = RedundancyPlanner(n_workers)
    if planner.candidates != work.divisors(n_workers):
        raise RuntimeError(f"the planner's candidates {planner.candidates} are not every B "
                           f"dividing {n_workers}")

    def plan(c: int, plan_seed: int):
        return planner.plan_cluster(dists[c], cfg["objective"], n_reps=n_reps, seed=plan_seed,
                                    backend=cfg["backend"], device=device)

    for c in range(len(dists)):  # warm-up: the kernel built and loaded, each class once
        plan(c, traffic.derive(seed, "warm-up", c))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    requests = traffic.plan_requests(mix, len(dists), seed)
    tracer = Tracer(traced, device.type)
    n_trace = int(mix["trace_plans"])
    done, latency = [], []
    launches0 = cover.philox_launches
    setup_s = time.time() - process_start
    tracer.start()
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        c, s = next(requests)
        t = time.perf_counter()
        with tracer.unit():
            p = plan(c, s)
        t1 = time.perf_counter()
        latency.append(t1 - t)
        done.append((c, s, _record(p)))
        if len(done) == n_trace:
            tracer.stop()
    window_s = t1 - t0
    tracer.stop()
    launches = cover.philox_launches - launches0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = tracer.result()

    # the check: a sample of the window's plans, drawn from the seed, planned again
    t_ref = time.perf_counter()
    reference = load_module(HERE / "reference" / "plan.py", "perfbench_reference_plan")
    rng = np.random.default_rng(traffic.derive(seed, "check"))
    picks = rng.choice(len(done), size=min(int(mix["check_plans"]), len(done)), replace=False)
    got, want = [], []
    for i in sorted(picks):
        c, s, rec = done[i]
        got.append(rec)
        want.append(reference.plan(observations[c], n_workers, n_reps, s, device=device))
    compared = reference.compare(got, want)
    print(f"perfbench: set-up {setup_s:.1f} s, {len(done)} plans in {window_s:.1f} s, the "
          f"reference's {len(got)} plans {time.perf_counter() - t_ref:.1f} s", file=sys.stderr,
          flush=True)

    facts = {"units": trace.units if trace else 0, "n_workers": n_workers, "n_reps": n_reps,
             "candidates": work.divisors(n_workers),
             "tables": [len(observations[done[i][0]]) for i in range(min(n_trace, len(done)))]}
    return Outcome(
        attempted=len(done), failed=0,
        e2e={"plans_per_s": len(done) / window_s,
             "plan_p95_ms": float(np.percentile(np.asarray(latency) * 1e3, 95)),
             "setup_s": setup_s},
        compared=compared, memory_peak_bytes=peak, trace=trace, facts=facts,
        extra={"counters": {"plans": len(done), "kernel_b_launches": launches,
                            "checked_plans": len(got), "window_s": window_s}},
    )
