#!/usr/bin/env python3
"""Readings that set a cell's limits of ``correct``: the control's and the faults', at size.

The benchmark's own runs never run this.  For each seed it computes, on the
card, the numbers the cell compares (``reference/<entry>.py::compare``) for
what stands in the program's place:

* ``control``: the plain reference in the precision just below the one the
  configuration states (the planner: bfloat16 for float32; training: float8
  e4m3 products for bfloat16), against the reference;
* ``half_batch`` (training): the reference on the first half of each
  batch's rows, the mean taken over them, against the whole batch's.

A state left unchanged reads 1 on ``change_gap`` by that number's measure
and needs no run.  The program's own readings are the ``checks`` of the
cell's runs (``run.py``).  One JSON line per seed on standard output::

    python3 perfbench/calibrate.py --workload train.qwen2-1.5b.seq4k --seeds 11 12 13
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench import google_jobs, harness, traffic  # noqa: E402


def plan_readings(cell, seed: int, device) -> dict:
    import torch

    ref = harness.load_module(harness.HERE / "reference" / "plan.py", "perfbench_reference_plan")
    cfg, mix = cell.config, cell.traffic
    obs = google_jobs.task_times(cfg["classes"], traffic.derive(seed, "classes"))
    requests = traffic.plan_requests(mix, len(obs), seed)
    want, got = [], []
    for _ in range(int(mix["check_plans"])):
        c, s = next(requests)
        want.append(ref.plan(obs[c], cfg["n_workers"], cfg["n_reps"], s, device=device))
        got.append(ref.plan(obs[c], cfg["n_workers"], cfg["n_reps"], s, dtype=torch.bfloat16,
                            device=device))
    return {"control": ref.compare(got, want)}


def train_readings(cell, seed: int, device) -> dict:
    ref = harness.load_module(harness.HERE / "reference" / "train.py", "perfbench_reference_train")
    cfg, mix = cell.config, cell.traffic
    n_first = int(mix["setup_steps"])
    want = ref.follow(cfg, mix, seed, n_first, device)
    out = {"control": ref.compare(ref.follow(cfg, mix, seed, n_first, device,
                                             precision="fp8"), want)}
    out["half_batch"] = ref.compare(ref.follow(cfg, mix, seed, n_first, device,
                                               rows=int(mix["batch"]) // 2), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.environment()
    sys.path.insert(0, str(harness.ROOT / "src"))
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("calibrate.py reads at the cell's size on the CUDA card; none found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    readings = plan_readings if cell.traffic["entry"] == "plan" else train_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, **readings(cell, seed, device)}
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
