#!/usr/bin/env python3
"""Readings that set the Mamba-2 cell's limits of ``correct``: the control's and the faults', at size.

The benchmark's own runs never run this.  For each seed it computes, on the
card, the numbers the cell compares (``reference/train_ssm.py::compare``)
for what stands in the program's place, against the plain reference:

* ``control``: the reference with float8 e4m3 products (the configuration
  states bfloat16 compute);
* ``half_batch``: the reference on the first half of each batch's rows;
* ``no_carry``: the reference with the SSD state not carried between
  chunks (each chunk starts from zero).

A state left unchanged reads 1 on ``change_gap`` and needs no run; the
program's own readings are the ``checks`` of the cell's runs (``run.py``).
One JSON line per seed on standard output::

    python3 perfbench/calibrate_ssm.py --workload train.mamba2-2.7b.seq4k --seeds 41 42 43
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def readings(cell, seed: int, device) -> dict:
    ref = harness.load_module(harness.HERE / "reference" / "train_ssm.py",
                              "perfbench_reference_train_ssm")
    cfg, mix = cell.config, cell.traffic
    n_first = int(mix["setup_steps"])
    want = ref.follow(cfg, mix, seed, n_first, device)
    faults = {"control": {"precision": "fp8"}, "half_batch": {"rows": int(mix["batch"]) // 2},
              "no_carry": {"carry": False}}
    return {name: ref.compare(ref.follow(cfg, mix, seed, n_first, device, **kw), want)
            for name, kw in faults.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.environment()
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("calibrate_ssm.py reads at the cell's size on the CUDA card; none found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, **readings(cell, seed, device)}
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
