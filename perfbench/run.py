#!/usr/bin/env python3
"""Run one cell of the benchmark once on the CUDA card.

From the root of a checkout::

    python3 perfbench/run.py --workload plan.google-n20 --seed 7 --seconds 30 --trace 0

The last line of standard output is the result (JSON); the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error.  Exits non-zero, printing no result, where the card is
missing, where the port cannot be imported, or where the run loaded JAX or
the JAX package.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
