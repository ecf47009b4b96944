"""Per-task service times of the §VII trace job classes, made from a seed.

A copy of ``src/repro_torch/core/traces.py::synthetic_google_jobs`` (the
stand-in for the Google cluster trace's jobs of the paper's Fig. 11), driven
by the class list of a configuration file instead of constants: each class
names its law and parameters, and its task count is drawn from
``[n_tasks_lo, n_tasks_hi)`` as the original draws it, in the original order.

* ``sexp``: ``delta + Exp(scale)`` (the exponential-tail family);
* ``pareto``: ``sigma * u ** (-1 / alpha)`` (the borderline job);
* ``pareto_mix``: Pareto, then a share ``slow_share`` of the tasks slowed by
  a factor uniform in ``slowdown`` (the heavy-tail family's stragglers).
"""
from __future__ import annotations

import numpy as np


def task_times(classes: list, seed: int) -> list:
    """One float64 array of task service times per class, in the classes' order."""
    rng = np.random.default_rng(seed)
    out = []
    for c in classes:
        n = int(rng.integers(c["n_tasks_lo"], c["n_tasks_hi"]))
        if c["law"] == "sexp":
            x = c["delta"] + rng.exponential(scale=c["scale"], size=n)
        elif c["law"] in ("pareto", "pareto_mix"):
            x = c["sigma"] * rng.uniform(size=n) ** (-1.0 / c["alpha"])
            if c["law"] == "pareto_mix":
                slow = rng.uniform(size=n) < c["slow_share"]
                x = np.where(slow, x * rng.uniform(*c["slowdown"], size=n), x)
        else:
            raise ValueError(f"unknown law {c['law']!r} of class {c.get('name')}")
        out.append(x)
    return out
