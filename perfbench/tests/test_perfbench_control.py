"""``correct`` fails where it must: the control, and a run with its timed path broken.

The control is the plain reference in the precision below the
configuration's, put in the program's place (the planner: bfloat16 for
float32; training: float8 products for bfloat16); at the cells' own size it
is read on the card by ``perfbench/calibrate.py``.  Here, at the tiny cells'
size on the CPU, it has to fail the cell's comparison, and so has each fault
a cell can have, planted under a run that goes through everything but the
look for a card: a plan over half its reps, a plan whose B* is altered, a
train step that hands back its state unchanged, a train step over half its
batch.  One cell runs on one card, so no exchange between cards can be left out.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = 2**31 + 99


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plan_control_fails_the_comparison(seed):
    ref = harness.load_module(harness.HERE / "reference" / "plan.py", "ref_plan")
    cell = tiny.cell("plan")
    obs = np.random.default_rng(seed).exponential(size=700) + 3.0
    n, reps = cell.config["n_workers"], cell.config["n_reps"]
    want = ref.plan(obs, n, reps, seed)
    got = ref.plan(obs, n, reps, seed, dtype=torch.bfloat16)
    assert _fails(ref.compare([got], [want]), cell.limits)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_train_control_fails_the_comparison(seed):
    ref = harness.load_module(harness.HERE / "reference" / "train.py", "ref_train")
    cell = tiny.cell("train")
    want = ref.follow(cell.config, cell.traffic, seed, 3, "cpu")
    got = ref.follow(cell.config, cell.traffic, seed, 3, "cpu", precision="fp8")
    assert _fails(ref.compare(got, want), cell.limits)


def test_sound_runs_are_correct():
    for entry in ("plan", "train"):
        assert tiny.run(tiny.cell(entry), SEED, False)["correct"] is True


def _half_reps(real):
    def frontier_job_times(*args, **kwargs):
        rows = real(*args, **kwargs)
        return rows[:, : rows.shape[1] // 2]
    return frontier_job_times


def _other_b(real):
    def _select(self, means, covs, objective, blend):
        b = real(self, means, covs, objective, blend)
        return self.candidates[(self.candidates.index(b) + 1) % len(self.candidates)]
    return _select


def _unchanged(real):
    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def train_step(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return train_step
    return make_train_step


def _half_batch(real):
    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def train_step(state, batch):
            half = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return train_step
    return make_train_step


def _planner():
    from repro_torch.core.planner import RedundancyPlanner
    return RedundancyPlanner


def _module(name):
    return lambda: __import__(name, fromlist=["_"])


# fault -> (entry, the object it is planted in, the attribute, how it breaks it)
FAULTS = {
    "plan over half its reps": ("plan", _module("repro_torch.cluster.vectorized"),
                                "frontier_job_times", _half_reps),
    "plan with B* altered": ("plan", _planner, "_select", _other_b),
    "train step state unchanged": ("train", _module("repro_torch.runtime.train"),
                                   "make_train_step", _unchanged),
    "train step over half its batch": ("train", _module("repro_torch.runtime.train"),
                                       "make_train_step", _half_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    entry, owner, name, breaker = FAULTS[fault]
    target = owner()
    monkeypatch.setattr(target, name, breaker(getattr(target, name)))
    result = json.loads(json.dumps(tiny.run(tiny.cell(entry), SEED, False)))
    assert result["correct"] is False, result["checks"]
