"""The port's online control (``repro_torch.cluster.control``) against the reference.

Both packages' controllers are numpy over the same closed forms, so every
output is held exactly: the speculative policy's median, trigger and
heartbeat epoch, the min-of-c censoring inversion, and the replanner's fitted
law, plans and history on the same observation stream.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.control as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.control as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402


def test_the_package_exports_the_controllers():
    assert pc.OnlineReplanner is PC.OnlineReplanner
    assert pc.SpeculativePolicy is PC.SpeculativePolicy


@pytest.mark.parametrize("spec", [dict(), dict(interval=0.4, theta=2.0, min_observations=3),
                                  dict(interval=1.0 / 3.0, theta=1.25, max_backups=2)])
def test_speculative_policy_matches_reference(spec):
    ref, port = RC.SpeculativePolicy(rc.Speculation(**spec)), PC.SpeculativePolicy(
        pc.Speculation(**spec))
    rng = np.random.default_rng(7)
    for k in range(8):
        obs = [float(x) for x in rng.pareto(1.5, size=k) + 1.0]
        assert port.median(obs) == ref.median(obs)
        med = ref.median(obs)
        if med is None:
            continue
        for elapsed in rng.uniform(0.0, 4.0 * med, size=6):
            assert port.lagging(float(elapsed), med) == ref.lagging(float(elapsed), med)
    for crossing, now in rng.uniform(0.0, 20.0, size=(16, 2)):
        assert port.next_epoch(float(crossing), float(now)) == ref.next_epoch(
            float(crossing), float(now))


@pytest.mark.parametrize("c", [0.5, 1.0, 2.0, 3.7])
@pytest.mark.parametrize("law", ["Exponential", "ShiftedExponential", "Pareto", "Empirical"])
def test_inverse_min_matches_reference(law, c):
    fields = {"Exponential": dict(mu=1.3), "ShiftedExponential": dict(delta=0.5, mu=2.0),
              "Pareto": dict(sigma=1.0, alpha=2.5), "Empirical": dict(samples=(1.0, 2.0))}[law]
    want = RC._inverse_min(getattr(R, law)(**fields), c)
    got = PC._inverse_min(getattr(P, law)(**fields), c)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _plan_dict(plan):
    return None if plan is None else dataclasses.asdict(plan)


@pytest.mark.parametrize("objective", ["mean", "cov", "blend"])
@pytest.mark.parametrize("law", ["Exponential", "ShiftedExponential", "Pareto"])
def test_online_replanner_matches_reference(law, objective):
    """One observation stream (with a censoring count that changes midway)
    through both controllers: every maybe_replan answer, fitted law and
    history entry is the same."""
    fields = {"Exponential": dict(mu=0.8), "ShiftedExponential": dict(delta=1.0, mu=0.5),
              "Pareto": dict(sigma=1.0, alpha=1.8)}[law]
    draws = getattr(R, law)(**fields).sample_np(np.random.default_rng(3), (400,))
    ref = RC.OnlineReplanner(12, objective=objective, window=128, refit_every=40,
                             min_observations=50, blend=0.3)
    port = PC.OnlineReplanner(12, objective=objective, window=128, refit_every=40,
                              min_observations=50, blend=0.3)
    for i, t in enumerate(draws):
        c = 1 if i < 200 else 3
        ref.observe(float(t), c)
        port.observe(float(t), c)
        n = 12 if i < 300 else 8  # the alive count dropped
        assert _plan_dict(port.maybe_replan(n)) == _plan_dict(ref.maybe_replan(n)), i
    ref.observe_many([0.0, -1.0, np.inf, 2.0], 2)  # non-positive and inf are dropped
    port.observe_many([0.0, -1.0, np.inf, 2.0], 2)
    assert list(port.observations) == list(ref.observations)
    assert len(port.history) == len(ref.history) >= 5
    assert [_plan_dict(p) for p in port.history] == [_plan_dict(p) for p in ref.history]
    assert dataclasses.asdict(port.last_fit) == dataclasses.asdict(ref.last_fit)
    assert _plan_dict(port.replan()) == _plan_dict(ref.replan())
