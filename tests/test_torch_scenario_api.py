"""The port's loose-keyword front door against the reference's, on the CPU.

Mirrors ``tests/test_scenario_api.py`` over the port's four entry points
(``plan_cluster``, ``plan_sweep``, ``simulate_epochs``,
``frontier_job_times_dynamic``): a legacy loose-keyword call warns exactly
once, naming the entry point, and gives the same result as the
``scenario=`` form; both forms at once raise ``ValueError``.  Where the port
and the reference share draws (the epoch scan's host numpy), the loose form
also equals the reference's call.
"""
import contextlib
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference runs on jax)
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.scenario as RS  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.scenario as PS  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cluster.epoch_scan import (  # noqa: E402
    frontier_job_times_dynamic,
    simulate_epochs,
)

SPEEDS = (1.0, 1.0, 2.0, 0.5)


@contextlib.contextmanager
def no_warnings():
    """Context that turns any DeprecationWarning into a failure."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        yield


def _plan_fields(plan) -> dict:
    return {k: v for k, v in dataclasses.asdict(plan).items() if k != "source"}


# --------------------------------------------------------------------------
# every entry point's loose-kwarg shim: warns exactly once, naming itself
# --------------------------------------------------------------------------


def _call_simulate_epochs(kw):
    return simulate_epochs(P.Exponential(1.0), 2, 2, np.zeros(1), 2, seed=0, device="cpu", **kw)


def _call_frontier_dynamic(kw):
    return frontier_job_times_dynamic(
        P.Exponential(1.0), 2, [1], 2, seed=0, device="cpu", **dict(kw, speeds=(1.0, 1.0))
    )


def _call_plan_cluster(kw):
    planner = P.RedundancyPlanner(4, candidates=[1, 2])
    return planner.plan_cluster(P.Exponential(1.0), n_reps=4, seed=0, device="cpu", **kw)


def _call_plan_sweep(kw):
    return P.plan_sweep([P.Exponential(1.0)], [4], n_reps=4, seed=0, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [
        pytest.param({"cancel_redundant": True}, id="cancel_redundant"),
        pytest.param({"speculation": pc.Speculation(interval=0.5, theta=2.0)}, id="speculation"),
    ],
)
@pytest.mark.parametrize(
    "name,call",
    [
        ("simulate_epochs", _call_simulate_epochs),
        ("frontier_job_times_dynamic", _call_frontier_dynamic),
        ("plan_cluster", _call_plan_cluster),
        ("plan_sweep", _call_plan_sweep),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_every_entry_point_loose_kwarg_warns_once_naming_itself(name, call, kw):
    """The shim warns once, naming the entry point; nested delegation
    (plan_sweep -> plan_cluster -> the frontier) does not warn again, with
    the speculation bank on as with it off."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        call(kw)
    shim = [
        w
        for w in caught
        if issubclass(w.category, DeprecationWarning) and "loose keyword" in str(w.message)
    ]
    assert len(shim) == 1, [str(w.message) for w in caught]
    assert str(shim[0].message).startswith(f"{name}: "), str(shim[0].message)


@pytest.mark.parametrize(
    "call",
    [
        lambda: simulate_epochs(P.Exponential(1.0), 4, 2, np.zeros(2), 2, device="cpu",
                                speeds=SPEEDS, scenario=pc.Scenario(speeds=SPEEDS)),
        lambda: frontier_job_times_dynamic(P.Exponential(1.0), 4, [1, 2], 4, device="cpu",
                                           speeds=SPEEDS, scenario=pc.Scenario(speeds=SPEEDS)),
        lambda: P.RedundancyPlanner(4).plan_cluster(
            P.Exponential(1.0), device="cpu", cancel_redundant=True,
            scenario=pc.Scenario(cancel_redundant=True)),
        lambda: P.plan_sweep([P.Exponential(1.0)], [4], device="cpu", cancel_redundant=True,
                             scenario=pc.Scenario(cancel_redundant=True)),
    ],
    ids=["simulate_epochs", "frontier_job_times_dynamic", "plan_cluster", "plan_sweep"],
)
def test_scenario_plus_loose_kwargs_raises(call):
    with pytest.raises(ValueError, match="fold them into the Scenario"):
        call()


# --------------------------------------------------------------------------
# the loose form gives the scenario form's result (and the reference's)
# --------------------------------------------------------------------------


def test_plan_cluster_scenario_equals_legacy():
    d = P.Pareto(1.0, 2.2)
    planner = P.RedundancyPlanner(8, candidates=[1, 2, 4])
    with pytest.warns(DeprecationWarning, match="^plan_cluster: passing cancel_redundant"):
        legacy = planner.plan_cluster(d, n_reps=40, seed=2, cancel_redundant=True, device="cpu")
    with no_warnings():
        new = planner.plan_cluster(
            d, n_reps=40, seed=2, scenario=pc.Scenario(cancel_redundant=True), device="cpu"
        )
    assert legacy == new


def test_plan_cluster_dynamic_scenario_equals_legacy_and_reference():
    """The dynamic lane: speeds route both spellings through
    frontier_job_times_dynamic, with the reference's plan."""
    planner = P.RedundancyPlanner(4, candidates=[1, 2])
    with pytest.warns(DeprecationWarning, match="plan_cluster"):
        legacy = planner.plan_cluster(P.Exponential(1.0), n_reps=30, seed=5, speeds=SPEEDS,
                                      device="cpu")
    with no_warnings():
        new = planner.plan_cluster(P.Exponential(1.0), n_reps=30, seed=5,
                                   scenario=pc.Scenario(speeds=SPEEDS), device="cpu")
    assert legacy == new and legacy.source == "cluster_engine:torch"
    with pytest.warns(DeprecationWarning, match="plan_cluster"):
        ref = R.RedundancyPlanner(4, candidates=[1, 2]).plan_cluster(
            R.Exponential(1.0), n_reps=30, seed=5, backend="jax", speeds=SPEEDS)
    assert _plan_fields(legacy) == _plan_fields(ref)


def test_plan_sweep_scenario_equals_legacy():
    dists = [P.Exponential(1.0), P.Pareto(1.0, 2.5)]
    budgets = [4, 6]
    with pytest.warns(DeprecationWarning, match="plan_sweep"):
        legacy = P.plan_sweep(dists, budgets, n_reps=30, seed=1, cancel_redundant=True,
                              device="cpu")
    with no_warnings():
        new = P.plan_sweep(dists, budgets, n_reps=30, seed=1,
                           scenario=pc.Scenario(cancel_redundant=True), device="cpu")
    assert legacy == new


def test_plan_sweep_callable_speeds():
    """A callable ``speeds`` is re-attached per budget; alone it is no
    scenario kwarg, so it does not warn (as in the reference), and beside
    ``scenario=`` it raises."""
    fn = lambda n: tuple(np.linspace(0.5, 2.0, n))  # noqa: E731
    with no_warnings():
        swept = P.plan_sweep([P.Exponential(1.0)], [4, 6], n_reps=24, seed=2, speeds=fn,
                             device="cpu")
    for j, n in enumerate((4, 6)):
        one = P.RedundancyPlanner(n).plan_cluster(
            P.Exponential(1.0), n_reps=24, seed=2 + j, scenario=pc.Scenario(speeds=fn(n)),
            device="cpu")
        assert swept[0][j] == one
    with pytest.raises(ValueError, match="speeds"):
        P.plan_sweep([P.Exponential(1.0)], [4], speeds=fn, scenario=pc.Scenario(),
                     device="cpu")


def test_frontier_dynamic_scenario_equals_legacy_and_reference():
    speeds = (1.0, 2.0, 1.0, 0.5)
    with pytest.warns(DeprecationWarning, match="frontier_job_times_dynamic"):
        legacy = frontier_job_times_dynamic(
            P.Exponential(1.0), 4, [1, 2], 30, seed=7, speeds=speeds, cancel_redundant=True,
            device="cpu")
    with no_warnings():
        new = frontier_job_times_dynamic(
            P.Exponential(1.0), 4, [1, 2], 30, seed=7,
            scenario=pc.Scenario(speeds=speeds, cancel_redundant=True), device="cpu")
    assert np.array_equal(legacy, new)
    from repro.cluster.epoch_scan import frontier_job_times_dynamic as ref_frontier

    with pytest.warns(DeprecationWarning, match="frontier_job_times_dynamic"):
        ref = ref_frontier(R.Exponential(1.0), 4, [1, 2], 30, seed=7, speeds=speeds,
                           cancel_redundant=True)
    assert np.array_equal(legacy, np.asarray(ref))


def test_simulate_epochs_scenario_equals_legacy():
    with pytest.warns(DeprecationWarning, match="^simulate_epochs: passing cancel_redundant, "
                                                "speeds"):
        legacy = simulate_epochs(P.Exponential(1.0), 4, 2, np.zeros(5), 6, seed=1,
                                 cancel_redundant=True, speeds=SPEEDS, device="cpu")
    with no_warnings():
        new = simulate_epochs(P.Exponential(1.0), 4, 2, np.zeros(5), 6, seed=1,
                              scenario=pc.Scenario(cancel_redundant=True, speeds=SPEEDS),
                              device="cpu")
    for f in ("starts", "finishes", "worker_seconds", "cancelled_seconds_saved",
              "n_batches_used"):
        assert np.array_equal(getattr(legacy, f), getattr(new, f)), f


# --------------------------------------------------------------------------
# the compat shim itself, against the reference's
# --------------------------------------------------------------------------


def test_resolve_scenario_warns_and_builds_like_the_reference():
    msgs = []
    for mod in (RS, PS):
        with pytest.warns(DeprecationWarning, match="somewhere: passing cancel_redundant") as w:
            sc = mod.resolve_scenario(None, {"cancel_redundant": True, "speeds": mod.UNSET},
                                      where="somewhere")
        assert sc == mod.Scenario(cancel_redundant=True)
        msgs.append([str(x.message) for x in w])
    assert msgs[0] == msgs[1]
    sc = pc.Scenario(n_batches=2)
    with no_warnings():
        assert PS.resolve_scenario(sc, {"speeds": PS.UNSET}, where="somewhere") is sc
        assert PS.scenario_from_kwargs(cancel_redundant=True, n_tasks=PS.UNSET) == pc.Scenario(
            cancel_redundant=True)
    assert PS.UNSET is PS._Unset() and repr(PS.UNSET) == "UNSET"


def test_to_scan_cfg_matches_the_reference():
    kw = dict(cancel_redundant=True, size_dependent=False, n_tasks=12, speeds=SPEEDS,
              churn_pairs_per_worker=3, scheduler="packed", workers_per_job=2,
              dtype="float64", rep_chunk=5, outputs="stream")
    ref = rc.Scenario(churn=rc.ChurnProcess(0.1, 1.0), **kw).to_scan_cfg()
    port = pc.Scenario(churn=pc.ChurnProcess(0.1, 1.0), **kw).to_scan_cfg()
    assert ref.keys() == port.keys()
    for k in ref:
        if k == "churn":
            assert dataclasses.asdict(ref[k]) == dataclasses.asdict(port[k])
        else:
            assert ref[k] == port[k], k
