"""The port's ``plan_slo`` against the reference, on the fixtures of tests/test_slo.py.

Both packages sample a fitted workload into trace jobs with ``sample_np`` and
draw the Poisson arrivals and every service time on the host with numpy, so
the port returns the reference's :class:`SLOPlan` itself, in float64: the same
feasibility, the same best (scheduler, pool width, B, r), the same candidate
order, the achieved quantiles bitwise (they are histogram edges) and the mean
responses bitwise; only the costs (charged worker-seconds, a per-job slot sum)
agree within rtol 1e-12 instead of bitwise, as in tests/test_torch_stream.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.traces import TraceJob as RJob  # noqa: E402
from repro_torch.cluster.stream import _CLASS_FIELDS  # noqa: E402
from repro_torch.core.traces import TraceJob as PJob  # noqa: E402
from repro_torch.core.traces import TraceStream  # noqa: E402


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _key(c):
    return (c.scheduler, c.workers_per_job, c.n_batches, c.replication, c.feasible)


def _assert_same_plan(got, want, source="stream"):
    assert got.n_workers == want.n_workers and got.classes == want.classes
    assert got.feasible == want.feasible and got.source == want.source == source
    assert [dataclasses.asdict(s) for s in got.slos] == [dataclasses.asdict(s) for s in want.slos]
    assert [_key(c) for c in got.candidates] == [_key(c) for c in want.candidates]
    for g, w in zip(got.candidates, want.candidates):
        assert g.achieved == w.achieved, (_key(g), g.achieved, w.achieved)
        assert g.mean_response == w.mean_response, _key(g)
        np.testing.assert_allclose(g.cost_worker_seconds, w.cost_worker_seconds, rtol=1e-12,
                                   atol=0, err_msg=str(_key(g)))
    if want.best is None:
        assert got.best is None
    else:
        assert _key(got.best) == _key(want.best)


def _plan_both(n_workers, workload, slo, scenario_kw=None, **kw):
    """``plan_slo`` in both packages on float64 scenarios built from the same fields."""
    sc = dict(size_dependent=False, dtype="float64", **(scenario_kw or {}))
    ref_slo = None if slo is None else _slos(rc, slo)
    port_slo = None if slo is None else _slos(pc, slo)
    if "slo" in sc:
        sc_r, sc_p = dict(sc, slo=_slos(rc, sc["slo"])), dict(sc, slo=_slos(pc, sc["slo"]))
    else:
        sc_r = sc_p = sc
    want = R.RedundancyPlanner(n_workers).plan_slo(
        workload(R, RJob), ref_slo, scenario=rc.Scenario(**sc_r), **kw)
    got = P.RedundancyPlanner(n_workers).plan_slo(
        workload(P, PJob), port_slo, scenario=pc.Scenario(**sc_p), device="cpu", **kw)
    return got, want


def _slos(mod, slo):
    if isinstance(slo, tuple):
        return tuple(mod.SLO(**s) for s in slo)
    return mod.SLO(**slo)


def _pareto(mod, _job):
    return mod.Pareto(sigma=2.0, alpha=1.5)


def _fast_slow(_mod, job):
    rng = np.random.default_rng(21)
    fast = job("fast", "exponential", 1.0 + rng.exponential(0.3, size=500))
    slow = job("slow", "heavy", 4.0 * (rng.pareto(1.8, size=500) + 1.0))
    return (fast, slow)


# --------------------------------------------------------------------------
# plan_slo: the reference's SLOPlan on each fixture of tests/test_slo.py
# --------------------------------------------------------------------------


def test_plan_slo_feasible_target_matches_reference(x64):
    got, want = _plan_both(4, _pareto, dict(quantile=0.99, target_s=40.0, arrival_rate=0.05),
                           n_jobs=400, n_reps=3, seed=1, schedulers=("fifo_gang", "packed"))
    _assert_same_plan(got, want)
    best = got.require_feasible()
    assert got.feasible and best.achieved[0] <= 40.0
    assert all(best.cost_worker_seconds <= c.cost_worker_seconds
               for c in got.candidates if c.feasible)


def test_plan_slo_impossible_target_matches_reference(x64):
    got, want = _plan_both(4, lambda mod, _j: mod.Exponential(mu=1.0),
                           dict(quantile=0.99, target_s=1e-4, arrival_rate=0.05),
                           n_jobs=150, n_reps=2, seed=0, schedulers=("fifo_gang",))
    _assert_same_plan(got, want)
    assert not got.feasible and got.best is None
    assert all(not c.feasible for c in got.candidates)
    with pytest.raises(ValueError, match="no \\(B, r, scheduler\\)"):
        got.require_feasible()


def test_plan_slo_mean_optimal_differs_from_tail_optimal(x64):
    """The paper's second core result: the best-mean candidate buys more
    replication than the cheapest one meeting the p99 target."""
    got, want = _plan_both(4, _pareto, dict(quantile=0.99, target_s=40.0, arrival_rate=0.05),
                           n_jobs=400, n_reps=3, seed=1, schedulers=("fifo_gang", "packed"))
    _assert_same_plan(got, want)
    best = got.require_feasible()
    mean_opt = min(got.candidates, key=lambda c: c.mean_response)
    assert _key(mean_opt) != _key(best)
    assert mean_opt.cost_worker_seconds > best.cost_worker_seconds
    assert mean_opt.feasible


def test_plan_slo_per_class_space_sharing_matches_reference(x64):
    slos = (dict(quantile=0.9, target_s=12.0, arrival_rate=0.08, job_class="fast"),
            dict(quantile=0.9, target_s=80.0, arrival_rate=0.08, job_class="slow"))
    got, want = _plan_both(4, _fast_slow, slos, n_jobs=300, n_reps=2, seed=4,
                           schedulers=("packed", "balanced"))
    _assert_same_plan(got, want)
    assert got.classes == ("fast", "slow")
    for name in ("fast", "slow"):
        g, w = got.best_for(name), want.best_for(name)
        assert (g is None) == (w is None)
        if g is not None:
            assert _key(g) == _key(w)
    with pytest.raises(KeyError):
        got.best_for("nope")


def test_plan_slo_via_scenario_slo_field_matches_reference(x64):
    got, want = _plan_both(2, lambda mod, _j: mod.Exponential(mu=0.5), None,
                           dict(slo=dict(quantile=0.9, target_s=50.0, arrival_rate=0.05)),
                           n_jobs=120, n_reps=2, seed=2, schedulers=("fifo_gang",))
    _assert_same_plan(got, want)
    assert len(got.slos) == 1 and got.source == "stream"


def test_plan_slo_size_dependent_trace_jobs_f32_track_reference():
    """Trace jobs under the §VI size model, float32 (the default dtype): the
    same grid and feasibility; quantiles are histogram edges, so equal."""
    jobs = P.traces.synthetic_google_jobs(2020)
    ref_jobs = [RJob(j.name, j.family, j.task_times) for j in jobs]
    kw = dict(n_jobs=200, n_reps=2, seed=3, schedulers=("fifo_gang", "balanced"),
              pool_widths=(4,))
    want = R.RedundancyPlanner(8).plan_slo(
        ref_jobs[:2], rc.SLO(quantile=0.95, target_s=5e4, arrival_rate=0.002), **kw)
    got = P.RedundancyPlanner(8).plan_slo(
        jobs[:2], pc.SLO(quantile=0.95, target_s=5e4, arrival_rate=0.002), device="cpu", **kw)
    assert [_key(c) for c in got.candidates] == [_key(c) for c in want.candidates]
    for g, w in zip(got.candidates, want.candidates):
        assert g.achieved == w.achieved
        np.testing.assert_allclose(g.cost_worker_seconds, w.cost_worker_seconds, rtol=1e-5)


def test_plan_slo_validation_errors_match_reference():
    for mod in ((R, rc), (P, pc)):
        core, cl = mod
        planner = core.RedundancyPlanner(4)
        kw = {"device": "cpu"} if core is P else {}
        exp = core.Exponential(mu=1.0)
        cases = [
            ("needs an SLO", lambda: planner.plan_slo(exp, **kw)),
            ("arrival_rate", lambda: planner.plan_slo(
                exp, (cl.SLO(arrival_rate=1.0), cl.SLO(arrival_rate=2.0)), n_jobs=10, **kw)),
            ("job_class", lambda: planner.plan_slo(exp, cl.SLO(job_class="missing"), n_jobs=10,
                                                   **kw)),
            ("unknown scheduler", lambda: planner.plan_slo(
                exp, cl.SLO(target_s=5.0), n_jobs=10, schedulers=("warp",), **kw)),
            ("must divide", lambda: planner.plan_slo(
                exp, cl.SLO(target_s=5.0), n_jobs=10, schedulers=("packed",),
                pool_widths=(3,), **kw)),
            ("expected SLO entries", lambda: planner.plan_slo(exp, ("p99",), n_jobs=10, **kw)),
            ("TraceJob or", lambda: planner.plan_slo([3.0], cl.SLO(), n_jobs=10, **kw)),
        ]
        for match, call in cases:
            with pytest.raises(ValueError, match=match):
                call()


def test_plan_slo_dynamic_scenario_is_not_ported_yet(x64):
    """Ported now: a dynamic scenario runs on the epoch scan.  Here with a
    trace-job workload (sampled as an ``Empirical`` law per candidate) on a
    heterogeneous cluster in float64: the reference's ``SLOPlan``
    (candidates, order, feasibility and achieved quantiles equal, costs
    within rtol 1e-12).  tests/test_torch_epoch_stream.py holds the
    reference's own dynamic fixture."""
    jobs = {"R": R.traces.synthetic_google_jobs(2020), "P": P.traces.synthetic_google_jobs(2020)}
    kw = dict(n_jobs=40, n_reps=2, seed=3, schedulers=("fifo_gang",))
    want = R.RedundancyPlanner(4).plan_slo(
        jobs["R"][0], rc.SLO(quantile=0.9, target_s=40.0, arrival_rate=0.05),
        scenario=rc.Scenario(speeds=(1.0, 0.5, 2.0, 1.5), size_dependent=False,
                             dtype="float64"), **kw)
    got = P.RedundancyPlanner(4).plan_slo(
        jobs["P"][0], pc.SLO(quantile=0.9, target_s=40.0, arrival_rate=0.05),
        scenario=pc.Scenario(speeds=(1.0, 0.5, 2.0, 1.5), size_dependent=False,
                             dtype="float64"), device="cpu", **kw)
    _assert_same_plan(got, want, source="epoch_scan")


def test_plan_slo_needs_a_device_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        P.RedundancyPlanner(2).plan_slo(P.Exponential(mu=0.5), pc.SLO(target_s=9.0), n_jobs=10,
                                        schedulers=("fifo_gang",))


# --------------------------------------------------------------------------
# per-class stream state (the substrate of per-class SLOs)
# --------------------------------------------------------------------------


def _mixed_stream(n_jobs=90, seed=5) -> TraceStream:
    rng = np.random.default_rng(77)
    fast = PJob("fast", "exponential", 1.0 + rng.exponential(0.5, size=300))
    slow = PJob("slow", "heavy", 30.0 * rng.pareto(1.6, size=300) + 30.0)
    arr_rng = np.random.default_rng(seed)
    arrivals = np.sort(arr_rng.uniform(0.0, 400.0 * n_jobs, size=n_jobs))
    job_ids = arr_rng.integers(0, 2, size=n_jobs)
    return TraceStream(arrivals=arrivals, job_ids=job_ids, sources=(fast, slow), seed=seed)


@pytest.mark.parametrize("slab", [1, 7, None])
def test_class_state_matches_fold_and_is_slab_invariant(slab):
    st = _mixed_stream(40)
    sc = pc.Scenario(outputs="full", dtype="float64", cancel_redundant=True)
    rep = pc.simulate_stream(st, 4, 2, 3, scenario=sc, slab=slab, device="cpu")
    ref = pc.simulate_stream(st, 4, 2, 3, scenario=sc, slab=16, device="cpu")
    folded = pc.fold_stream_stats(rep.waits, rep.t_job, rep.busy_j, rep.planned_j, rep.saved_j,
                                  class_ids=st.job_ids, classes=("fast", "slow"))
    for f in _CLASS_FIELDS:
        np.testing.assert_array_equal(getattr(rep.stats, f), getattr(folded, f), err_msg=f)
        np.testing.assert_array_equal(getattr(rep.stats, f), getattr(ref.stats, f), err_msg=f)


def test_stream_quantile_within_committed_bound():
    st = _mixed_stream(100)
    rep = pc.simulate_stream(st, 4, 2, 4, scenario=pc.Scenario(
        outputs="full", dtype="float64", size_dependent=False), slab=33, device="cpu")
    resp = np.asarray(rep.response_times, np.float64)
    for c, name in enumerate(("fast", "slow")):
        x = np.sort(resp[:, st.job_ids == c].ravel())
        for q in (0.5, 0.95, 0.99):
            r_k = float(x[max(int(np.ceil(q * x.size)), 1) - 1])
            est = rep.stats.quantile(q, job_class=name)
            assert r_k <= est <= r_k * (1.0 + pc.STREAM_QUANTILE_RTOL) * (1 + 1e-12)
