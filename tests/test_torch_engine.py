"""The port's event engine against the reference's, on the CPU.

``repro_torch.cluster.master`` / ``events`` are numpy copies of the
reference's engine, with their imports rewired to the port's modules.  On
the same seeds both engines must give *equal* reports: every
:class:`JobRecord`, the epoch times, the event count and ``accounting()``,
compared with ``==`` (no tolerance).  The fixtures mirror the engine cases
of the reference's ``tests/test_cluster_engine.py``,
``tests/test_speculation.py``, ``tests/test_space_sharing.py`` and
``tests/test_scenario_api.py``.  The controller is the port's
``OnlineReplanner`` (host numpy, like the reference's), so its decisions
are held equal too.

The last cases hold the port's engine to the port's own epoch-scan space
lane exactly on the crafted schedule (``tests/test_space_sharing.py``'s
``_assert_exact``), the cross-substrate contract the card's run repeats.
"""
import dataclasses
import math
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import strategies as scn  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.epoch_scan as RE  # noqa: E402
import repro.cluster.events as RV  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.epoch_scan as PE  # noqa: E402
import repro_torch.cluster.events as PV  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import traces as RT  # noqa: E402
from repro_torch.core import traces as PT  # noqa: E402
from test_torch_space_lane_cuda import engine_lane_mismatches  # noqa: E402

SCHEDULE = dict(
    times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
    wids=(2, 5, 2, 0, 5, 0),
    ups=(False, False, True, False, True, True),
)
SPEEDS = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)
PKG = {"ref": (R, rc), "port": (P, pc)}


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _build(side: str, spec):
    """``("Name", {fields})`` as that package's object (distributions,
    churn, plans, policies); lists and tuples of them element by element;
    anything else as it is."""
    core, cluster = PKG[side]
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[0], str) \
            and isinstance(spec[1], dict):
        mod = core if hasattr(core, spec[0]) else cluster
        return getattr(mod, spec[0])(**{k: _build(side, v) for k, v in spec[1].items()})
    if isinstance(spec, list):
        return [_build(side, v) for v in spec]
    return spec


def _jobs(side, dist, n_tasks, arrivals, plans=None):
    _, cluster = PKG[side]
    d = _build(side, dist)
    plans = _build(side, plans) if plans is not None else None
    return [cluster.Job(job_id=i, dist=d, n_tasks=n_tasks, arrival=float(a),
                        plan=None if plans is None else plans[i % len(plans)])
            for i, a in enumerate(arrivals)]


def _report(rep) -> dict:
    """Every field of an EngineReport, records as tuples (the packages'
    record classes differ; their fields do not)."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    out["records"] = [dataclasses.astuple(r) for r in rep.records]
    out["accounting"] = rep.accounting()
    return out


def _run_engines(n, dist, n_tasks, arrivals, plans=None, controller=None, **kw):
    """Both engines on the same seed and workload; returns both reports and
    both engines."""
    reps, engines = [], []
    for side in ("ref", "port"):
        _, cluster = PKG[side]
        extra = {k: _build(side, v) for k, v in kw.items()}
        if controller is not None:
            extra["controller"] = cluster.OnlineReplanner(n, **controller)
        eng = cluster.ClusterEngine(n, **extra)
        reps.append(eng.run(_jobs(side, dist, n_tasks, arrivals, plans)))
        engines.append(eng)
    return reps, engines


EXP = ("Exponential", {"mu": 1.0})
PARETO = ("Pareto", {"sigma": 1.0, "alpha": 2.0})
UNIT = ("Empirical", {"samples": (1.0,)})
SPEC = ("Speculation", {"interval": 0.25, "theta": 1.5})
SCHED = ("ChurnSchedule", SCHEDULE)
PLANS = [("JobPlan", {"workers": 3, "n_batches": 3, "cancel_redundant": True}),
         ("JobPlan", {"n_batches": 1}), None]

# name: (n, dist, n_tasks, arrivals, plans, controller, engine kwargs)
CASES = {
    # tests/test_cluster_engine.py
    "fifo_static": (8, EXP, 8, np.zeros(30), None, None, dict(seed=1, n_batches=4)),
    "fifo_arrivals_cancel": (8, PARETO, 8, np.arange(20) * 0.5, None, None,
                             dict(seed=3, n_batches=2, cancel_redundant=True)),
    "size_independent": (12, ("ShiftedExponential", {"delta": 0.05, "mu": 1.0}), 12,
                         np.zeros(25), None, None,
                         dict(seed=2, n_batches=3, size_dependent=False)),
    "churn_cancel": (8, EXP, 8, np.zeros(40), None, None,
                     dict(seed=11, n_batches=4, cancel_redundant=True,
                          churn=("ChurnProcess", {"fail_rate": 0.05, "mean_downtime": 1.0}))),
    "churn_rescue_total_loss": (8, EXP, 8, np.zeros(30), None, None,
                                dict(seed=13, n_batches=8,
                                     churn=("ChurnProcess", {"fail_rate": 0.2,
                                                             "mean_downtime": 0.5}))),
    "schedule_speeds": (6, PARETO, 6, np.arange(12) * 0.4, None, None,
                        dict(seed=5, n_batches=3, cancel_redundant=True, speeds=SPEEDS,
                             churn_schedule=SCHED)),
    "permanent_churn": (4, EXP, 4, np.zeros(10), None, None,
                        dict(seed=0, n_batches=2,
                             churn=("ChurnProcess", {"fail_rate": 5.0, "mean_downtime": 0.0}))),
    # the controller (tests/test_cluster_engine.py:238-283)
    "controller": (8, EXP, 8, np.zeros(80), None,
                   dict(window=512, refit_every=64, min_observations=64),
                   dict(seed=9, n_batches=8)),
    "controller_cancel_pareto": (8, ("Pareto", {"sigma": 1.0, "alpha": 1.5}), 8, np.zeros(90),
                                 None, dict(window=256, refit_every=32, min_observations=32),
                                 dict(seed=4, n_batches=8, cancel_redundant=True,
                                      churn_schedule=("ChurnSchedule", dict(
                                          times=(3.0, 9.0, 20.0), wids=(1, 1, 5),
                                          ups=(False, True, False))))),
    # speculation (tests/test_speculation.py)
    "speculation_unit": (4, UNIT, 4, np.zeros(1), None, None,
                         dict(seed=0, n_batches=4, cancel_redundant=True,
                              speeds=(1.0, 1.0, 1.0, 0.25), speculation=SPEC)),
    "speculation_churn": (6, ("Pareto", {"sigma": 1.0, "alpha": 1.5}), 6, np.zeros(20), None,
                          None, dict(seed=7, n_batches=3, cancel_redundant=True,
                                     speculation=("Speculation", {"interval": 0.3, "theta": 1.5,
                                                                  "max_backups": 2}),
                                     churn=("ChurnProcess", {"fail_rate": 0.05,
                                                             "mean_downtime": 1.0}))),
    "speculation_space": (4, UNIT, 2, np.zeros(2), None, None,
                          dict(seed=0, n_batches=2, cancel_redundant=True,
                               speeds=(1.0, 0.25, 1.0, 1.0), speculation=SPEC,
                               scheduler="packed", workers_per_job=2)),
    "speculation_scripted": (4, UNIT, 4, np.zeros(1), None, None,
                             dict(seed=0, n_batches=4, cancel_redundant=True,
                                  speeds=(1.0, 1.0, 1.0, 0.25), speculation=SPEC,
                                  speculation_times=(1.75,))),
    # task failures: a retry, and an abandoned job
    "retry": (4, UNIT, 4, np.zeros(3), None, None,
              dict(seed=0, n_batches=4, retry=("Retry", {"max_attempts": 2}),
                   task_fail_script=(1, 6), retry_times=(1.5, 4.0))),
    "abandon": (4, UNIT, 4, np.zeros(3), None, None,
                dict(seed=0, n_batches=4, task_fail_script=(2,))),
    # space sharing (tests/test_space_sharing.py)
    "packed_plans_schedule": (6, EXP, 6, [0.0, 0.0, 0.8, 1.2, 2.9, 4.0, 5.5, 6.1, 8.0], PLANS,
                              None, dict(seed=7, n_batches=3, speeds=SPEEDS, churn_schedule=SCHED,
                                         scheduler="packed", workers_per_job=2)),
    "balanced_plans_churn": (6, PARETO, 6, np.arange(14) * 0.3, PLANS, None,
                             dict(seed=8, n_batches=2, cancel_redundant=True, speeds=SPEEDS,
                                  churn=("ChurnProcess", {"fail_rate": 0.1,
                                                          "mean_downtime": 1.0}),
                                  scheduler="balanced", workers_per_job=3)),
    "balanced_sparse": (4, UNIT, 4, np.arange(8) * 5.0, None, None,
                        dict(seed=0, n_batches=1, scheduler="balanced", workers_per_job=1)),
    "packed_full_width": (6, EXP, 6, np.arange(10) * 0.4, None, None,
                          dict(seed=2, n_batches=2, scheduler="packed", workers_per_job=6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_report_equals_reference(case):
    n, dist, n_tasks, arrivals, plans, controller, kw = CASES[case]
    (ref, port), engines = _run_engines(n, dist, n_tasks, arrivals, plans, controller, **kw)
    want, got = _report(ref), _report(port)
    assert got == want
    assert engines[1]._load_w == engines[0]._load_w
    if controller is not None:
        hist = [[dataclasses.astuple(p) for p in e.controller.history] for e in engines]
        assert hist[1] == hist[0] and port.n_replans >= 1
    if case.startswith("speculation"):
        assert port.n_speculative >= 1
    if case == "retry":
        assert port.n_task_failures == 2 and port.n_retries == 2
    if case == "abandon":
        assert math.isinf(port.records[0].finish) and port.n_task_failures == 1
    if case.startswith("churn") or case.endswith("churn"):
        assert port.n_worker_failures > 0 and port.epoch_times


def test_events_and_rng_streams_are_the_references():
    """Named streams draw the reference's numbers; heap ties pop in insertion order."""
    for name in ("service", "churn", "arrivals"):
        a, b = RV.RngStreams(17).get(name), PV.RngStreams(17).get(name)
        np.testing.assert_array_equal(a.random(64), b.random(64))
    q = PV.EventQueue()
    for i, t in enumerate((2.0, 1.0, 1.0, 3.0, 1.0)):
        q.push(t, "k", i=i)
    assert [q.pop()[2]["i"] for _ in range(5)] == [1, 2, 4, 0, 3]
    clock = PV.SimClock()
    clock.advance(2.0)
    with pytest.raises(RuntimeError, match="backwards"):
        clock.advance(1.0)


def test_jobs_from_traces_equals_reference():
    kw = dict(n_tasks=10, arrival_rate=0.01, seed=0)
    want = rc.jobs_from_traces(RT.synthetic_google_jobs()[:4], **kw)
    got = pc.jobs_from_traces(PT.synthetic_google_jobs()[:4], **kw)
    assert [(j.job_id, j.name, j.arrival, j.n_tasks, j.dist.samples) for j in got] == \
        [(j.job_id, j.name, j.arrival, j.n_tasks, j.dist.samples) for j in want]
    reps = [cl.ClusterEngine(10, seed=1, n_batches=5).run(jobs)
            for cl, jobs in ((rc, want), (pc, got))]
    assert _report(reps[1]) == _report(reps[0])
    assert np.isfinite(reps[1].response_times).all()


# --------------------------------------------------------------------------
# sample_job_times on both backends, and plan_cluster(backend="python")
# --------------------------------------------------------------------------


SAMPLE_SCENARIOS = {
    "static": {},
    "churn_schedule": dict(churn_schedule=SCHED, speeds=SPEEDS, cancel_redundant=True),
    "packed_plans": dict(scheduler="packed", workers_per_job=2, job_plans=PLANS),
    "replan": dict(replan=("ReplanConfig", dict(window=64, refit_every=16, min_observations=16))),
    "speculation": dict(speculation=SPEC, cancel_redundant=True, speeds=SPEEDS),
}


def _sample_scenarios(kw):
    out = []
    for side in ("ref", "port"):
        _, cluster = PKG[side]
        built = {}
        for k, v in kw.items():
            if k == "replan":
                mod = RE if side == "ref" else PE
                built[k] = mod.ReplanConfig(**v[1])
            else:
                built[k] = _build(side, v)
        out.append(cluster.Scenario(**built))
    return out


@pytest.mark.parametrize("name", sorted(SAMPLE_SCENARIOS))
def test_sample_job_times_python_backend_equals_reference(name):
    rs, ps = _sample_scenarios(SAMPLE_SCENARIOS[name])
    want = rc.sample_job_times(R.Exponential(1.0), 6, 2, 40, seed=3, scenario=rs)
    got = pc.sample_job_times(P.Exponential(1.0), 6, 2, 40, seed=3, scenario=ps,
                              backend="python")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["churn_schedule", "packed_plans", "speculation"])
def test_sample_job_times_torch_backend_equals_the_references_jax(x64, name):
    """Dynamic and space scenarios run the epoch scan on host numpy draws:
    bitwise the reference's jax backend in float64."""
    rs, ps = _sample_scenarios(dict(SAMPLE_SCENARIOS[name], dtype="float64"))
    want = rc.sample_job_times(R.Pareto(1.0, 2.0), 6, 2, 30, seed=5, scenario=rs, backend="jax")
    got = pc.sample_job_times(P.Pareto(1.0, 2.0), 6, 2, 30, seed=5, scenario=ps,
                              backend="torch", device="cpu")
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (30,)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_sample_job_times_torch_static_agrees_in_law():
    """The static path draws with Philox in the port and jax.random in the
    reference: the means agree within 3 sigma; the engine's too."""
    want = rc.sample_job_times(R.Exponential(1.0), 8, 4, 4000, seed=1, backend="jax")
    got = pc.sample_job_times(P.Exponential(1.0), 8, 4, 4000, seed=1, backend="torch",
                              device="cpu")
    eng = pc.sample_job_times(P.Exponential(1.0), 8, 4, 4000, seed=1, backend="python")
    for a in (want, eng):
        se = math.sqrt(a.var() / a.size + got.var() / got.size)
        assert abs(a.mean() - got.mean()) < 3 * se
    with pytest.raises(ValueError, match="controller"):
        pc.sample_job_times(P.Exponential(1.0), 8, 4, 4, backend="torch", device="cpu",
                            controller=pc.OnlineReplanner(8))
    with pytest.raises(ValueError, match="unknown backend"):
        pc.sample_job_times(P.Exponential(1.0), 8, 4, 4, backend="jax")


def _plan_fields(plan) -> dict:
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("name", ["static", "churn_schedule", "packed_plans", "replan"])
def test_plan_cluster_python_backend_equals_reference(name):
    """One engine run per candidate with seed + i: the same frontier means
    and covs, the same B*, source ``cluster_engine:python``."""
    rs, ps = _sample_scenarios(SAMPLE_SCENARIOS[name])
    want = R.RedundancyPlanner(6).plan_cluster(R.Pareto(1.0, 2.0), n_reps=48, seed=2,
                                               scenario=rs, backend="python")
    got = P.RedundancyPlanner(6).plan_cluster(P.Pareto(1.0, 2.0), n_reps=48, seed=2,
                                              scenario=ps, backend="python")
    assert got.source == want.source == "cluster_engine:python"
    assert _plan_fields(got) == _plan_fields(want)


def test_plan_sweep_python_backend_equals_reference():
    rs, ps = _sample_scenarios(SAMPLE_SCENARIOS["packed_plans"])
    want = R.plan_sweep([R.Exponential(1.0)], [4, 6], n_reps=24, seed=1, scenario=rs,
                        backend="python")
    got = P.plan_sweep([P.Exponential(1.0)], [4, 6], n_reps=24, seed=1, scenario=ps,
                       backend="python")
    assert [_plan_fields(p) for p in got[0]] == [_plan_fields(p) for p in want[0]]


def test_python_backend_runs_on_the_host_without_a_card(monkeypatch):
    """The engine is host numpy by design (as the reference's): only an
    explicit ``backend="python"`` runs it, and it refuses a device; a default
    call is the torch backend, which needs a card or ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planner = P.RedundancyPlanner(4)
    plan = planner.plan_cluster(P.Exponential(1.0), n_reps=8, backend="python")
    assert plan.source == "cluster_engine:python"
    assert pc.sample_job_times(P.Exponential(1.0), 4, 2, 5, backend="python").shape == (5,)
    for call in (
        lambda: pc.sample_job_times(P.Exponential(1.0), 4, 2, 5),
        lambda: pc.sample_job_times(P.Exponential(1.0), 4, 2, 5, backend="torch"),
        lambda: planner.plan_cluster(P.Exponential(1.0), n_reps=8),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    for call in (
        lambda: pc.sample_job_times(P.Exponential(1.0), 4, 2, 5, backend="python",
                                    device="cpu"),
        lambda: planner.plan_cluster(P.Exponential(1.0), n_reps=8, backend="python",
                                     device="cuda"),
        lambda: P.plan_sweep([P.Exponential(1.0)], [4], n_reps=8, backend="python",
                             device="cpu"),
    ):
        with pytest.raises(ValueError, match="takes no device"):
            call()


# --------------------------------------------------------------------------
# the scenario's engine translation, validation
# --------------------------------------------------------------------------


def test_scenario_engine_kwargs_and_job_plans_equal_reference():
    kw = dict(n_batches=3, cancel_redundant=True, speeds=SPEEDS, churn_schedule=SCHED,
              scheduler="balanced", workers_per_job=2, job_plans=PLANS)
    rs, ps = _sample_scenarios(kw)
    a, b = rs.to_engine_kwargs(6), ps.to_engine_kwargs(6)
    assert a.keys() == b.keys()
    for k in a:
        want = dataclasses.asdict(a[k]) if dataclasses.is_dataclass(a[k]) else a[k]
        got = dataclasses.asdict(b[k]) if dataclasses.is_dataclass(b[k]) else b[k]
        assert got == want, k
    assert [ps.job_plan_for(i) and dataclasses.astuple(ps.job_plan_for(i)) for i in range(7)] \
        == [rs.job_plan_for(i) and dataclasses.astuple(rs.job_plan_for(i)) for i in range(7)]
    assert pc.Scenario().job_plan_for(3) is None
    with pytest.raises(ValueError, match="n_workers"):
        pc.Scenario().to_engine_kwargs()
    jobs = lambda cl, core: [cl.Job(job_id=i, dist=core.Pareto(1.0, 2.2), n_tasks=6,  # noqa: E731
                                    plan=ps.job_plan_for(i) if cl is pc else rs.job_plan_for(i))
                             for i in range(12)]
    reps = [cl.ClusterEngine(6, seed=9, **sc.to_engine_kwargs(6)).run(jobs(cl, core))
            for cl, core, sc in ((rc, R, rs), (pc, P, ps))]
    assert _report(reps[1]) == _report(reps[0])


@pytest.mark.parametrize("bad", ["scheduler", "workers_per_job", "controller_space",
                                 "speculation_times", "retry_times", "single_shot"])
def test_engine_refuses_what_the_reference_refuses(bad):
    msgs = []
    for cl in (rc, pc):
        calls = {
            "scheduler": lambda: cl.ClusterEngine(4, scheduler="round_robin"),
            "workers_per_job": lambda: cl.ClusterEngine(4, workers_per_job=9),
            "controller_space": lambda: cl.ClusterEngine(8, scheduler="packed",
                                                         controller=cl.OnlineReplanner(8)),
            "speculation_times": lambda: cl.ClusterEngine(4, speculation_times=(1.0,)),
            "retry_times": lambda: cl.ClusterEngine(4, retry_times=(1.0,)),
        }
        if bad == "single_shot":
            core = R if cl is rc else P
            eng = cl.ClusterEngine(4, seed=0, n_batches=2)
            eng.run([cl.Job(job_id=0, dist=core.Exponential(1.0), n_tasks=4)])
            call = lambda: eng.run([])  # noqa: E731
            exc = RuntimeError
        else:
            call, exc = calls[bad], ValueError
        with pytest.raises(exc) as err:
            call()
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# --------------------------------------------------------------------------
# the port's engine against the port's space lane (the cross-substrate
# contract of docs/architecture.md), float64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cancel", [False, True], ids=["cancel_off", "cancel_on"])
@pytest.mark.parametrize("policy", ["fifo_gang", "packed", "balanced"])
def test_port_engine_equals_port_space_lane(policy, cancel):
    d = P.Empirical((1.3,))
    sched = pc.ChurnSchedule(**SCHEDULE)
    jobs = [pc.Job(job_id=i, dist=d, n_tasks=6) for i in range(8)]
    er = pc.ClusterEngine(6, seed=3, n_batches=2, cancel_redundant=cancel, speeds=SPEEDS,
                          churn_schedule=sched, scheduler=policy, workers_per_job=2).run(jobs)
    vr = PE.simulate_epochs(d, 6, 2, np.zeros(8), 1, seed=3, device="cpu",
                            scenario=pc.Scenario(cancel_redundant=cancel, speeds=SPEEDS,
                                                 churn_schedule=sched, scheduler=policy,
                                                 workers_per_job=2, dtype="float64"))
    if policy != "fifo_gang":
        assert er.n_replicas_rescued > 0
    assert engine_lane_mismatches(er, vr) == []


def test_port_engine_equals_port_space_lane_with_heterogeneous_plans():
    """tests/test_space_sharing.py:195-226, both policies."""
    d = P.Empirical((1.7,))
    arr = np.array([0.0, 0.0, 0.8, 1.2, 2.9, 4.0, 5.5, 6.1, 8.0])
    plans = [pc.JobPlan(**dataclasses.asdict(p)) if p is not None else None
             for p in scn.seeded_job_plans(6, seed=4)]
    sched = pc.ChurnSchedule(**SCHEDULE)
    for policy in ("packed", "balanced"):
        jobs = [pc.Job(job_id=i, dist=d, n_tasks=6, arrival=float(arr[i]),
                       plan=plans[i % len(plans)]) for i in range(9)]
        er = pc.ClusterEngine(6, seed=7, n_batches=3, speeds=SPEEDS, churn_schedule=sched,
                              scheduler=policy, workers_per_job=2).run(jobs)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no churn horizon to outrun on a schedule
            vr = PE.simulate_epochs(d, 6, 3, arr, 1, seed=7, device="cpu",
                                    scenario=pc.Scenario(speeds=SPEEDS, churn_schedule=sched,
                                                         scheduler=policy, workers_per_job=2,
                                                         job_plans=plans, dtype="float64"))
        assert engine_lane_mismatches(er, vr) == []
        assert len({r.n_batches for r in er.records}) >= 2
