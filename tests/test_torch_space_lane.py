"""The port's epoch-scan space lane against the reference, on the CPU.

The space lane runs concurrent jobs on disjoint worker subsets under the
``packed`` / ``balanced`` policies (and ``fifo_gang`` with per-job plans),
each job under its own (workers, B, cancellation) plan, with rescue
regrants under churn.  Both packages draw every lane on the host with numpy
from ``SeedSequence((seed, lane))`` at the same bucketed shapes, so the port
is held to the reference exactly: in float64 every output of
``simulate_epochs`` is bitwise the reference's except ``worker_seconds`` and
``cancelled_seconds_saved`` (sums over replica slots whose order neither XLA
nor torch fixes; rtol 1e-12); float32 is held as the gang lane's float32
(integers exactly, times within rtol 1e-6).  The fixtures are those of the
reference's ``tests/test_space_sharing.py``.

``tests/golden/epoch_scan_space.json`` holds the reference's float64 output
for a few space scenarios, so a run without jax (the card's) can hold the
port to the reference too.  Rewrite it, with the reference, by running
``PYTHONPATH=src python tests/test_torch_space_lane.py``.
"""
import dataclasses
import json
import pathlib
import warnings

import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:  # test extra not installed: seeded fallback engine
    from _hypothesis_compat import given, settings, st

import jax  # noqa: E402
import numpy as np  # noqa: E402
import strategies as scn  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.epoch_scan as RE  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.epoch_scan as PE  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cluster.stream import _ACC_FIELDS, epoch_stream_stats  # noqa: E402

SUMS = ("worker_seconds", "cancelled_seconds_saved")
EXACT = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
         "n_worker_failures", "n_replicas_rescued", "n_replans")
# the crafted shared timeline of tests/test_space_sharing.py: three failures,
# three rejoins, distinct times, against six distinct speeds
SCHEDULE = dict(
    times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
    wids=(2, 5, 2, 0, 5, 0),
    ups=(False, False, True, False, True, True),
)
SPEEDS = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)
LAWS = {
    "const": ("Empirical", {"samples": (1.3,)}, 1),
    "exp": ("Exponential", {"mu": 1.0}, 12),
    "pareto": ("Pareto", {"sigma": 1.0, "alpha": 1.8}, 12),
}
GOLDEN = pathlib.Path(__file__).parent / "golden" / "epoch_scan_space.json"
# the golden's scenarios: random Exp(1) and Pareto(1, 1.8) draws, packed and
# balanced, a heterogeneous plan cycle, a sampled churn, float64
GOLDEN_CASES = {
    "packed_exp_plans": {
        "dist": {"kind": "Exponential", "fields": {"mu": 1.0}},
        "n_workers": 8, "n_batches": 2, "arrivals": [0.0, 0.0, 0.0, 0.5, 1.0, 1.5, 2.5, 3.0],
        "n_reps": 6, "seed": 21,
        "scenario": {"scheduler": "packed", "workers_per_job": 4, "cancel_redundant": True,
                     "churn_pairs_per_worker": 3, "dtype": "float64"},
        "job_plans": [{"workers": 2, "n_batches": 1, "cancel_redundant": False},
                      {"workers": 4, "n_batches": None, "cancel_redundant": None}, None],
        "churn": {"fail_rate": 0.08, "mean_downtime": 1.5},
        "speeds": [1.0, 0.5, 1.5, 2.0, 0.75, 1.25, 1.0, 0.625],
    },
    "balanced_pareto": {
        "dist": {"kind": "Pareto", "fields": {"sigma": 1.0, "alpha": 1.8}},
        "n_workers": 8, "n_batches": 2, "arrivals": [0.0] * 10,
        "n_reps": 6, "seed": 22,
        "scenario": {"scheduler": "balanced", "workers_per_job": 3, "cancel_redundant": False,
                     "churn_pairs_per_worker": 3, "dtype": "float64"},
        "job_plans": None,
        "churn": {"fail_rate": 0.08, "mean_downtime": 1.5},
        "speeds": [0.5, 1.75, 1.0, 2.0, 0.75, 1.25, 1.5, 0.625],
    },
}
GOLDEN_FIELDS = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
                 "n_worker_failures", "n_replicas_rescued")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _port_plans(plans):
    """The reference's JobPlan cycle as the port's."""
    if plans is None:
        return None
    return [None if p is None else pc.JobPlan(**dataclasses.asdict(p)) for p in plans]


def _scenarios(**kw):
    """The same scenario in both packages (churn objects and plans are per package)."""
    ref, port = dict(kw), dict(kw)
    for name, cls in (("churn", "ChurnProcess"), ("churn_schedule", "ChurnSchedule")):
        if kw.get(name) is not None:
            fields = dataclasses.asdict(kw[name])
            ref[name] = getattr(rc, cls)(**fields)
            port[name] = getattr(pc, cls)(**fields)
    if kw.get("job_plans") is not None:
        port["job_plans"] = _port_plans(kw["job_plans"])
    return rc.Scenario(**ref), pc.Scenario(**port)


def _dist(kind, **fields):
    return getattr(R, kind)(**fields), getattr(P, kind)(**fields)


def _run_both(law, n, b, arrivals, reps, seed, entry="simulate_epochs", **kw):
    """One call of ``entry`` in both packages; the port on the CPU.  Returns
    (reference, port, reference warnings, port warnings)."""
    kind, fields = law
    rd, pd = _dist(kind, **fields)
    rs, ps = _scenarios(**kw)
    caught = []
    for mod, d, sc, extra in ((RE, rd, rs, {}), (PE, pd, ps, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            caught.append((getattr(mod, entry)(d, n, b, arrivals, reps, seed=seed, scenario=sc,
                                               **extra), got))
    (ref, ref_w), (port, port_w) = caught
    msgs = [[str(w.message) for w in ws if w.category is RuntimeWarning] for ws in (ref_w, port_w)]
    return ref, port, msgs[0], msgs[1]


def _assert_f64(ref, port, rtol_sums=1e-12):
    for f in EXACT:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64), err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in SUMS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=rtol_sums, atol=0, err_msg=f)
    if ref.churn_truncated is None:
        assert port.churn_truncated is None
    else:
        np.testing.assert_array_equal(ref.churn_truncated, port.churn_truncated)
    assert port.accounting().keys() == ref.accounting().keys()


def _assert_f32(want, got, what):
    """Equal shapes and dtypes, integers exactly, floats within rtol 1e-6."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0, err_msg=what)


# --------------------------------------------------------------------------
# simulate_epochs on the crafted schedule: three policies x cancellation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("cancel", [False, True], ids=["cancel_off", "cancel_on"])
@pytest.mark.parametrize("policy", ["fifo_gang", "packed", "balanced"])
def test_policies_on_the_shared_schedule_match_reference(x64, policy, cancel, law):
    """tests/test_space_sharing.py's exact fixture (n = 6, 8 jobs, two
    workers a job), with degenerate and with random draws."""
    kind, fields, reps = LAWS[law]
    ref, port, _, _ = _run_both(
        (kind, fields), 6, 2, np.zeros(8), reps, 3, cancel_redundant=cancel, speeds=SPEEDS,
        churn_schedule=rc.ChurnSchedule(**SCHEDULE), scheduler=policy, workers_per_job=2,
        dtype="float64")
    _assert_f64(ref, port)
    if policy != "fifo_gang":
        # narrow jobs overlap (space sharing is exercised), and the r = 1
        # subsets make every failure of a running replica a rescue
        assert (port.starts[:, 1:] < port.finishes[:, :-1]).any()
        assert port.n_replicas_rescued.sum() > 0


@pytest.mark.parametrize("policy", ["packed", "balanced"])
def test_heterogeneous_job_plans_with_arrivals_mid_stream(x64, policy):
    """Per-job (workers, B, cancellation) plans with arrivals mid-stream
    (tests/test_space_sharing.py:195-226), and with random draws."""
    arr = np.array([0.0, 0.0, 0.8, 1.2, 2.9, 4.0, 5.5, 6.1, 8.0])
    plans = scn.seeded_job_plans(6, seed=4)
    for law, reps in ((("Empirical", {"samples": (1.7,)}), 1),
                      (("Pareto", {"sigma": 1.0, "alpha": 1.8}), 16)):
        ref, port, _, _ = _run_both(
            law, 6, 3, arr, reps, 7, speeds=SPEEDS, churn_schedule=rc.ChurnSchedule(**SCHEDULE),
            scheduler=policy, workers_per_job=2, job_plans=plans, dtype="float64")
        _assert_f64(ref, port)
        assert len(set(port.n_batches_used.ravel().tolist())) >= 2  # heterogeneous plans ran


@settings(max_examples=6, deadline=None)
@given(
    policy=scn.space_schedulers(),
    wpj=scn.worker_requests(6),
    plans=scn.job_plan_cycles(6),
    seed=st.integers(0, 99),
)
def test_generated_space_scenarios_match_reference(policy, wpj, plans, seed):
    """The reference's generated grid (policy x request x plan cycle on a
    seeded schedule), random Exp(1) draws, float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        sched = scn.seeded_schedule(6, seed=seed, fail_rate=0.07, mean_downtime=1.2)
        ref, port, _, _ = _run_both(
            ("Exponential", {"mu": 1.0}), 6, 2, np.zeros(6), 4, seed, speeds=SPEEDS,
            churn_schedule=sched, scheduler=policy, workers_per_job=wpj, job_plans=plans,
            dtype="float64")
    finally:
        jax.config.update("jax_enable_x64", False)
    _assert_f64(ref, port)


@pytest.mark.parametrize("case", ["gang_mode", "speed_skew_2", "speed_skew_4"])
def test_gang_mode_and_speed_skewed_balanced_match_reference(x64, case):
    """``fifo_gang`` with an all-None plan runs the space lane in gang mode
    and equals the gang lane too; balanced placement under 2x and 4x speed
    skews (tests/test_space_sharing.py:141-163, :302-356)."""
    if case == "gang_mode":
        sched = rc.ChurnSchedule(**SCHEDULE)
        law, args = ("Empirical", {"samples": (1.3,)}), (6, 3, np.zeros(8), 1, 3)
        kw = dict(speeds=SPEEDS, churn_schedule=sched, job_plans=[rc.JobPlan()])
        ref, port, _, _ = _run_both(law, *args, dtype="float64", **kw)
        gang = PE.simulate_epochs(P.Empirical((1.3,)), *args[:-1], seed=3, device="cpu",
                                  scenario=_scenarios(speeds=SPEEDS, churn_schedule=sched,
                                                      dtype="float64")[1])
        np.testing.assert_array_equal(port.finishes, gang.finishes)
        np.testing.assert_array_equal(port.starts, gang.starts)
    elif case == "speed_skew_2":
        ref, port, _, _ = _run_both(
            ("Empirical", {"samples": (1.0,)}), 2, 1, np.arange(6) * 8.0, 1, 1,
            speeds=(2.0, 1.0), scheduler="balanced", workers_per_job=1, dtype="float64")
    else:
        arr = np.array([0.0, 0.3, 0.9, 1.4, 2.2, 3.1, 4.4, 5.0, 6.3, 7.1])
        ref, port, _, _ = _run_both(
            ("Empirical", {"samples": (1.3,)}), 6, 2, arr, 1, 3,
            speeds=(4.0, 1.0, 3.0, 1.4, 2.2, 0.8), scheduler="balanced", workers_per_job=2,
            dtype="float64")
    _assert_f64(ref, port)


# --------------------------------------------------------------------------
# sampled churn, float32, rep_chunk
# --------------------------------------------------------------------------


def _sampled_case(dtype):
    plans = [rc.JobPlan(workers=3, n_batches=1), rc.JobPlan(workers=2, cancel_redundant=True),
             None]
    return dict(law=("ShiftedExponential", {"delta": 0.5, "mu": 1.0}), n=8, b=2,
                arrivals=np.sort(np.random.default_rng(5).uniform(0.0, 6.0, 14)), reps=24,
                seed=9, kw=dict(scheduler="packed", workers_per_job=4, job_plans=plans,
                                churn=rc.ChurnProcess(0.15, 1.0), churn_pairs_per_worker=3,
                                speeds=tuple(np.random.default_rng(3).uniform(0.5, 2.0, 8)),
                                size_dependent=True, dtype=dtype))


def test_sampled_churn_float64_matches_reference_and_warns_alike(x64):
    c = _sampled_case("float64")
    ref, port, ref_w, port_w = _run_both(c["law"], c["n"], c["b"], c["arrivals"], c["reps"],
                                         c["seed"], **c["kw"])
    _assert_f64(ref, port)
    assert port.n_worker_failures.sum() > 0 and port.n_replicas_rescued.sum() > 0
    assert port_w == ref_w  # the churn-truncation RuntimeWarning, word for word


def test_sampled_churn_float32_within_1e6(x64):
    c = _sampled_case("float32")
    ref, port, ref_w, port_w = _run_both(c["law"], c["n"], c["b"], c["arrivals"], c["reps"],
                                         c["seed"], **c["kw"])
    for f in EXACT + SUMS:
        _assert_f32(getattr(ref, f), getattr(port, f), f)
    assert port_w == ref_w


def test_rep_chunk_bit_identical_on_the_space_lane():
    """tests/test_space_sharing.py:359-371, in the port, for both entry points."""
    d = P.Exponential(1.0)
    sc = pc.Scenario(scheduler="balanced", workers_per_job=3,
                     job_plans=_port_plans(scn.seeded_job_plans(6, seed=2)),
                     churn_schedule=pc.ChurnSchedule(
                         **dataclasses.asdict(scn.seeded_schedule(6, seed=3))),
                     dtype="float64", jobs_per_stream=5)
    one = PE.simulate_epochs(d, 6, 2, np.zeros(8), 20, seed=7, scenario=sc, device="cpu")
    rows = PE.frontier_job_times_dynamic(d, 6, [1, 2, 3], 40, seed=7, scenario=sc, device="cpu")
    for chunk in (7, 20):
        part = PE.simulate_epochs(d, 6, 2, np.zeros(8), 20, seed=7,
                                  scenario=sc.replace(rep_chunk=chunk), device="cpu")
        for f in EXACT + SUMS:
            a, b = getattr(one, f), getattr(part, f)
            np.testing.assert_array_equal(a.view(np.uint64) if a.dtype.kind == "f" else a,
                                          b.view(np.uint64) if b.dtype.kind == "f" else b)
        part_rows = PE.frontier_job_times_dynamic(d, 6, [1, 2, 3], 40, seed=7,
                                                  scenario=sc.replace(rep_chunk=chunk // 7),
                                                  device="cpu")
        np.testing.assert_array_equal(rows.view(np.uint64), part_rows.view(np.uint64))


# --------------------------------------------------------------------------
# the frontier, the planner, simulate_fifo's delegation
# --------------------------------------------------------------------------


def test_frontier_rows_on_the_space_lane_match_reference(x64):
    """Candidate B fills the plan of every job whose plan leaves n_batches
    unset, while a competing class holds its fixed plan; under churn."""
    rd, pd = _dist("Pareto", sigma=1.0, alpha=1.8)
    plans = [None, rc.JobPlan(workers=4, n_batches=4)]
    rs, ps = _scenarios(scheduler="balanced", workers_per_job=4, job_plans=plans,
                        churn=rc.ChurnProcess(0.05, 2.0), churn_pairs_per_worker=3,
                        jobs_per_stream=12, dtype="float64", cancel_redundant=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = RE.frontier_job_times_dynamic(rd, 8, [1, 2, 4], 60, seed=4, scenario=rs)
        got = PE.frontier_job_times_dynamic(pd, 8, [1, 2, 4], 60, seed=4, scenario=ps,
                                            device="cpu")
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (3, 60)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _plan_fields(plan) -> dict:
    return {k: v for k, v in dataclasses.asdict(plan).items() if k != "source"}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_cluster_and_plan_sweep_with_space_knobs_match_reference(x64, dtype):
    """tests/test_space_sharing.py:377-395 on the torch backend: the packed
    sweep and a balanced sweep with a competing fixed-plan class."""
    d = _dist("Exponential", mu=1.0)
    cases = [dict(scheduler="packed", workers_per_job=4),
             dict(scheduler="balanced", workers_per_job=4,
                  job_plans=[None, rc.JobPlan(workers=4, n_batches=4)])]
    for kw in cases:
        rs, ps = _scenarios(dtype=dtype, **kw)
        want = R.RedundancyPlanner(8).plan_cluster(d[0], n_reps=96, seed=1, scenario=rs)
        got = P.RedundancyPlanner(8).plan_cluster(d[1], n_reps=96, seed=1, scenario=ps,
                                                  device="cpu")
        assert got.source == "cluster_engine:torch"
        assert _plan_fields(got) == _plan_fields(want)
    rs, ps = _scenarios(dtype=dtype, **cases[0])
    want = R.plan_sweep([d[0]], [6, 8], n_reps=48, seed=2, scenario=rs)
    got = P.plan_sweep([d[1]], [6, 8], n_reps=48, seed=2, scenario=ps, device="cpu")
    for w, g in zip(want[0], got[0]):
        assert g.source == "cluster_engine:torch"
        assert _plan_fields(g) == _plan_fields(w)


def test_simulate_fifo_delegates_to_the_space_lane(x64):
    """vectorized.py:287-311: space knobs go through scenario_from_kwargs to
    simulate_epochs on a churn-free timeline and come back a FifoReport; the
    packed schedule beats the gang on mean response (the headline effect)."""
    arr = np.zeros(12)
    kw = dict(seed=3, scheduler="packed", workers_per_job=4, dtype="float64",
              job_plans=[rc.JobPlan(workers=4), rc.JobPlan(workers=4, cancel_redundant=True)])
    want = rc.simulate_fifo(R.Exponential(1.0), 8, 2, arr, 50, **kw)
    kw["job_plans"] = _port_plans(kw["job_plans"])
    got = pc.simulate_fifo(P.Exponential(1.0), 8, 2, arr, 50, device="cpu", **kw)
    assert isinstance(got, pc.FifoReport)
    for f in ("starts", "finishes"):
        np.testing.assert_array_equal(getattr(got, f).view(np.uint64),
                                      getattr(want, f).view(np.uint64), err_msg=f)
    for f in SUMS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=0)
    gang = pc.simulate_fifo(P.Exponential(1.0), 8, 2, arr, 200, seed=3, device="cpu")
    packed = pc.simulate_fifo(P.Exponential(1.0), 8, 2, arr, 200, seed=3, scheduler="packed",
                              workers_per_job=4, device="cpu")
    assert packed.response_times.mean() < 0.75 * gang.response_times.mean()
    with pytest.raises(ValueError, match="dtype"):
        pc.simulate_fifo(P.Exponential(1.0), 4, 2, np.zeros(2), 2, dtype="float64",
                         device="cpu")


# --------------------------------------------------------------------------
# the streaming fold, refusals, the device
# --------------------------------------------------------------------------


def test_stream_outputs_on_the_space_lane(x64):
    """``outputs="stream"`` on a space scenario gives an EpochStreamReport
    equal, bit for bit, to epoch_stream_stats of the full report and to the
    reference's stream (float64; the worker-second sums at rtol 1e-12)."""
    c = _sampled_case("float64")
    law = _dist(*c["law"][:1], **c["law"][1])
    rs, ps = _scenarios(**c["kw"])
    args = (c["n"], c["b"], c["arrivals"], c["reps"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        full = PE.simulate_epochs(law[1], *args, seed=c["seed"], scenario=ps, device="cpu")
        got = PE.simulate_epochs(law[1], *args, seed=c["seed"],
                                 scenario=ps.replace(outputs="stream"), device="cpu")
        want = RE.simulate_epochs(law[0], *args, seed=c["seed"],
                                  scenario=rs.replace(outputs="stream"))
    assert isinstance(got, PE.EpochStreamReport)
    host = epoch_stream_stats(full)
    for f in _ACC_FIELDS:
        a, h, w = getattr(got.stats, f), getattr(host, f), getattr(want.stats, f)
        assert a.dtype == h.dtype == w.dtype, f
        np.testing.assert_array_equal(a, h, err_msg=f)
        if f in ("busy_sum", "saved_sum"):
            np.testing.assert_allclose(a, w, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, w, err_msg=f)
    np.testing.assert_array_equal(got.n_unfinished, want.n_unfinished)
    np.testing.assert_array_equal(got.churn_truncated, want.churn_truncated)


@pytest.mark.parametrize("knob", ["replan", "speculation", "replan-controller"])
def test_validate_keeps_refusing_adaptive_policies_on_the_space_lane(knob):
    """Scenario.validate refuses the replanner and speculation with space
    knobs on the array backends, with the reference's messages."""
    space = dict(scheduler="packed", workers_per_job=2)
    msgs = []
    for cl, mod in ((rc, RE), (pc, PE)):
        if knob == "replan":
            sc = cl.Scenario(replan=mod.ReplanConfig(window=16), **space)
            call = lambda sc=sc, cl=cl: sc.validate(8, backend="jax" if cl is rc else "torch")  # noqa: E731
        elif knob == "speculation":
            sc = cl.Scenario(speculation=cl.Speculation(interval=0.5), **space)
            call = lambda sc=sc, cl=cl: sc.validate(8, backend="jax" if cl is rc else "torch")  # noqa: E731
        else:
            call = lambda cl=cl: cl.ClusterEngine(8, controller=cl.OnlineReplanner(8), **space)  # noqa: E731
        with pytest.raises(ValueError) as err:
            call()
        msgs.append(str(err.value).replace("'jax'", "'torch'"))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="replan"):
        PE.simulate_epochs(P.Exponential(1.0), 8, 2, np.zeros(2), 2, device="cpu",
                           scenario=pc.Scenario(replan=PE.ReplanConfig(window=16), **space))


def test_space_entry_points_need_a_device_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = P.Exponential(1.0)
    sc = pc.Scenario(scheduler="packed", workers_per_job=2)
    for call in (
        lambda: PE.simulate_epochs(d, 4, 2, np.zeros(2), 2, scenario=sc),
        lambda: PE.frontier_job_times_dynamic(d, 4, [1, 2], 4, scenario=sc),
        lambda: pc.simulate_fifo(d, 4, 2, np.zeros(2), 2, scheduler="packed",
                                 workers_per_job=2),
        lambda: P.RedundancyPlanner(4).plan_cluster(d, n_reps=4, scenario=sc),
        lambda: pc.sample_job_times(d, 4, 2, 4, scenario=sc, backend="torch"),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# --------------------------------------------------------------------------
# the golden: the reference's float64 output, for the card's run
# --------------------------------------------------------------------------


def golden_run(case: dict, core, cluster, simulate, **extra):
    """Run one golden case through a package's ``simulate_epochs``."""
    kw = dict(case["scenario"], speeds=tuple(case["speeds"]),
              churn=cluster.ChurnProcess(**case["churn"]))
    if case["job_plans"] is not None:
        kw["job_plans"] = [None if p is None else cluster.JobPlan(**p) for p in case["job_plans"]]
    dist = getattr(core, case["dist"]["kind"])(**case["dist"]["fields"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return simulate(dist, case["n_workers"], case["n_batches"],
                        np.asarray(case["arrivals"]), case["n_reps"], seed=case["seed"],
                        scenario=cluster.Scenario(**kw), **extra)


def test_golden_space_runs_are_the_references_and_the_ports(x64):
    golden = json.loads(GOLDEN.read_text())
    assert sorted(golden) == sorted(GOLDEN_CASES)
    for name, case in GOLDEN_CASES.items():
        g = golden[name]
        assert g["case"] == case, name
        for rep in (golden_run(case, R, rc, RE.simulate_epochs),
                    golden_run(case, P, pc, PE.simulate_epochs, device="cpu")):
            for f in GOLDEN_FIELDS:
                got = np.asarray(getattr(rep, f))
                want = np.asarray(g[f], dtype=got.dtype)
                if got.dtype == np.float64:
                    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64),
                                                  err_msg=f"{name} {f}")
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f"{name} {f}")
            for f in SUMS:
                np.testing.assert_allclose(getattr(rep, f), g[f], rtol=1e-12, atol=0)
        assert np.isfinite(np.asarray(g["finishes"])).any()
        assert np.asarray(g["n_replicas_rescued"]).sum() > 0, name


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name, case in GOLDEN_CASES.items():
        rep = golden_run(case, R, rc, RE.simulate_epochs)
        out[name] = {"case": case, **{f: np.asarray(getattr(rep, f)).tolist()
                                      for f in GOLDEN_FIELDS + SUMS}}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {GOLDEN}")
