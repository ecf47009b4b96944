"""The epoch scan's streaming fold and the dynamic ``plan_slo`` against the reference.

``simulate_epochs(..., outputs="stream")`` runs the same lanes as
``outputs="full"`` and folds starts and finishes in arrival order on the
device.  In float64 its stats equal :func:`epoch_stream_stats` of the full
report bit for bit (the three sums add job by job, left to right, as the
host fold does), and they equal the reference's ``EpochStreamReport`` bit for
bit; float32 stats are held to the full report as the reference's own
``tests/test_stream.py`` holds them (mean response rtol 1e-5, max rtol 1e-6).

A dynamic ``plan_slo`` (speeds / churn) scores each B on the epoch scan and
reads exact response quantiles from its per-job records: it returns the
reference's ``SLOPlan`` -- candidates, order, feasibility and achieved
quantiles equal, costs (worker-second sums) within rtol 1e-12.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.epoch_scan as RE  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.epoch_scan as PE  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cluster.stream import _ACC_FIELDS, epoch_stream_stats  # noqa: E402


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _assert_stats_equal(a, b, ctx=""):
    """Every accumulator bitwise, dtypes equal."""
    for f in _ACC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype, ctx)
        np.testing.assert_array_equal(x, y, err_msg=f"{f} {ctx}")


def _both(kw):
    """Scenario keywords in both packages (speculation configs are per-package)."""
    ref, port = dict(kw), dict(kw)
    if "speculation" in kw:
        ref["speculation"] = rc.Speculation(**kw["speculation"])
        port["speculation"] = pc.Speculation(**kw["speculation"])
    if "churn" in kw:
        ref["churn"] = rc.ChurnProcess(**kw["churn"])
        port["churn"] = pc.ChurnProcess(**kw["churn"])
    return ref, port


STREAM_CASES = {
    "gang": {},
    "no-cancel": {"cancel_redundant": False},
    "speeds": {"speeds": (1.0, 1.4, 0.8, 1.2, 1.0, 0.9, 1.1, 1.3)},
    "speculation": {"speculation": dict(interval=0.5, theta=1.5)},
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_epoch_stream_equals_full_bitwise_f64(x64, case):
    """tests/test_stream.py's fixture: the port's streamed stats equal the
    host fold of its full report and the reference's streamed stats."""
    rkw, pkw = _both(STREAM_CASES[case])
    arr = np.sort(np.random.default_rng(2).uniform(0.0, 30.0, size=24))
    full = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3, seed=6,
                              dtype="float64", device="cpu", **pkw)
    got = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3, seed=6,
                             dtype="float64", outputs="stream", device="cpu", **pkw)
    want = RE.simulate_epochs(R.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3, seed=6,
                              dtype="float64", outputs="stream", **rkw)
    assert isinstance(got, PE.EpochStreamReport)
    _assert_stats_equal(got.stats, epoch_stream_stats(full), case)
    _assert_stats_equal(got.stats, want.stats, case)
    np.testing.assert_array_equal(got.worker_seconds, full.worker_seconds)
    np.testing.assert_array_equal(got.cancelled_seconds_saved, full.cancelled_seconds_saved)
    assert np.array_equal(got.n_unfinished, np.zeros(3, dtype=want.n_unfinished.dtype))
    assert got.n_unfinished.dtype == want.n_unfinished.dtype
    assert got.accounting().keys() == want.accounting().keys()
    np.testing.assert_array_equal(got.accounting()["worker_seconds"],
                                  full.accounting()["worker_seconds"])
    if case == "speculation":
        np.testing.assert_array_equal(got.n_speculative, want.n_speculative)
        assert got.n_speculative.sum() > 0


def test_epoch_stream_churn_bitwise_and_truncation_flag(x64):
    """Churned lanes fold bitwise too, and a horizon-truncated rep is flagged
    on the stream report as the reference flags it."""
    rkw, pkw = _both(dict(churn=dict(fail_rate=0.05, mean_downtime=2.0),
                          churn_pairs_per_worker=2, dtype="float64", seed=2))
    arr = np.sort(np.random.default_rng(0).uniform(0.0, 30.0, size=20))
    with pytest.warns((RuntimeWarning, DeprecationWarning)):
        full = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3,
                                  device="cpu", **pkw)
    with pytest.warns((RuntimeWarning, DeprecationWarning)):
        got = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3,
                                 outputs="stream", device="cpu", **pkw)
    with pytest.warns((RuntimeWarning, DeprecationWarning)):
        want = RE.simulate_epochs(R.ShiftedExponential(1.0, 0.5), 8, 4, arr, 3,
                                  outputs="stream", **rkw)
    _assert_stats_equal(got.stats, epoch_stream_stats(full), "churn")
    _assert_stats_equal(got.stats, want.stats, "churn vs reference")
    assert got.churn_truncated is not None and got.churn_truncated.dtype == bool
    np.testing.assert_array_equal(got.churn_truncated, want.churn_truncated)
    np.testing.assert_array_equal(got.n_worker_failures, full.n_worker_failures)
    np.testing.assert_array_equal(got.n_unfinished, want.n_unfinished)


def test_epoch_stream_counts_unfinished_jobs(x64):
    """Permanent failures leave jobs unfinished: they are counted, left out of
    the statistics, and flag the rep as truncated, as in the reference."""
    rkw, pkw = _both(dict(churn=dict(fail_rate=0.5, mean_downtime=0.0), dtype="float64",
                          seed=1))
    arr = np.arange(12) * 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = PE.simulate_epochs(P.Exponential(1.0), 4, 2, arr, 4, outputs="stream",
                                 device="cpu", **pkw)
        want = RE.simulate_epochs(R.Exponential(1.0), 4, 2, arr, 4, outputs="stream", **rkw)
    assert got.n_unfinished.sum() > 0
    np.testing.assert_array_equal(got.n_unfinished, want.n_unfinished)
    np.testing.assert_array_equal(got.churn_truncated, want.churn_truncated)
    _assert_stats_equal(got.stats, want.stats, "unfinished")


def test_epoch_stream_summary_tracks_full_f32():
    """float32 lanes: the summaries agree with the full report to float32
    accumulation error, and with the reference's float32 stream."""
    arr = np.sort(np.random.default_rng(4).uniform(0.0, 20.0, size=16))
    full = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 6, 3, arr, 4, seed=1,
                              device="cpu")
    got = PE.simulate_epochs(P.ShiftedExponential(1.0, 0.5), 6, 3, arr, 4, seed=1,
                             outputs="stream", device="cpu")
    want = RE.simulate_epochs(R.ShiftedExponential(1.0, 0.5), 6, 3, arr, 4, seed=1,
                              outputs="stream")
    resp = full.finishes - arr[None, :]
    np.testing.assert_allclose(got.stats.mean_response, resp.mean(axis=1), rtol=1e-5)
    np.testing.assert_allclose(got.stats.resp_max, resp.max(axis=1), rtol=1e-6)
    for f in _ACC_FIELDS:
        a, b = getattr(want.stats, f), getattr(got.stats, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)


def test_stream_on_a_space_scenario_still_raises():
    """The space lane now takes ``outputs="stream"`` (it refused it before
    the lane was ported): the streamed stats equal the reference's stream on
    the same call, float32 (integers exactly, sums within rtol 1e-6)."""
    kw = dict(scheduler="packed", workers_per_job=4, outputs="stream")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = PE.simulate_epochs(P.Exponential(1.0), 8, 4, np.zeros(4), 2, device="cpu", **kw)
        want = RE.simulate_epochs(R.Exponential(1.0), 8, 4, np.zeros(4), 2, **kw)
    assert isinstance(got, PE.EpochStreamReport)
    assert int(got.stats.count.sum()) == 8
    for f in _ACC_FIELDS:
        a, b = getattr(want.stats, f), getattr(got.stats, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)


# --------------------------------------------------------------------------
# plan_slo on a dynamic scenario (tests/test_slo.py:343-370)
# --------------------------------------------------------------------------


def _key(c):
    return (c.scheduler, c.workers_per_job, c.n_batches, c.replication, c.feasible)


def _assert_same_slo_plan(got, want):
    assert got.source == want.source == "epoch_scan"
    assert got.n_workers == want.n_workers and got.classes == want.classes
    assert got.feasible == want.feasible
    assert [dataclasses.asdict(s) for s in got.slos] == [dataclasses.asdict(s) for s in want.slos]
    assert [_key(c) for c in got.candidates] == [_key(c) for c in want.candidates]
    for g, w in zip(got.candidates, want.candidates):
        assert g.achieved == w.achieved, (_key(g), g.achieved, w.achieved)
        assert g.mean_response == w.mean_response, _key(g)
        np.testing.assert_allclose(g.cost_worker_seconds, w.cost_worker_seconds, rtol=1e-12,
                                   atol=0, err_msg=str(_key(g)))
    assert (got.best is None) == (want.best is None)
    if want.best is not None:
        assert _key(got.best) == _key(want.best)


def test_plan_slo_dynamic_lane_epoch_scan():
    kw = dict(n_jobs=40, n_reps=2, seed=3, schedulers=("fifo_gang",))
    want = R.RedundancyPlanner(2).plan_slo(
        R.Exponential(mu=0.5), rc.SLO(quantile=0.9, target_s=60.0, arrival_rate=0.05),
        scenario=rc.Scenario(speeds=(1.0, 0.5), size_dependent=False), **kw)
    got = P.RedundancyPlanner(2).plan_slo(
        P.Exponential(mu=0.5), pc.SLO(quantile=0.9, target_s=60.0, arrival_rate=0.05),
        scenario=pc.Scenario(speeds=(1.0, 0.5), size_dependent=False), device="cpu", **kw)
    _assert_same_slo_plan(got, want)
    assert all(c.scheduler == "fifo_gang" for c in got.candidates)


@pytest.mark.parametrize(
    "workload,schedulers,match",
    [
        ("two-classes", ("fifo_gang",), "single job class"),
        ("one-class", ("packed",), "fifo_gang"),
    ],
)
def test_plan_slo_dynamic_rejections_match_reference(workload, schedulers, match):
    messages = []
    for core, cl, extra in ((R, rc, {}), (P, pc, {"device": "cpu"})):
        wl = (core.Exponential(mu=0.5), core.Exponential(mu=1.0))
        wl = wl if workload == "two-classes" else wl[0]
        with pytest.raises(ValueError, match=match) as err:
            core.RedundancyPlanner(2).plan_slo(
                wl, cl.SLO(quantile=0.9, target_s=60.0, arrival_rate=0.05),
                scenario=cl.Scenario(speeds=(1.0, 0.5), size_dependent=False), n_jobs=20,
                n_reps=2, schedulers=schedulers, **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_plan_slo_churned_float64_matches_reference(x64):
    """A churned, heterogeneous cluster in float64 with a p99 target that
    some but not all candidates meet."""
    speeds = tuple(float(s) for s in np.random.default_rng(0).uniform(0.5, 2.0, 12))
    scs = [cl.Scenario(churn=cl.ChurnProcess(fail_rate=0.02, mean_downtime=2.0), speeds=speeds,
                       size_dependent=False, dtype="float64") for cl in (rc, pc)]
    kw = dict(n_jobs=60, n_reps=3, seed=5, schedulers=("fifo_gang",))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = R.RedundancyPlanner(12).plan_slo(
            R.Pareto(1.0, 1.8), rc.SLO(quantile=0.99, target_s=16.0, arrival_rate=0.02),
            scenario=scs[0], **kw)
        got = P.RedundancyPlanner(12).plan_slo(
            P.Pareto(1.0, 1.8), pc.SLO(quantile=0.99, target_s=16.0, arrival_rate=0.02),
            scenario=scs[1], device="cpu", **kw)
    _assert_same_slo_plan(got, want)
    feasible = [c.feasible for c in got.candidates]
    assert any(feasible) and not all(feasible)
