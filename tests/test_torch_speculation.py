"""The epoch scan's speculative backup bank in the port against the reference, on the CPU.

The backup trigger (running lower median of completed siblings, the
``theta x median`` crossing, the heartbeat grid ``k * interval``,
``max_backups``), the event-granular commit and the backup draws use no
transcendental function, so the port is held to the reference exactly: in
float64 every output of ``simulate_epochs`` is bitwise -- starts, finishes,
(B, r), epoch times and every counter, ``n_speculative`` included -- except
``worker_seconds`` and ``cancelled_seconds_saved`` (rtol 1e-12); in float32
the same outputs are held within rtol 1e-6.  The hand-computable fixtures are
those of the reference's ``tests/test_speculation.py``.

``tests/golden/epoch_scan_speculation.json`` holds the reference's float64
output for one small churned speculation scenario, so a run without jax (the
card's) can hold the port to it.  Rewrite it, with the reference, by running
``PYTHONPATH=src python tests/test_torch_speculation.py``.
"""
import dataclasses
import json
import pathlib
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

EXACT = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
         "n_worker_failures", "n_replicas_rescued", "n_replans", "n_speculative")
SUMS = ("worker_seconds", "cancelled_seconds_saved")
SPEC = dict(interval=0.25, theta=1.5)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "epoch_scan_speculation.json"
GOLDEN_CFG = {
    "n_workers": 6,
    "n_batches": None,
    "n_reps": 8,
    "seed": 5,
    "arrivals": [0.5 * i for i in range(16)],
    "dist": {"kind": "Pareto", "fields": {"sigma": 1.0, "alpha": 1.5}},
    "speculation": {"interval": 0.4, "theta": 2.0, "min_observations": 2},
    "churn": {"fail_rate": 0.05, "mean_downtime": 1.0},
    "speeds": [1.0, 1.5, 0.5, 1.25, 0.75, 2.0],
    "scenario": {"cancel_redundant": True, "churn_pairs_per_worker": 3, "dtype": "float64"},
}


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _speeds(n, seed, lo=0.5, hi=2.0):
    return tuple(float(s) for s in np.random.default_rng(seed).uniform(lo, hi, size=n))


def _scenarios(spec, **kw):
    """The same scenario in both packages (configs are per-package)."""
    ref, port = dict(kw), dict(kw)
    for name, cls in (("churn", "ChurnProcess"), ("churn_schedule", "ChurnSchedule")):
        if kw.get(name) is not None:
            fields = dataclasses.asdict(kw[name])
            ref[name] = getattr(rc, cls)(**fields)
            port[name] = getattr(pc, cls)(**fields)
    return (rc.Scenario(speculation=rc.Speculation(**spec), **ref),
            pc.Scenario(speculation=pc.Speculation(**spec), **port))


def _run_both(kind, fields, n, b, arrivals, reps, seed, spec, **kw):
    rs, ps = _scenarios(spec, **kw)
    caught = []
    for mod, pkg, sc, extra in ((RE, R, rs, {}), (PE, P, ps, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            rep = mod.simulate_epochs(getattr(pkg, kind)(**fields), n, b, arrivals, reps,
                                      seed=seed, scenario=sc, **extra)
        caught.append((rep, [str(w.message) for w in got if w.category is RuntimeWarning]))
    (ref, ref_w), (port, port_w) = caught
    assert port_w == ref_w  # the churn-truncation RuntimeWarning, word for word
    return ref, port


def _assert_matches(ref, port, dtype="float64"):
    for f in EXACT + SUMS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif dtype == "float64" and f not in SUMS:
            np.testing.assert_array_equal(b.view(np.uint64), a.view(np.uint64), err_msg=f)
        else:
            np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a), err_msg=f)
            fin = np.isfinite(a)
            rtol = 1e-12 if dtype == "float64" else 1e-6
            np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=0, err_msg=f)
    if ref.churn_truncated is None:
        assert port.churn_truncated is None
    else:
        np.testing.assert_array_equal(port.churn_truncated, ref.churn_truncated)


# --------------------------------------------------------------------------
# the reference's hand-computable fixtures (tests/test_speculation.py)
# --------------------------------------------------------------------------


FIXTURES = {
    # name: (speeds, speculation, cancel)
    "backup-cancel": ((1.0, 1.0, 1.0, 0.25), SPEC, True),
    "backup-nocancel": ((1.0, 1.0, 1.0, 0.25), SPEC, False),
    "theta-never-crossed": ((1.0, 1.0, 1.0, 0.25), dict(interval=0.25, theta=10.0), True),
    "min-obs-gate": ((1.0, 1.0, 0.25, 0.25), dict(SPEC, min_observations=3), True),
    "max-backups-1": ((1.0, 1.0, 0.25, 0.25), dict(SPEC, max_backups=1), True),
    "two-backups-staggered": ((1.0, 1.0, 0.25, 0.25), dict(SPEC, max_backups=2), True),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_scan_matches_reference_on_the_hand_fixtures(x64, name, dtype):
    speeds, spec, cancel = FIXTURES[name]
    ref, port = _run_both("Empirical", {"samples": (1.0,)}, len(speeds), len(speeds),
                          np.zeros(1), 2, 0, spec, speeds=speeds, cancel_redundant=cancel,
                          dtype=dtype)
    _assert_matches(ref, port, dtype)
    if name.startswith("backup"):  # the straggler's backup covers at t = 2.75
        np.testing.assert_array_equal(port.finishes, [[2.75], [2.75]])
        assert (port.n_speculative == 1).all()


def test_speculation_composes_with_churn_exactly(x64):
    """w0 finishes its batch at t=1 and is killed idle at t=1.25: the 1.75
    backup lands on w1 (the lowest alive free worker)."""
    sched = rc.ChurnSchedule(times=(1.25, 5.0), wids=(0, 0), ups=(False, True))
    ref, port = _run_both("Empirical", {"samples": (1.0,)}, 4, 4, np.zeros(1), 2, 0, SPEC,
                          speeds=(1.0, 1.0, 1.0, 0.25), cancel_redundant=True,
                          churn_schedule=sched, dtype="float64")
    _assert_matches(ref, port)
    assert (port.n_worker_failures == 1).all() and (port.n_speculative == 1).all()
    np.testing.assert_array_equal(port.compute_times, [[2.75], [2.75]])


def test_speculation_multi_job_resets_per_dispatch(x64):
    """Three queued jobs each get their own observation window and budget."""
    ref, port = _run_both("Empirical", {"samples": (1.0,)}, 4, 4, np.zeros(3), 2, 0, SPEC,
                          speeds=(1.0, 1.0, 1.0, 0.25), cancel_redundant=True, dtype="float64")
    _assert_matches(ref, port)
    assert (port.n_speculative == 3).all()


def test_speculation_with_planned_redundancy(x64):
    """b=2, r=2: planned replicas already cover the stragglers."""
    ref, port = _run_both("Empirical", {"samples": (1.0,)}, 4, 2, np.zeros(1), 2, 0, SPEC,
                          speeds=(1.0, 1.0, 0.25, 0.25), cancel_redundant=True, dtype="float64")
    _assert_matches(ref, port)
    assert (port.n_speculative == 0).all()


# --------------------------------------------------------------------------
# random draws: heavy tails, sampled churn, speeds, cancel on and off
# --------------------------------------------------------------------------


STOCHASTIC = {
    "pareto_cancel": ("Pareto", {"sigma": 1.0, "alpha": 1.5}, 10, None, np.zeros(20), 8, 3,
                      dict(interval=0.4, theta=2.0, min_observations=3),
                      dict(cancel_redundant=True)),
    "pareto_nocancel_speeds": ("Pareto", {"sigma": 1.0, "alpha": 1.5}, 10, 5,
                               np.arange(20) * 0.5, 8, 3,
                               dict(interval=0.4, theta=2.0, min_observations=2),
                               dict(speeds=_speeds(10, 0))),
    "sampled_churn_cancel": ("ShiftedExponential", {"delta": 1.0, "mu": 0.5}, 8, None,
                             np.arange(16) * 0.5, 8, 7,
                             dict(interval=0.5, theta=1.5, max_backups=2),
                             dict(cancel_redundant=True, size_dependent=True,
                                  churn=rc.ChurnProcess(fail_rate=0.1, mean_downtime=1.0),
                                  churn_pairs_per_worker=3, speeds=_speeds(8, 2))),
    "sampled_churn_nocancel": ("Pareto", {"sigma": 1.0, "alpha": 1.8}, 8, 4,
                               np.zeros(12), 8, 4,
                               dict(interval=0.3, theta=1.5, min_observations=2),
                               dict(churn=rc.ChurnProcess(fail_rate=0.05, mean_downtime=2.0),
                                    churn_pairs_per_worker=4, speeds=_speeds(8, 3))),
}


@pytest.mark.parametrize("case", sorted(STOCHASTIC))
def test_stochastic_float64_matches_reference(x64, case):
    kind, fields, n, b, arrivals, reps, seed, spec, kw = STOCHASTIC[case]
    ref, port = _run_both(kind, fields, n, b, arrivals, reps, seed, spec, dtype="float64", **kw)
    _assert_matches(ref, port)
    assert port.n_speculative.sum() > 0
    if "churn" in kw:
        assert port.n_worker_failures.sum() > 0


@pytest.mark.parametrize("case", sorted(STOCHASTIC))
def test_stochastic_float32_within_1e6(case):
    kind, fields, n, b, arrivals, reps, seed, spec, kw = STOCHASTIC[case]
    ref, port = _run_both(kind, fields, n, b, arrivals, reps, seed, spec, **kw)
    _assert_matches(ref, port, "float32")


def test_backups_cut_the_mean_compute_time():
    """The reference example's claim (examples/speculative_backup.py, small):
    backups shorten the heavy tail's mean compute time at B = N."""
    kind, fields, n, b, arrivals, reps, seed, spec, kw = STOCHASTIC["pareto_cancel"]
    _, ps = _scenarios(spec, dtype="float64", **kw)
    d = P.Pareto(**fields)
    with_b = PE.simulate_epochs(d, n, n, np.zeros(40), 50, seed=1, scenario=ps, device="cpu")
    without = PE.simulate_epochs(d, n, n, np.zeros(40), 50, seed=1,
                                 scenario=ps.replace(speculation=None), device="cpu")
    assert with_b.n_speculative.sum() > 0
    assert with_b.compute_times.mean() < without.compute_times.mean()


def test_frontier_rows_and_plan_cluster_match_reference(x64):
    kind, fields, n, b, arrivals, reps, seed, spec, kw = STOCHASTIC["sampled_churn_cancel"]
    rs, ps = _scenarios(spec, dtype="float64", jobs_per_stream=8, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = RE.frontier_job_times_dynamic(getattr(R, kind)(**fields), n, [1, 2, 4, 8], 64,
                                             seed=seed, scenario=rs)
        got = PE.frontier_job_times_dynamic(getattr(P, kind)(**fields), n, [1, 2, 4, 8], 64,
                                            seed=seed, scenario=ps, device="cpu")
        ref_plan = R.RedundancyPlanner(n).plan_cluster(getattr(R, kind)(**fields), n_reps=64,
                                                       seed=seed, scenario=rs)
        plan = P.RedundancyPlanner(n).plan_cluster(getattr(P, kind)(**fields), n_reps=64,
                                                   seed=seed, scenario=ps, device="cpu")
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (4, 64)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    got_p, want_p = dataclasses.asdict(plan), dataclasses.asdict(ref_plan)
    assert plan.source == "cluster_engine:torch"
    assert {k: v for k, v in got_p.items() if k != "source"} == {
        k: v for k, v in want_p.items() if k != "source"}


def test_rep_chunk_bit_identical_with_speculation():
    kind, fields, n, b, arrivals, reps, seed, spec, kw = STOCHASTIC["sampled_churn_cancel"]
    _, ps = _scenarios(spec, dtype="float64", **kw)
    d = getattr(P, kind)(**fields)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed, scenario=ps, device="cpu")
        parts = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed,
                                   scenario=ps.replace(rep_chunk=3), device="cpu")
    for f in EXACT + SUMS:
        np.testing.assert_array_equal(getattr(parts, f), getattr(one, f), err_msg=f)


# --------------------------------------------------------------------------
# shapes and draws: the step budget and the backup bank, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("max_backups", [1, 3])
@pytest.mark.parametrize("mode", ["sampled", "schedule", "none"])
def test_shapes_with_speculation_match_reference(mode, max_backups):
    churn = {"sampled": (rc.ChurnProcess(0.1, 1.0), pc.ChurnProcess(0.1, 1.0))}.get(mode)
    sched = {"schedule": (rc.ChurnSchedule((1.0, 2.0), (0, 0), (False, True)),
                          pc.ChurnSchedule((1.0, 2.0), (0, 0), (False, True)))}.get(mode)
    spec = (rc.Speculation(max_backups=max_backups), pc.Speculation(max_backups=max_backups))
    for n, n_jobs in ((6, 10), (10, 40), (100, 96)):
        want = RE._shapes(n, n_jobs, churn and churn[0], sched and sched[0], 4,
                          speculation=spec[0])
        got = PE._shapes(n, n_jobs, churn and churn[1], sched and sched[1], 4,
                         speculation=spec[1])
        assert got == want
        assert got[4] > PE._shapes(n, n_jobs, churn and churn[1], sched and sched[1], 4)[4]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["sampled", "none"])
def test_prepare_lanes_spec_cap_draws_bitwise(x64, mode, dtype):
    """tau_spec is drawn after tau_resc and before the churn timeline."""
    rd, pd = R.Pareto(1.0, 1.5), P.Pareto(1.0, 1.5)
    churn = (rc.ChurnProcess(0.1, 1.0), pc.ChurnProcess(0.1, 1.0)) if mode == "sampled" else (
        None, None)
    spec = (rc.Speculation(max_backups=2), pc.Speculation(max_backups=2))
    n, n_jobs = 6, 10
    n_pad, jobs_pad, ev_pad, resc_cap, _ = PE._shapes(n, n_jobs, churn[1], None, 3,
                                                      speculation=spec[1])
    lane_idx = np.array([0, 5, 9, 1 << 30])
    args = (n, n_pad, lane_idx, 3, jobs_pad, ev_pad, resc_cap, 11)
    ref = RE._prepare_lanes(rd, *args, churn[0], None, 3, dtype, spec_cap=jobs_pad * 2)
    port = PE._prepare_lanes(pd, *args, churn[1], None, 3, dtype, spec_cap=jobs_pad * 2)
    assert len(ref) == len(port) == 7
    for a, b in zip(ref, port):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert port[2].shape == (4, jobs_pad * 2, n_pad)
    assert (port[2][3] == 1.0).all() and (port[2][:3] != 1.0).any()


# --------------------------------------------------------------------------
# the golden: the reference's float64 churned speculation run
# --------------------------------------------------------------------------


def _golden_run(pkg_core, pkg_cluster, epoch_scan, **extra):
    cfg = GOLDEN_CFG
    sc = pkg_cluster.Scenario(speculation=pkg_cluster.Speculation(**cfg["speculation"]),
                              churn=pkg_cluster.ChurnProcess(**cfg["churn"]),
                              speeds=tuple(cfg["speeds"]), **cfg["scenario"])
    dist = getattr(pkg_core, cfg["dist"]["kind"])(**cfg["dist"]["fields"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = epoch_scan.simulate_epochs(dist, cfg["n_workers"], cfg["n_batches"],
                                         np.asarray(cfg["arrivals"]), cfg["n_reps"],
                                         seed=cfg["seed"], scenario=sc, **extra)
    return {f: np.asarray(getattr(rep, f)) for f in EXACT + SUMS}


def test_golden_speculation_run_is_the_references_and_the_ports(x64):
    golden = json.loads(GOLDEN.read_text())
    assert {k: golden[k] for k in GOLDEN_CFG} == GOLDEN_CFG
    ref = _golden_run(R, rc, RE)
    port = _golden_run(P, pc, PE, device="cpu")
    assert np.sum(golden["n_speculative"]) > 0 and np.sum(golden["n_worker_failures"]) > 0
    for f in EXACT + SUMS:
        want = np.asarray(golden[f], dtype=port[f].dtype)
        np.testing.assert_array_equal(ref[f], want, err_msg=f)
        if f in SUMS:
            np.testing.assert_allclose(port[f], want, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(port[f], want, err_msg=f)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    run = _golden_run(R, rc, RE)
    GOLDEN.write_text(json.dumps(dict(GOLDEN_CFG, **{k: v.tolist() for k, v in run.items()}),
                                 indent=1) + "\n")
    print(f"wrote {GOLDEN}: backups {run['n_speculative'].tolist()}, "
          f"failures {run['n_worker_failures'].tolist()}")
