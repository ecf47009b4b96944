"""The port's epoch scan (gang lane) against the reference, on the CPU.

Both packages draw every lane on the host with numpy from
``SeedSequence((seed, lane))`` at the same bucketed shapes, so the port is
held to the reference exactly, not in law.  In float64 every output of
``simulate_epochs`` is bitwise the reference's -- starts, finishes, (B, r),
epoch times and every counter -- except ``worker_seconds`` and
``cancelled_seconds_saved``, sums over replica slots whose order neither XLA
nor torch fixes (rtol 1e-12).  The fixtures are those of the reference's own
``tests/test_epoch_scan.py``; five shape buckets keep its compiles few.

``tests/golden/epoch_scan_frontier.json`` holds the reference's frontier rows
for one small churned scenario, so a run without jax (the card's) can hold
the port to the reference too.  Rewrite it, with the reference, by running
``PYTHONPATH=src python tests/test_torch_epoch_scan.py``.
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

SUMS = ("worker_seconds", "cancelled_seconds_saved")
EXACT = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
         "n_worker_failures", "n_replicas_rescued", "n_replans")
SCHEDULE = dict(
    times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
    wids=(2, 5, 2, 0, 5, 0),
    ups=(False, False, True, False, True, True),
)
SPEEDS6 = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "epoch_scan_frontier.json"
GOLDEN_CFG = {
    "n_workers": 8,
    "candidates": [1, 2, 4, 8],
    "n_reps": 64,
    "seed": 11,
    "dist": {"kind": "Pareto", "fields": {"sigma": 1.0, "alpha": 1.8}},
    "churn": {"fail_rate": 0.1, "mean_downtime": 1.0},
    "speeds": [0.5, 1.75, 1.0, 2.0, 0.75, 1.25, 1.5, 0.625],
    "scenario": {"cancel_redundant": True, "churn_pairs_per_worker": 4,
                 "jobs_per_stream": 16, "dtype": "float64"},
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


def _dist(kind, **fields):
    return getattr(R, kind)(**fields), getattr(P, kind)(**fields)


def _scenarios(**kw):
    """The same scenario in both packages (churn objects are per-package)."""
    ref, port = dict(kw), dict(kw)
    for name, cls in (("churn", "ChurnProcess"), ("churn_schedule", "ChurnSchedule")):
        if kw.get(name) is not None:
            fields = dataclasses.asdict(kw[name])
            ref[name] = getattr(rc, cls)(**fields)
            port[name] = getattr(pc, cls)(**fields)
    return rc.Scenario(**ref), pc.Scenario(**port)


def _run_both(kind, fields, n, b, arrivals, reps, seed, **kw):
    rd, pd = _dist(kind, **fields)
    rs, ps = _scenarios(**kw)
    caught = []
    for fn, d, sc in ((RE.simulate_epochs, rd, rs), (PE.simulate_epochs, pd, ps)):
        extra = {"device": "cpu"} if fn is PE.simulate_epochs else {}
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            caught.append((fn(d, n, b, arrivals, reps, seed=seed, scenario=sc, **extra), got))
    (ref, ref_w), (port, port_w) = caught
    return ref, port, [str(w.message) for w in ref_w if w.category is RuntimeWarning], [
        str(w.message) for w in port_w if w.category is RuntimeWarning]


def _plan_fields(plan) -> dict:
    """A plan's fields but its ``source`` (the packages' plan classes differ)."""
    return {k: v for k, v in dataclasses.asdict(plan).items() if k != "source"}


def _assert_report_matches(ref, port, rtol_sums=1e-12):
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


# the reference's fixtures (tests/test_epoch_scan.py), float64
CASES = {
    # test_static_matches_engine_and_fifo_scan
    "static_exp": ("Exponential", {"mu": 1.0}, 8, 4, np.zeros(20), 150, 0, {}),
    "static_fifo_pareto": ("Pareto", {"sigma": 1.0, "alpha": 2.0}, 8, 2,
                           np.arange(10) * 1.5, 400, 3, {}),
    # test_exact_trajectory_on_shared_schedule, and the same schedule under
    # random draws
    "schedule_cancel_off": ("Empirical", {"samples": (1.3,)}, 6, 3, np.zeros(8), 1, 3,
                            dict(cancel_redundant=False, speeds=SPEEDS6,
                                 churn_schedule=rc.ChurnSchedule(**SCHEDULE))),
    "schedule_cancel_on": ("Empirical", {"samples": (1.3,)}, 6, 3, np.zeros(8), 1, 3,
                           dict(cancel_redundant=True, speeds=SPEEDS6,
                                churn_schedule=rc.ChurnSchedule(**SCHEDULE))),
    "schedule_pareto_cancel_off": ("Pareto", {"sigma": 1.0, "alpha": 2.0}, 6, 3,
                                   np.arange(8) * 0.5, 40, 4,
                                   dict(cancel_redundant=False, speeds=SPEEDS6,
                                        churn_schedule=rc.ChurnSchedule(**SCHEDULE))),
    "schedule_pareto_cancel_on": ("Pareto", {"sigma": 1.0, "alpha": 2.0}, 6, 3,
                                  np.arange(8) * 0.5, 40, 4,
                                  dict(cancel_redundant=True, speeds=SPEEDS6,
                                       churn_schedule=rc.ChurnSchedule(**SCHEDULE))),
    # test_churn_event_unblocking_dispatch_sets_start_time
    "unblocking": ("Empirical", {"samples": (2.0,)}, 2, 1, np.zeros(2), 1, 0,
                   dict(speeds=(1.0, 0.25),
                        churn_schedule=rc.ChurnSchedule(times=(5.0,), wids=(1,), ups=(False,)))),
    # test_heterogeneous_speeds_match_engine
    "hetero": ("Exponential", {"mu": 1.0}, 6, 3, np.zeros(30), 300, 6,
               dict(speeds=_speeds(6, 11))),
    # sampled churn (rescues, truncation), size-dependent, B = alive workers
    "sampled_churn": ("ShiftedExponential", {"delta": 1.0, "mu": 0.5}, 8, None,
                      np.zeros(12), 48, 7,
                      dict(cancel_redundant=True, size_dependent=True,
                           churn=rc.ChurnProcess(fail_rate=0.1, mean_downtime=1.0),
                           churn_pairs_per_worker=4, speeds=_speeds(8, 2))),
}


# --------------------------------------------------------------------------
# host draws and shapes: bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sampled", "schedule", "none"])
def test_prepare_lanes_shapes_and_churn_pairs_bitwise(x64, mode):
    rd, pd = _dist("Pareto", sigma=1.0, alpha=2.0)
    n, n_jobs = 6, 10
    churn = {"sampled": (rc.ChurnProcess(0.1, 1.0), pc.ChurnProcess(0.1, 1.0))}.get(mode)
    sched = {"schedule": (rc.ChurnSchedule(**SCHEDULE), pc.ChurnSchedule(**SCHEDULE))}.get(mode)
    speeds = np.asarray(_speeds(n, 1) + (1.0, 1.0))
    def args(i):
        return (None if churn is None else churn[i], None if sched is None else sched[i])

    pairs = [
        mod._resolve_churn_pairs(None, d, args(i)[0], n, 3, n, True, speeds,
                                 np.arange(n_jobs) * 0.5, n_jobs)
        for i, (mod, d) in enumerate(((RE, rd), (PE, pd)))
    ]
    assert pairs[0] == pairs[1] >= 8
    shapes = [RE._shapes(n, n_jobs, *args(0), pairs[0]), PE._shapes(n, n_jobs, *args(1), pairs[1])]
    assert shapes[0] == shapes[1]
    n_pad, jobs_pad, ev_pad, resc_cap, _ = shapes[0]
    lane_idx = np.array([3, 4, 9, 1 << 30])
    for dtype in (np.float64, np.float32):
        ref = RE._prepare_lanes(rd, n, n_pad, lane_idx, 3, jobs_pad, ev_pad, resc_cap, 5,
                                *args(0), pairs[0], dtype)
        port = PE._prepare_lanes(pd, n, n_pad, lane_idx, 3, jobs_pad, ev_pad, resc_cap, 5,
                                 *args(1), pairs[1], dtype)
        # (tau, tau_resc, tau_spec, ev_t, ev_w, ev_up, horizon); tau_spec is
        # the constant placeholder without speculation
        assert len(ref) == len(port) == 7
        for a, b in zip(ref, port):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert (port[3][:3, 0] < np.inf).all() == (mode != "none")


# --------------------------------------------------------------------------
# simulate_epochs: float64 bitwise (worker-second sums at rtol 1e-12)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_epochs_float64_matches_reference(x64, case):
    kind, fields, n, b, arrivals, reps, seed, kw = CASES[case]
    ref, port, ref_w, port_w = _run_both(kind, fields, n, b, arrivals, reps, seed,
                                         dtype="float64", **kw)
    _assert_report_matches(ref, port)
    assert port_w == ref_w  # the churn-truncation RuntimeWarning, word for word
    if case == "sampled_churn":
        assert port.n_replicas_rescued.sum() > 0 and port.n_worker_failures.sum() > 0
        assert port.churn_truncated.any() and port_w
    if case == "unblocking":  # the straggler's worker fails at t = 5: job 1 starts then
        np.testing.assert_array_equal(port.starts[0], [0.0, 5.0])
        np.testing.assert_array_equal(port.finishes[0], [4.0, 9.0])


def test_simulate_epochs_float32_within_1e6(x64):
    kind, fields, n, b, arrivals, reps, seed, kw = CASES["sampled_churn"]
    ref, port, ref_w, port_w = _run_both(kind, fields, n, b, arrivals, reps, seed,
                                         dtype="float32", **kw)
    for f in EXACT + SUMS:
        a, p = getattr(ref, f), getattr(port, f)
        assert a.dtype == p.dtype and a.shape == p.shape, f
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(p), err_msg=f)
        fin = np.isfinite(a)
        np.testing.assert_allclose(p[fin], a[fin], rtol=1e-6, atol=0, err_msg=f)
    assert port_w == ref_w


def test_rep_chunk_bit_identical_in_the_port():
    kind, fields, n, b, arrivals, reps, seed, kw = CASES["sampled_churn"]
    _, d = _dist(kind, **fields)
    _, sc = _scenarios(dtype="float64", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed, scenario=sc, device="cpu")
        parts = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed,
                                   scenario=sc.replace(rep_chunk=7), device="cpu")
        rows = PE.frontier_job_times_dynamic(d, n, [1, 2, 4, 8], 100, seed=seed, scenario=sc,
                                             device="cpu")
        rows_c = PE.frontier_job_times_dynamic(d, n, [1, 2, 4, 8], 100, seed=seed,
                                               scenario=sc.replace(rep_chunk=3), device="cpu")
    for f in EXACT + SUMS:
        a, p = getattr(one, f), getattr(parts, f)
        assert a.dtype == p.dtype
        np.testing.assert_array_equal(a.view(np.uint64) if a.dtype.kind == "f" else a,
                                      p.view(np.uint64) if p.dtype.kind == "f" else p)
    assert rows.shape == rows_c.shape == (4, 112)
    np.testing.assert_array_equal(rows.view(np.uint64), rows_c.view(np.uint64))
    empty = PE.frontier_job_times_dynamic(d, n, [1, 2], 0, scenario=sc, device="cpu")
    assert empty.shape == (2, 0)


def test_cancellation_identity_and_accounting():
    """Same seed, cancel on and off: the same compute times, and the tails
    cancellation reclaims are exactly what the run without it burns."""
    _, d = _dist("Pareto", sigma=1.0, alpha=2.0)
    sc = pc.Scenario(speeds=_speeds(8, 2), dtype="float64")
    on = PE.simulate_epochs(d, 8, 2, np.zeros(10), 30, seed=5,
                            scenario=sc.replace(cancel_redundant=True), device="cpu")
    off = PE.simulate_epochs(d, 8, 2, np.zeros(10), 30, seed=5, scenario=sc, device="cpu")
    np.testing.assert_allclose(on.compute_times, off.compute_times, rtol=1e-12)
    np.testing.assert_allclose(on.worker_seconds + on.cancelled_seconds_saved,
                               off.worker_seconds, rtol=1e-12)
    assert (on.cancelled_seconds_saved > 0).all() and (off.cancelled_seconds_saved == 0).all()
    acc = on.accounting()
    assert set(acc) == {"worker_seconds", "cancelled_seconds_saved", "n_worker_failures",
                        "n_replicas_rescued", "n_replans", "n_speculative",
                        "n_task_failures", "n_retries"}
    assert (on.final_n_batches == 2).all() and (on.queue_waits >= 0).all()


# --------------------------------------------------------------------------
# the planning path: frontier rows and B*
# --------------------------------------------------------------------------


def test_frontier_rows_and_plan_cluster_match_reference(x64):
    kind, fields = "Pareto", {"sigma": 1.0, "alpha": 1.8}
    rd, pd = _dist(kind, **fields)
    rs, ps = _scenarios(speeds=_speeds(8, 0), churn=rc.ChurnProcess(0.02, 2.0),
                        churn_pairs_per_worker=4, jobs_per_stream=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = RE.frontier_job_times_dynamic(rd, 8, [1, 2, 4, 8], 200, seed=2, scenario=rs)
        got = PE.frontier_job_times_dynamic(pd, 8, [1, 2, 4, 8], 200, seed=2, scenario=ps,
                                            device="cpu")
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
        ref_plan = R.RedundancyPlanner(8).plan_cluster(rd, n_reps=200, seed=2, scenario=rs)
        plan = P.RedundancyPlanner(8).plan_cluster(pd, n_reps=200, seed=2, scenario=ps,
                                                   device="cpu")
    assert plan.source == "cluster_engine:torch"
    assert _plan_fields(plan) == _plan_fields(ref_plan)


def test_plan_sweep_dynamic_matches_reference(x64):
    """Budgets 6 and 8 share one bucket; speeds come from a callable."""
    dists = [_dist("Exponential", mu=1.0), _dist("Pareto", sigma=1.0, alpha=2.0)]
    speeds = lambda n: _speeds(n, n)  # noqa: E731
    plans = []
    for i, (mod, cs) in enumerate(((R, rc), (P, pc))):
        extra = {"device": "cpu"} if mod is P else {}
        with pytest.warns(DeprecationWarning, match="^plan_sweep: passing cancel_redundant"):
            plans.append(mod.plan_sweep(
                [d[i] for d in dists], [6, 8], n_reps=64, seed=3, speeds=speeds,
                churn_schedule=cs.ChurnSchedule(**SCHEDULE), cancel_redundant=True,
                jobs_per_stream=8, **extra))
    want, got = plans
    for i in range(2):
        for j in range(2):
            assert got[i][j].source == "cluster_engine:torch"
            assert _plan_fields(got[i][j]) == _plan_fields(want[i][j])


def _golden_rows(pkg_core, pkg_cluster, frontier, **extra):
    cfg = GOLDEN_CFG
    sc = pkg_cluster.Scenario(churn=pkg_cluster.ChurnProcess(**cfg["churn"]),
                              speeds=tuple(cfg["speeds"]), **cfg["scenario"])
    dist = getattr(pkg_core, cfg["dist"]["kind"])(**cfg["dist"]["fields"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.asarray(frontier(dist, cfg["n_workers"], cfg["candidates"], cfg["n_reps"],
                                   seed=cfg["seed"], scenario=sc, **extra))


def test_golden_frontier_rows_are_the_references_and_the_ports(x64):
    golden = json.loads(GOLDEN.read_text())
    assert {k: golden[k] for k in GOLDEN_CFG} == GOLDEN_CFG
    want = np.array(golden["rows"], dtype=np.float64)
    ref = _golden_rows(R, rc, RE.frontier_job_times_dynamic)
    port = _golden_rows(P, pc, PE.frontier_job_times_dynamic, device="cpu")
    assert want.shape == (4, 64) and np.isfinite(want).all()
    np.testing.assert_array_equal(ref.view(np.uint64), want.view(np.uint64))
    np.testing.assert_array_equal(port.view(np.uint64), want.view(np.uint64))


# --------------------------------------------------------------------------
# every knob the gang lane takes runs and equals the reference; what the
# port has not reached raises, by name, before any lane runs
# --------------------------------------------------------------------------


_UNPORTED = {
    "replan": (dict(replan=dict(window=16, refit_every=4, min_observations=4)), None),
    "speculation": (dict(speculation=dict(interval=0.25, theta=1.5)), None),
    "space": (dict(scheduler="packed", workers_per_job=2), None),
    "stream": (dict(outputs="stream"), None),
    "devices": (dict(devices=2), "devices=2"),
}


def _knob_scenarios(kw):
    """The knob's scenario in both packages (float32 lanes: the reference's
    replanner does not run under jax x64, see ROADMAP.md §3)."""
    ref, port = dict(kw), dict(kw)
    if "replan" in kw:
        ref["replan"], port["replan"] = (RE.ReplanConfig(**kw["replan"]),
                                        PE.ReplanConfig(**kw["replan"]))
    if "speculation" in kw:
        ref["speculation"], port["speculation"] = (rc.Speculation(**kw["speculation"]),
                                                  pc.Speculation(**kw["speculation"]))
    return rc.Scenario(**ref), pc.Scenario(**port)


def _assert_close_f32(want, got, what):
    """Equal shapes and dtypes, integers exactly, floats within rtol 1e-6."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0, err_msg=what)


@pytest.mark.parametrize("knob", sorted(_UNPORTED))
@pytest.mark.parametrize("entry", ["simulate_epochs", "frontier_job_times_dynamic",
                                   "plan_cluster"])
def test_unported_knobs_raise_naming_their_reason(entry, knob):
    """The replanner, speculation, ``outputs="stream"`` and space sharing now
    run on every entry point and equal the reference (float32: integers
    exactly, times within rtol 1e-6); ``devices > 1`` still raises, naming
    its ROADMAP item."""
    kw, reason = _UNPORTED[knob]
    rs, ps = _knob_scenarios(kw)
    rd, pd = R.Exponential(1.0), P.Exponential(1.0)
    arrivals = np.arange(12) * 0.25
    calls = {
        "simulate_epochs": lambda m, d, sc, **x: m.simulate_epochs(d, 4, 2, arrivals, 3,
                                                                   scenario=sc, **x),
        "frontier_job_times_dynamic": lambda m, d, sc, **x: m.frontier_job_times_dynamic(
            d, 4, [1, 2], 16, scenario=sc, **x),
        "plan_cluster": lambda m, d, sc, **x: m.RedundancyPlanner(4).plan_cluster(
            d, n_reps=16, scenario=sc, **x),
    }
    mods = {"plan_cluster": (R, P)}.get(entry, (RE, PE))
    if entry == "plan_cluster" and knob == "stream":
        # the static frontier ignores outputs; its torch draws are not the
        # reference's, so it is held to the port's own call without the knob
        got = calls[entry](mods[1], pd, ps, device="cpu")
        assert got == calls[entry](mods[1], pd, pc.Scenario(), device="cpu")
        return
    if reason is None:
        want = calls[entry](mods[0], rd, rs)
        got = calls[entry](mods[1], pd, ps, device="cpu")
        if entry == "plan_cluster":
            assert got.source == "cluster_engine:torch"
            assert _plan_fields(got) == _plan_fields(want)
        elif entry == "frontier_job_times_dynamic":
            _assert_close_f32(want, got, knob)
        elif knob == "stream":
            assert isinstance(got, PE.EpochStreamReport)
            for f in dataclasses.fields(got.stats):
                a = getattr(want.stats, f.name)
                if a is not None:
                    _assert_close_f32(a, getattr(got.stats, f.name), f.name)
        else:
            for f in EXACT + SUMS + ("n_speculative",):
                if getattr(want, f) is not None:
                    _assert_close_f32(getattr(want, f), getattr(got, f), f)
            if knob == "space":  # narrow jobs overlap: the space lane ran
                assert (got.starts[:, 1:] < got.finishes[:, :-1]).any()
            else:
                counter = {"replan": got.n_replans, "speculation": got.n_speculative}[knob]
                assert counter.sum() > 0, knob
        return
    if entry == "plan_cluster" and knob == "devices":
        # the static frontier: devices is a dynamic-path knob
        with pytest.raises(ValueError, match="devices"):
            calls[entry](mods[1], pd, ps, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        calls[entry](mods[1], pd, ps, device="cpu")
    if entry != "plan_cluster":
        assert reason in str(err.value) and entry in str(err.value)


def test_entry_points_need_a_device_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = P.Exponential(1.0)
    sc = pc.Scenario(speeds=(1.0, 0.5, 1.0, 2.0))
    for call in (
        lambda: PE.simulate_epochs(d, 4, 2, np.zeros(2), 2, scenario=sc),
        lambda: PE.frontier_job_times_dynamic(d, 4, [1, 2], 4, scenario=sc),
        lambda: P.RedundancyPlanner(4).plan_cluster(d, n_reps=4, scenario=sc),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    rows = _golden_rows(R, rc, RE.frontier_job_times_dynamic)
    GOLDEN.write_text(json.dumps(dict(GOLDEN_CFG, rows=rows.tolist()), indent=1) + "\n")
    print(f"wrote {GOLDEN}: rows {rows.shape}")
