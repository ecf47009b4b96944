"""The epoch scan's in-scan replanner in the port against the reference, on the CPU.

The replanner refits the service-time law from a window of observed task
times with logarithms and ``lgamma``, and torch's and XLA's differ in the
last bits on a large share of that domain, so the fitted parameters and the
closed-form scores cannot be held bitwise.  The contract is on the
replanner's *decisions*:

* exactly equal ``n_replans``, ``final_n_batches`` and per-job (B, r) on
  every fixture, in float32 and float64;
* float64 starts and finishes bitwise (everything downstream of a decision
  is the gang lane's exact arithmetic), worker-second sums within rtol
  1e-12; float32 times within rtol 1e-6;
* at the function level, the port's ``_replan_pick`` on a filled window
  picks the same family and B as the port's and the reference's
  ``OnlineReplanner`` on the same observations, wherever the best candidate
  leads the runner-up by more than 1e-9 relative.

The reference's replanner does not run under jax x64: its ring counters are
int32 and x64 promotes their increments to int64, so its ``while_loop``
refuses the carry (``ROADMAP.md`` §3).  The float64 comparisons therefore
widen ``jnp.int32`` to int64 for the reference's call (:func:`x64_replan`);
that changes the width of integer counters and no float operation.

``tests/golden/epoch_scan_replan.json`` holds the reference's float64 output
for one small replanning scenario, so a run without jax (the card's) can hold
the port to it.  Rewrite it, with the reference, by running
``PYTHONPATH=src python tests/test_torch_replan.py``.
"""
import dataclasses
import json
import pathlib
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.cluster.control as RC  # noqa: E402
import repro.cluster.epoch_scan as RE  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.control as PC  # noqa: E402
import repro_torch.cluster.epoch_scan as PE  # noqa: E402
import repro_torch.core as P  # noqa: E402

DECISIONS = ("n_replans", "n_batches_used", "replication_used")
TIMES = ("starts", "finishes", "epoch_times")
COUNTS = ("n_worker_failures", "n_replicas_rescued")
SUMS = ("worker_seconds", "cancelled_seconds_saved")
GOLDEN = pathlib.Path(__file__).parent / "golden" / "epoch_scan_replan.json"
GOLDEN_CFG = {
    "n_workers": 8,
    "n_batches": 8,
    "n_reps": 4,
    "seed": 13,
    "arrivals": [0.5 * i for i in range(32)],
    "dist": {"kind": "Pareto", "fields": {"sigma": 1.0, "alpha": 1.8}},
    "replan": {"window": 64, "refit_every": 16, "min_observations": 16},
    "speeds": [0.5, 1.75, 1.0, 2.0, 0.75, 1.25, 1.5, 0.625],
    "scenario": {"cancel_redundant": True, "dtype": "float64"},
}
GOLDEN_FIELDS = DECISIONS + ("starts", "finishes") + SUMS


@pytest.fixture
def x64_replan(monkeypatch):
    """jax x64 on, with the reference's int32 counters widened to int64."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(jnp, "int32", jnp.int64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _speeds(n, seed, lo=0.5, hi=2.0):
    return tuple(float(s) for s in np.random.default_rng(seed).uniform(lo, hi, size=n))


def _scenarios(replan, **kw):
    """The same scenario in both packages (configs are per-package)."""
    ref, port = dict(kw), dict(kw)
    for name, cls in (("churn", "ChurnProcess"), ("churn_schedule", "ChurnSchedule")):
        if kw.get(name) is not None:
            fields = dataclasses.asdict(kw[name])
            ref[name] = getattr(rc, cls)(**fields)
            port[name] = getattr(pc, cls)(**fields)
    return (rc.Scenario(replan=RE.ReplanConfig(**replan), **ref),
            pc.Scenario(replan=PE.ReplanConfig(**replan), **port))


def _run_both(kind, fields, n, b, arrivals, reps, seed, replan, **kw):
    rs, ps = _scenarios(replan, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = RE.simulate_epochs(getattr(R, kind)(**fields), n, b, arrivals, reps, seed=seed,
                                 scenario=rs)
        port = PE.simulate_epochs(getattr(P, kind)(**fields), n, b, arrivals, reps, seed=seed,
                                  scenario=ps, device="cpu")
    return ref, port


def _assert_decisions_and_times(ref, port, dtype):
    """Decisions exactly; float64 times bitwise (sums rtol 1e-12); float32
    times within rtol 1e-6."""
    for f in DECISIONS + COUNTS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(port.final_n_batches, ref.final_n_batches)
    for f in TIMES + SUMS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape, f
        if dtype == "float64" and f in TIMES:
            np.testing.assert_array_equal(b.view(np.uint64), a.view(np.uint64), err_msg=f)
            continue
        np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a), err_msg=f)
        fin = np.isfinite(a)
        rtol = 1e-12 if dtype == "float64" else 1e-6
        np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=0, err_msg=f)


# --------------------------------------------------------------------------
# the reference's own replanning tests (tests/test_epoch_scan.py), both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_replanning_converges_to_closed_form_optimum(seed):
    """Exponential tails: E[T] = H_B / mu is least at B* = 1.  Starting at
    full parallelism, the windowed replanner lands on B* in every rep, as the
    reference's does, with the same decisions."""
    n, n_jobs = 8, 80
    b_star = P.analysis.argmin_B(P.Exponential(1.0), n, metric="mean")
    replan = dict(window=256, refit_every=64, min_observations=64)
    ref, port = _run_both("Exponential", {"mu": 1.0}, n, n, np.zeros(n_jobs), 2, seed, replan)
    assert (port.n_replans >= 1).all()
    assert (port.final_n_batches == b_star).all() and b_star == 1
    _assert_decisions_and_times(ref, port, "float32")
    ctl = PE.ReplanConfig(**replan).to_controller(n)
    ctl.observe_many(P.Exponential(1.0).sample_np(np.random.default_rng(seed), (256,)))
    assert ctl.maybe_replan().n_batches == b_star


def test_replanning_under_cancellation_censoring():
    """With cancellation only batch winners are observed; undoing the
    min-of-r censoring keeps the replanner on B* = 1."""
    replan = dict(window=256, refit_every=32, min_observations=32)
    ref, port = _run_both("Exponential", {"mu": 1.0}, 8, 8, np.zeros(100), 4, 2, replan,
                          cancel_redundant=True)
    assert (port.n_replans >= 1).all()
    assert (port.final_n_batches == 1).all()
    _assert_decisions_and_times(ref, port, "float32")


# --------------------------------------------------------------------------
# the decision contract, float32 and float64, cancellation on and off,
# churn and heterogeneous speeds, every objective
# --------------------------------------------------------------------------


CASES = {
    "exp_mean": ("Exponential", {"mu": 1.0}, 8, 8, np.zeros(40), 4, 2,
                 dict(window=64, refit_every=16, min_observations=16), {}),
    "pareto_cancel_speeds": ("Pareto", {"sigma": 1.0, "alpha": 1.8}, 8, 8, np.zeros(40), 6, 2,
                             dict(window=64, refit_every=16, min_observations=16),
                             dict(cancel_redundant=True, speeds=_speeds(8, 1))),
    "sexp_cov_speeds": ("ShiftedExponential", {"delta": 1.0, "mu": 0.5}, 8, 8, np.zeros(40), 6,
                        2, dict(window=64, refit_every=16, min_observations=16, objective="cov"),
                        dict(speeds=_speeds(8, 1))),
    "exp_blend_cancel": ("Exponential", {"mu": 1.0}, 8, 8, np.zeros(40), 6, 2,
                         dict(window=64, refit_every=16, min_observations=16, objective="blend",
                              blend=0.3),
                         dict(cancel_redundant=True)),
    "sampled_churn_cancel": ("ShiftedExponential", {"delta": 1.0, "mu": 0.5}, 12, None,
                             np.arange(30) * 0.5, 6, 7,
                             dict(window=96, refit_every=24, min_observations=24),
                             dict(cancel_redundant=True, size_dependent=True,
                                  churn=rc.ChurnProcess(fail_rate=0.05, mean_downtime=1.0),
                                  churn_pairs_per_worker=4, speeds=_speeds(12, 2))),
    "schedule_pareto": ("Pareto", {"sigma": 1.0, "alpha": 2.0}, 6, 6, np.arange(30) * 0.5, 6,
                        4, dict(window=48, refit_every=12, min_observations=12,
                                objective="blend"),
                        dict(speeds=(1.0, 1.5, 0.7, 1.2, 0.9, 1.1),
                             churn_schedule=rc.ChurnSchedule(
                                 times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
                                 wids=(2, 5, 2, 0, 5, 0),
                                 ups=(False, False, True, False, True, True)))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decisions_equal_reference_float32(case):
    kind, fields, n, b, arrivals, reps, seed, replan, kw = CASES[case]
    ref, port = _run_both(kind, fields, n, b, arrivals, reps, seed, replan, **kw)
    assert port.n_replans.sum() > 0
    _assert_decisions_and_times(ref, port, "float32")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decisions_equal_reference_float64(x64_replan, case):
    kind, fields, n, b, arrivals, reps, seed, replan, kw = CASES[case]
    ref, port = _run_both(kind, fields, n, b, arrivals, reps, seed, replan, dtype="float64",
                          **kw)
    assert port.n_replans.sum() > 0
    _assert_decisions_and_times(ref, port, "float64")


PLANNING = (dict(window=64, refit_every=16, min_observations=16),
            dict(speeds=_speeds(8, 0), jobs_per_stream=24))


def test_frontier_rows_match_reference_float64(x64_replan):
    """The planning path with the replanner running in every lane: frontier
    rows bitwise in float64."""
    rs, ps = _scenarios(PLANNING[0], dtype="float64", **PLANNING[1])
    want = RE.frontier_job_times_dynamic(R.Pareto(1.0, 1.8), 8, [1, 2, 4, 8], 96, seed=2,
                                         scenario=rs)
    got = PE.frontier_job_times_dynamic(P.Pareto(1.0, 1.8), 8, [1, 2, 4, 8], 96, seed=2,
                                        scenario=ps, device="cpu")
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (4, 96)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_plan_cluster_matches_reference():
    """The same plan as the reference's (float32 lanes, the default)."""
    rs, ps = _scenarios(PLANNING[0], **PLANNING[1])
    rd, pd = R.Pareto(1.0, 1.8), P.Pareto(1.0, 1.8)
    ref_plan = R.RedundancyPlanner(8).plan_cluster(rd, n_reps=96, seed=2, scenario=rs)
    plan = P.RedundancyPlanner(8).plan_cluster(pd, n_reps=96, seed=2, scenario=ps, device="cpu")
    assert plan.source == "cluster_engine:torch"
    got, want = dataclasses.asdict(plan), dataclasses.asdict(ref_plan)
    assert {k: v for k, v in got.items() if k != "source"} == {
        k: v for k, v in want.items() if k != "source"}


def test_rep_chunk_bit_identical_with_the_replanner():
    kind, fields, n, b, arrivals, reps, seed, replan, kw = CASES["sampled_churn_cancel"]
    _, ps = _scenarios(replan, dtype="float64", **kw)
    d = getattr(P, kind)(**fields)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed, scenario=ps, device="cpu")
        parts = PE.simulate_epochs(d, n, b, arrivals, reps, seed=seed,
                                   scenario=ps.replace(rep_chunk=4), device="cpu")
    for f in DECISIONS + TIMES + SUMS:
        np.testing.assert_array_equal(getattr(parts, f), getattr(one, f), err_msg=f)


# --------------------------------------------------------------------------
# the function level: _replan_pick against both OnlineReplanners
# --------------------------------------------------------------------------


FAMILIES = ("Exponential", "ShiftedExponential", "Pareto")


def _lls(x):
    """The three families' log-likelihoods, as core.planner.fit_service_time scores them."""
    n, xmin, xbar = x.size, x.min(), x.mean()
    mu = 1.0 / xbar
    out = [n * np.log(mu) - mu * x.sum()]
    out.append(n * np.log(1.0 / (xbar - xmin)) - (x - xmin).sum() / (xbar - xmin)
               if xbar > xmin else -np.inf)
    s = np.log(x / xmin).sum()
    alpha = n / s if s > 0 else np.nan
    out.append(n * np.log(alpha) + n * alpha * np.log(xmin) - (alpha + 1.0) * np.log(x).sum()
               if s > 0 else -np.inf)
    return np.array(out)


def _margin(scores):
    """The best score's relative lead over the runner-up (inf with one candidate)."""
    s = np.sort(np.asarray(scores, np.float64)[np.isfinite(scores)])
    if s.size < 2:
        return np.inf
    return (s[1] - s[0]) / max(abs(s[0]), abs(s[1]), 1e-300)


def _plan_scores(plan, objective, blend):
    means, covs = np.array(plan.frontier_mean), np.array(plan.frontier_cov)
    if objective == "mean":
        return means
    if objective == "cov":
        return covs
    finite = np.isfinite(means) & np.isfinite(covs)
    norm = []
    for v in (means, covs):
        lo = v[finite].min()
        norm.append(np.where(finite, (v - lo) / max(v[finite].max() - lo, 1e-12), 0.0))
    return np.where(finite, blend * norm[0] + (1 - blend) * norm[1], np.inf)


def _scan_pick(obs, comps, n_alive, n_workers, objective, blend, window):
    cfg = PE._RunnerCfg(PE._bucket_workers(n_workers), 1, 1, 8, 1, False, False, "float64",
                        replan=PE.ReplanConfig(window=window, objective=objective, blend=blend))
    k = len(obs)
    st = {"obs_val": torch.zeros(1, window + 1, dtype=torch.float64),
          "obs_comp": torch.ones(1, window + 1, dtype=torch.float64),
          "obs_count": torch.tensor([k]), "plan_b": torch.tensor([0])}
    st["obs_val"][0, :k] = torch.from_numpy(obs)
    st["obs_comp"][0, :k] = torch.from_numpy(comps)
    alive = torch.zeros(1, cfg.n, dtype=torch.bool)
    alive[0, :n_alive] = True
    b, fam = PE._replan_pick(cfg, st, PE._replan_inputs(cfg, n_workers, "cpu"), alive)
    return int(b[0]), FAMILIES[int(fam[0])]


PICKS = [(law, seed, k, c, n_alive, objective)
         for law in FAMILIES
         for seed, k, c, n_alive in ((0, 64, 1, 12), (1, 200, 2, 12), (2, 128, 3, 7),
                                     (3, 96, 1, 10))
         for objective in ("mean", "cov", "blend")]


@pytest.mark.parametrize("law,seed,k,c,n_alive,objective", PICKS)
def test_replan_pick_matches_both_controllers(law, seed, k, c, n_alive, objective):
    fields = {"Exponential": dict(mu=0.8), "ShiftedExponential": dict(delta=1.0, mu=0.5),
              "Pareto": dict(sigma=1.0, alpha=1.8)}[law]
    obs = getattr(R, law)(**fields).sample_np(np.random.default_rng(seed), (k,))
    comps = np.full(k, float(c))
    comps[: k // 3] = 1.0  # a censoring count that changed midway
    plans = []
    for mod in (RC, PC):
        ctl = mod.OnlineReplanner(n_alive, objective=objective, window=256, blend=0.4)
        for t, ci in zip(obs, comps):
            ctl.observe(float(t), int(ci))
        plans.append((ctl.replan(n_alive), type(ctl.last_fit).__name__))
    (ref_plan, ref_fam), (port_plan, port_fam) = plans
    assert dataclasses.asdict(port_plan) == dataclasses.asdict(ref_plan)
    assert port_fam == ref_fam
    b, fam = _scan_pick(obs, comps, n_alive, 12, objective, 0.4, 256)
    fam_margin = _margin(-_lls(obs))
    b_margin = _margin(_plan_scores(ref_plan, objective, 0.4))
    if fam_margin > 1e-9:
        assert fam == ref_fam, (fam_margin, fam, ref_fam)
    if fam_margin > 1e-9 and b_margin > 1e-9:
        assert b == ref_plan.n_batches, (b_margin, b, ref_plan.n_batches)


def test_replan_pick_keeps_b_without_alive_workers():
    obs = np.linspace(1.0, 3.0, 32)
    cfg_b, _ = _scan_pick(obs, np.ones(32), 0, 8, "mean", 0.5, 64)
    assert cfg_b == 0  # the lane's plan_b (0 = full parallelism) stands


# --------------------------------------------------------------------------
# ReplanConfig, Scenario JSON and validation, as in the reference
# --------------------------------------------------------------------------


def test_replan_config_mirrors_reference_and_builds_the_controller():
    assert dataclasses.asdict(PE.ReplanConfig()) == dataclasses.asdict(RE.ReplanConfig())
    assert pc.ReplanConfig is PE.ReplanConfig
    cfg = PE.ReplanConfig(window=100, refit_every=10, min_observations=20, objective="blend",
                          blend=0.25)
    ctl = cfg.to_controller(12)
    ref = RE.ReplanConfig(**dataclasses.asdict(cfg)).to_controller(12)
    assert isinstance(ctl, PC.OnlineReplanner)
    for f in ("n_workers", "objective", "blend", "window", "refit_every", "min_observations"):
        assert getattr(ctl, f) == getattr(ref, f), f
    assert hash(cfg) == hash(PE.ReplanConfig(**dataclasses.asdict(cfg)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.window = 3


@pytest.mark.parametrize("objective", ["mean", "cov", "blend"])
def test_scenario_json_with_replan_round_trips_both_ways(objective):
    rs, ps = _scenarios(dict(window=256, refit_every=64, min_observations=32,
                             objective=objective, blend=0.7), speeds=(1.0, 2.0, 0.5, 1.5))
    assert ps.to_json() == rs.to_json()
    got = pc.Scenario.from_json(rs.to_json())
    assert isinstance(got.replan, PE.ReplanConfig) and got == ps
    assert rc.Scenario.from_json(ps.to_json()) == rs


@pytest.mark.parametrize(
    "kw,n,match",
    [
        (dict(replan=dict(objective="median")), 4, "unknown objective"),
        (dict(replan=dict(window=8)), 16, "window must be >= n_workers"),
        (dict(replan={}, speculation=True), 4, "mutually exclusive"),
        (dict(replan={}, scheduler="packed"), 4, "not supported with"),
    ],
    ids=["objective", "window", "speculation", "space"],
)
def test_validate_errors_match_reference(kw, n, match):
    errors = []
    for pkg, cfg_cls, backend in ((rc, RE.ReplanConfig, "jax"), (pc, PE.ReplanConfig, "torch")):
        fields = dict(kw, replan=cfg_cls(**kw["replan"]))
        if fields.get("speculation"):
            fields["speculation"] = pkg.Speculation()
        with pytest.raises(ValueError, match=match) as err:
            pkg.Scenario(**fields).validate(n_workers=n, backend=backend)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="either controller"):
        pc.Scenario(replan=PE.ReplanConfig()).validate(controller=PC.OnlineReplanner(4))


# --------------------------------------------------------------------------
# the golden: the reference's float64 replanning run, for runs without jax
# --------------------------------------------------------------------------


def _golden_run(pkg_core, pkg_cluster, epoch_scan, **extra):
    cfg = GOLDEN_CFG
    sc = pkg_cluster.Scenario(replan=epoch_scan.ReplanConfig(**cfg["replan"]),
                              speeds=tuple(cfg["speeds"]), **cfg["scenario"])
    dist = getattr(pkg_core, cfg["dist"]["kind"])(**cfg["dist"]["fields"])
    rep = epoch_scan.simulate_epochs(dist, cfg["n_workers"], cfg["n_batches"],
                                     np.asarray(cfg["arrivals"]), cfg["n_reps"],
                                     seed=cfg["seed"], scenario=sc, **extra)
    return {f: np.asarray(getattr(rep, f)) for f in GOLDEN_FIELDS}


def test_golden_replan_run_is_the_references_and_the_ports(x64_replan):
    golden = json.loads(GOLDEN.read_text())
    assert {k: golden[k] for k in GOLDEN_CFG} == GOLDEN_CFG
    ref = _golden_run(R, rc, RE)
    port = _golden_run(P, pc, PE, device="cpu")
    assert (np.asarray(golden["n_replans"]) >= 1).all()
    for f in GOLDEN_FIELDS:
        want = np.asarray(golden[f], dtype=port[f].dtype)
        np.testing.assert_array_equal(ref[f], want, err_msg=f)
        if f in SUMS:
            np.testing.assert_allclose(port[f], want, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(port[f], want, err_msg=f)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    jnp.int32 = jnp.int64  # the reference's replanner under x64 (see the module docstring)
    run = _golden_run(R, rc, RE)
    GOLDEN.write_text(json.dumps(dict(GOLDEN_CFG, **{k: v.tolist() for k, v in run.items()}),
                                 indent=1) + "\n")
    print(f"wrote {GOLDEN}: replans {run['n_replans'].tolist()}")
