"""The port's planning loop against the reference, on the CPU.

Where the reference draws with ``jax.random`` (the frontier, the FIFO scan)
the port's torch draws differ, so those paths agree in law: 3 sigma per
candidate, and exactly the same B* on fixtures whose best-versus-runner-up
margin exceeds 6 sigma (asserted, not assumed).  The closed-form and
bootstrap planners are numpy in both packages and must agree exactly.
"""
import ast
import dataclasses
import math
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference runs on jax)
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.cluster.epoch_scan as PE  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.cluster.epoch_scan import ReplanConfig  # noqa: E402
from repro.cluster.vectorized import frontier_job_times as ref_frontier  # noqa: E402
from repro.cluster.vectorized import simulate_fifo as ref_fifo  # noqa: E402
from repro.core.traces import synthetic_google_jobs  # noqa: E402
from repro_torch.cluster.vectorized import frontier_job_times, simulate_fifo  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOB1 = next(j for j in synthetic_google_jobs() if j.name == "job1").task_times


def _z_mean(a: np.ndarray, b: np.ndarray) -> float:
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    return float(abs(a.mean() - b.mean()) / se)


def _pair(kind, **fields):
    return getattr(R, kind)(**fields), getattr(P, kind)(**fields)


# exponential (B* = 1), Pareto with finite mean (B* = 6 at N = 12) and the
# §VII exponential-tail trace job 1 (B* = N): each with a margin > 6 sigma
FIXTURES = {
    "exp": _pair("Exponential", mu=1.0),
    "pareto": _pair("Pareto", sigma=1.0, alpha=2.0),
    "job1": _pair("Empirical", samples=tuple(JOB1)),
}


def _margin_sigmas(plan, n_reps) -> float:
    """(runner-up mean - best mean) over the standard error of that difference."""
    m, cv = np.array(plan.frontier_mean), np.array(plan.frontier_cov)
    se = m * cv / math.sqrt(n_reps)
    best, runner = np.argsort(m)[:2]
    return float((m[runner] - m[best]) / math.hypot(se[best], se[runner]))


# --------------------------------------------------------------------------
# frontier and planner
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,fields",
    [
        ("Exponential", {"mu": 1.0}),
        ("ShiftedExponential", {"delta": 0.3, "mu": 1.0}),
        ("Pareto", {"sigma": 1.0, "alpha": 3.0}),
        ("Empirical", {"samples": tuple(JOB1)}),
    ],
    ids=["exp", "sexp", "pareto", "job1"],
)
def test_frontier_job_times_agrees_per_candidate_3_sigma(kind, fields):
    r, p = _pair(kind, **fields)
    cands = [1, 2, 3, 4, 6, 12]
    want = ref_frontier(r, 12, cands, 20_000, seed=1)
    got = frontier_job_times(p, 12, cands, 20_000, seed=1, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    for i, b in enumerate(cands):
        assert _z_mean(got[i], want[i]) < 3.0, (b, got[i].mean(), want[i].mean())


def test_frontier_job_times_deterministic_and_seed_sensitive():
    d = P.Pareto(1.0, 2.0)
    a = frontier_job_times(d, 6, [1, 2, 3], 200, seed=3, device="cpu")
    b = frontier_job_times(d, 6, [1, 2, 3], 200, seed=3, device="cpu")
    c = frontier_job_times(d, 6, [1, 2, 3], 200, seed=4, device="cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert frontier_job_times(d, 6, [2], 50, device="cpu", dtype="float64").dtype == np.float64
    for bad in ([0, 2], [8], []):
        with pytest.raises(ValueError):
            frontier_job_times(d, 4, bad, 10, device="cpu")


@pytest.mark.parametrize("chunk", [1, 7, 16, 50])
def test_frontier_rep_chunk_bit_identical(chunk):
    """Mirrors the reference's static-frontier chunk test
    (``tests/test_vectorized_backend.py``): rep k draws the same Philox
    numbers in every chunking, so the rows are bit-identical to one launch."""
    d = P.Pareto(1.0, 2.0)
    full = frontier_job_times(d, 8, [1, 2, 4, 8], 50, seed=5, device="cpu")
    part = frontier_job_times(d, 8, [1, 2, 4, 8], 50, seed=5, rep_chunk=chunk, device="cpu")
    assert part.shape == full.shape and part.dtype == full.dtype
    assert np.array_equal(full, part)


def test_frontier_rep_chunk_stays_equivalent_to_the_reference_and_validates():
    r, p = _pair("Pareto", sigma=1.0, alpha=2.0)
    a = frontier_job_times(p, 8, [2], 4000, seed=5, rep_chunk=1000, device="cpu")[0]
    b = ref_frontier(r, 8, [2], 4000, seed=6, rep_chunk=1000)[0]
    assert _z_mean(a, b) < 3.0
    f64 = frontier_job_times(p, 8, [2, 8], 30, seed=5, device="cpu", dtype="float64")
    assert np.array_equal(
        f64, frontier_job_times(p, 8, [2, 8], 30, seed=5, rep_chunk=4, device="cpu",
                                dtype="float64"))
    assert frontier_job_times(p, 8, [2], 0, device="cpu", rep_chunk=3).shape == (1, 0)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="rep_chunk"):
            frontier_job_times(p, 8, [2], 10, rep_chunk=bad, device="cpu")


def test_plan_cluster_takes_rep_chunk_from_the_scenario():
    d = P.Exponential(1.0)
    plain = P.RedundancyPlanner(6).plan_cluster(d, n_reps=300, seed=3, device="cpu")
    chunked = P.RedundancyPlanner(6).plan_cluster(
        scenario=pc.Scenario(dist=d, rep_chunk=64), n_reps=300, seed=3, device="cpu")
    assert chunked == plain


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plan_cluster_exact_b_star(name):
    r, p = FIXTURES[name]
    n_reps = 4000
    want = R.RedundancyPlanner(12).plan_cluster(r, n_reps=n_reps, seed=2)
    got = P.RedundancyPlanner(12).plan_cluster(p, n_reps=n_reps, seed=2, device="cpu")
    assert _margin_sigmas(want, n_reps) > 6.0 and _margin_sigmas(got, n_reps) > 6.0
    assert got.n_batches == want.n_batches and got.replication == want.replication
    assert got.frontier_B == want.frontier_B
    assert got.source == "cluster_engine:torch"


def test_plan_sweep_exact_b_star_and_seed_derivation():
    names = sorted(FIXTURES)
    budgets, n_reps = [6, 12], 4000
    want = R.plan_sweep([FIXTURES[k][0] for k in names], budgets, n_reps=n_reps, seed=5)
    got = P.plan_sweep([FIXTURES[k][1] for k in names], budgets, n_reps=n_reps, seed=5,
                       device="cpu")
    for i, name in enumerate(names):
        for j, n in enumerate(budgets):
            w, g = want[i][j], got[i][j]
            assert _margin_sigmas(w, n_reps) > 6.0 and _margin_sigmas(g, n_reps) > 6.0, (name, n)
            assert g.n_batches == w.n_batches, (name, n)
    # grid point (i, j) is the plan_cluster call seeded seed + i * len(budgets) + j
    again = P.RedundancyPlanner(12).plan_cluster(
        FIXTURES[names[2]][1], n_reps=n_reps, seed=5 + 2 * 2 + 1, device="cpu"
    )
    assert again == got[2][1]


@pytest.mark.parametrize("objective", ["mean", "cov", "blend"])
def test_plan_and_plan_empirical_exact(objective):
    for kind, fields in [
        ("Exponential", {"mu": 0.7}),
        ("ShiftedExponential", {"delta": 0.2, "mu": 1.3}),
        ("Pareto", {"sigma": 1.0, "alpha": 1.6}),
    ]:
        r, p = _pair(kind, **fields)
        want = R.RedundancyPlanner(24).plan(r, objective)
        assert dataclasses.asdict(P.RedundancyPlanner(24).plan(p, objective)) == (
            dataclasses.asdict(want)
        )
    want = R.RedundancyPlanner(12).plan_empirical(JOB1, objective, n_mc=2000, seed=3)
    got = P.RedundancyPlanner(12).plan_empirical(JOB1, objective, n_mc=2000, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = R.RedundancyPlanner(12).plan_auto(JOB1, objective)
    assert dataclasses.asdict(P.RedundancyPlanner(12).plan_auto(JOB1, objective)) == (
        dataclasses.asdict(want)
    )


# --------------------------------------------------------------------------
# FIFO queueing
# --------------------------------------------------------------------------


def test_simulate_fifo_invariant_and_response_means_3_sigma():
    d_ref, d = _pair("Exponential", mu=1.0)
    arrivals = np.arange(12) * 2.0
    on = simulate_fifo(d, 8, 2, arrivals, 800, seed=5, cancel_redundant=True, device="cpu")
    off = simulate_fifo(d, 8, 2, arrivals, 800, seed=5, cancel_redundant=False, device="cpu")
    assert np.array_equal(on.compute_times, off.compute_times)
    np.testing.assert_allclose(
        on.worker_seconds + on.cancelled_seconds_saved, off.worker_seconds, rtol=1e-5
    )
    assert (on.cancelled_seconds_saved > 0).all() and (off.cancelled_seconds_saved == 0).all()
    assert (on.response_times <= off.response_times + 1e-5).all()
    for cancel in (False, True):
        got = simulate_fifo(d, 8, 2, arrivals, 3000, seed=7, cancel_redundant=cancel,
                            device="cpu")
        want = ref_fifo(d_ref, 8, 2, arrivals, 3000, seed=7, cancel_redundant=cancel)
        z = _z_mean(got.response_times.mean(axis=1), want.response_times.mean(axis=1))
        assert z < 3.0, (cancel, got.response_times.mean(), want.response_times.mean())


def test_simulate_fifo_waits_invariant_to_arrival_offset():
    d = P.Pareto(1.0, 2.0)
    arr = np.arange(10) * 1.5
    a = simulate_fifo(d, 8, 2, arr, 300, seed=9, device="cpu")
    b = simulate_fifo(d, 8, 2, arr + 1e7, 300, seed=9, device="cpu")
    assert np.array_equal(a.queue_waits, b.queue_waits)
    assert np.array_equal(a.compute_times, b.compute_times)
    with pytest.raises(ValueError, match="sorted"):
        simulate_fifo(d, 4, 2, [3.0, 1.0], 10, device="cpu")


# --------------------------------------------------------------------------
# scenario state across packages, devices, and what is not ported yet
# --------------------------------------------------------------------------


def _scenarios():
    return [
        rc.Scenario(),
        rc.Scenario(
            dist=R.Pareto(1.0, 1.8), n_workers=8, n_batches=2, n_tasks=16,
            cancel_redundant=True, speeds=tuple(1.0 - 0.05 * i for i in range(8)),
            churn=rc.ChurnProcess(fail_rate=0.1, mean_downtime=2.0),
            speculation=rc.Speculation(interval=0.5), retry=rc.Retry(max_attempts=3),
            faults=rc.FaultPlan(kills=((1, 0.5),), drop_p=0.1),
            slo=rc.SLO(quantile=0.99, target_s=30.0, arrival_rate=0.5),
            scheduler="packed", workers_per_job=4,
            job_plans=(rc.JobPlan(workers=4, n_batches=2), None),
            rep_chunk=64, dtype="float64", outputs="stream",
        ),
        rc.Scenario(
            dist=R.Empirical(samples=tuple(JOB1[:50])),
            churn_schedule=rc.ChurnSchedule(times=(0.5, 1.5), wids=(2, 2), ups=(False, True)),
            jobs_per_stream=4,
        ),
    ]


@pytest.mark.parametrize("i", range(3))
def test_scenario_json_round_trips_byte_for_byte(i):
    s = _scenarios()[i].to_json()
    assert pc.Scenario.from_json(s).to_json() == s


def test_scenario_validate_accepts_torch_backend():
    pc.Scenario(dist=P.Exponential(1.0)).validate(8, backend="torch")
    with pytest.raises(ValueError, match="retry"):
        pc.Scenario(retry=pc.Retry()).validate(8, backend="torch")
    replan = rc.Scenario(replan=ReplanConfig(window=64, objective="blend")).to_json()
    got = pc.Scenario.from_json(replan)
    assert got.replan == PE.ReplanConfig(window=64, objective="blend")
    assert got.to_json() == replan


def test_entry_points_need_a_device_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = P.Exponential(1.0)
    for call in (
        lambda: frontier_job_times(d, 4, [1, 2], 10),
        lambda: simulate_fifo(d, 4, 2, [0.0], 10),
        lambda: P.RedundancyPlanner(4).plan_cluster(d, n_reps=10),
        lambda: P.plan_sweep([d], [4], n_reps=10),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def _fields(plan) -> dict:
    """A plan's fields but its ``source`` (the packages' plan classes differ)."""
    return {k: v for k, v in dataclasses.asdict(plan).items() if k != "source"}


@pytest.mark.parametrize(
    "call",
    [
        # (the reference's call, the port's call)
        (lambda: ref_fifo(R.Exponential(1.0), 4, 2, [0.0], 5, scheduler="packed"),
         lambda: simulate_fifo(P.Exponential(1.0), 4, 2, [0.0], 5, scheduler="packed",
                               device="cpu")),
        (lambda: R.RedundancyPlanner(4).plan_cluster(R.Exponential(1.0), backend="python"),
         lambda: P.RedundancyPlanner(4).plan_cluster(P.Exponential(1.0), backend="python")),
        (lambda: R.RedundancyPlanner(4).plan_cluster(
            scenario=rc.Scenario(dist=R.Exponential(1.0), scheduler="packed",
                                 workers_per_job=2)),
         lambda: P.RedundancyPlanner(4).plan_cluster(
            scenario=pc.Scenario(dist=P.Exponential(1.0), scheduler="packed",
                                 workers_per_job=2),
            device="cpu")),
        (None,
         lambda: P.RedundancyPlanner(2).plan_slo(
            P.Exponential(1.0), pc.SLO(target_s=60.0, arrival_rate=0.05),
            scenario=pc.Scenario(speeds=(1.0, 0.5)), n_jobs=20, device="cpu")),
    ],
    ids=["space", "python-backend", "dynamic", "dynamic-slo"],
)
def test_later_slices_raise_not_implemented(call, request):
    """What earlier slices refused now runs and equals the reference: a
    space-shared ``simulate_fifo`` (the space lane on host numpy draws,
    float32: starts and finishes within rtol 1e-6), ``plan_cluster`` on the
    event engine (``backend="python"``: the same plan) and a space scenario
    on the planner (the space lane's frontier: the same plan); a dynamic
    ``plan_slo`` runs on the epoch scan (its match against the reference is
    in tests/test_torch_slo.py)."""
    ref_call, port_call = call
    got = port_call()
    case = request.node.callspec.id
    if case == "dynamic-slo":
        assert got.source == "epoch_scan"
        return
    want = ref_call()
    if case == "space":
        for f in ("starts", "finishes", "worker_seconds"):
            a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
            assert a.shape == b.shape, f
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        return
    assert got.source == want.source.replace("jax", "torch")
    assert _fields(got) == _fields(want)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    # the engine's numpy copies and the live runtime are scanned like every
    # other module
    assert {"events.py", "master.py"} <= {f.name for f in files}
    runtime_dir = ROOT / "src" / "repro_torch" / "cluster" / "runtime"
    runtime = {f.name for f in files if f.parent == runtime_dir}
    assert runtime == {"__init__.py", "__main__.py", "chaos.py", "master.py", "protocol.py",
                       "trace.py", "worker.py"}
    # the model zoo, every family's module
    models_dir = ROOT / "src" / "repro_torch" / "models"
    assert {"moe.py", "rglru.py", "hybrid.py", "ssm.py", "mamba.py"} <= {
        f.name for f in files if f.parent == models_dir}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.cluster, repro_torch.kernels.cover\n"
        "import repro_torch.cluster.events, repro_torch.cluster.master\n"
        "import repro_torch.cluster.runtime, repro_torch.cluster.runtime.worker\n"
        "import repro_torch.models.moe, repro_torch.models.rglru, repro_torch.models.hybrid\n"
        "import repro_torch.models.ssm, repro_torch.models.mamba, repro_torch.launch.serve\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "module",
    ["repro_torch.cluster", "repro_torch.cluster.vectorized", "repro_torch.core.service_time",
     "repro_torch.kernels.cover", "repro_torch.cluster.stream", "repro_torch.core.coupon",
     "repro_torch.cluster.epoch_scan", "repro_torch.cluster.control",
     "repro_torch.cluster.events", "repro_torch.cluster.master",
     "repro_torch.cluster.runtime", "repro_torch.cluster.runtime.trace"],
)
def test_each_module_imports_first_in_a_fresh_process(module):
    """``cluster`` and ``core`` import each other at package level; whichever
    a process meets first must import cleanly."""
    out = subprocess.run(
        [sys.executable, "-c", f"import {module}"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
