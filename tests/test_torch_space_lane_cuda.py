"""The epoch scan's space lane on the card, against the port's CPU run, the
JAX package's golden output and the port's event engine.

Every operation of a space-lane step is exact IEEE arithmetic (elementwise,
gathers, sorts, segment min and max, integer counts), so the card's run
equals the CPU's bit for bit, except the two worker-second sums over
replica slots, whose order the card's reduction picks (rtol 1e-12 in
float64).  ``tests/golden/epoch_scan_space.json`` is the JAX package's
float64 output; the card reproduces it the same way.  The port's
``ClusterEngine`` (host numpy) and the space lane on the card replay the
crafted shared schedule exactly.  These tests skip where no NVIDIA card is
present and import neither jax nor the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_space_lane_cuda.py -m cuda -q
"""
import json
import pathlib
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.cluster as pc  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cluster.epoch_scan import (  # noqa: E402
    frontier_job_times_dynamic,
    simulate_epochs,
)

EXACT = ("starts", "finishes", "n_batches_used", "replication_used", "epoch_times",
         "n_worker_failures", "n_replicas_rescued")
SUMS = ("worker_seconds", "cancelled_seconds_saved")
SCHEDULE = pc.ChurnSchedule(
    times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
    wids=(2, 5, 2, 0, 5, 0),
    ups=(False, False, True, False, True, True),
)
SPEEDS6 = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)
PLANS = (pc.JobPlan(workers=3, n_batches=1), pc.JobPlan(workers=2, cancel_redundant=True), None)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "epoch_scan_space.json"

CASES = {
    "schedule_packed": (P.Pareto(1.0, 1.8), 6, 2, np.zeros(8), 24, 3,
                        dict(speeds=SPEEDS6, churn_schedule=SCHEDULE, scheduler="packed",
                             workers_per_job=2)),
    "schedule_balanced_cancel": (P.Exponential(1.0), 6, 2, np.arange(8) * 0.4, 24, 3,
                                 dict(speeds=SPEEDS6, churn_schedule=SCHEDULE,
                                      scheduler="balanced", workers_per_job=2,
                                      cancel_redundant=True)),
    "sampled_plans": (P.ShiftedExponential(0.5, 1.0), 8, 2, np.arange(14) * 0.45, 24, 9,
                      dict(scheduler="packed", workers_per_job=4, job_plans=PLANS,
                           churn=pc.ChurnProcess(0.15, 1.0), churn_pairs_per_worker=3,
                           speeds=tuple(np.random.default_rng(3).uniform(0.5, 2.0, 8)))),
    "gang_mode_plans": (P.Pareto(1.0, 2.0), 6, 3, np.zeros(10), 16, 5,
                        dict(churn_schedule=SCHEDULE, job_plans=PLANS, cancel_redundant=True)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lanes run there by default")
    return torch.device("cuda")


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind != "f":
        return a
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def engine_lane_mismatches(er, vr) -> list:
    """tests/test_space_sharing.py's ``_assert_exact``: the quantities where
    one lane rep (``vr``, rep 0) differs from an engine run (``er``), by
    name -- empty when the trajectory, the epoch times and the accounting
    agree.  The one statement of this contract and its tolerances, read by
    tests/test_torch_engine.py and chip_smoke.py too; it needs no pytest
    fixture and no jax."""
    e_start = np.array([r.start for r in er.records])
    e_fin = np.array([r.finish for r in er.records])
    ea, va = er.accounting(), vr.accounting()
    vt = vr.epoch_times[0]
    checks = {
        "starts": np.allclose(vr.starts[0], e_start, rtol=1e-9, atol=1e-12),
        "finishes": np.allclose(vr.finishes[0], e_fin, rtol=1e-9, atol=1e-12),
        "worker_seconds": np.isclose(va["worker_seconds"][0], ea["worker_seconds"], rtol=1e-9),
        "cancelled_seconds_saved": np.isclose(va["cancelled_seconds_saved"][0],
                                              ea["cancelled_seconds_saved"], rtol=1e-9,
                                              atol=1e-9),
        "n_worker_failures": va["n_worker_failures"][0] == ea["n_worker_failures"],
        "n_replicas_rescued": va["n_replicas_rescued"][0] == ea["n_replicas_rescued"],
        "epoch_times": np.allclose(vt[np.isfinite(vt)], np.asarray(er.epoch_times), rtol=1e-9),
    }
    return [name for name, ok in checks.items() if not ok]


def _assert_same(got, want, rtol):
    for f in EXACT:
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype and a.shape == w.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(w), err_msg=f)
    for f in SUMS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol, atol=0,
                                   err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_space_lane_on_the_card_equals_cpu(card, case, dtype):
    dist, n, b, arrivals, reps, seed, kw = CASES[case]
    sc = pc.Scenario(dtype=dtype, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = simulate_epochs(dist, n, b, arrivals, reps, seed=seed, scenario=sc)
        want = simulate_epochs(dist, n, b, arrivals, reps, seed=seed, scenario=sc, device="cpu")
    _assert_same(got, want, 1e-12 if dtype == "float64" else 1e-5)
    assert np.isfinite(got.finishes).any()


@pytest.mark.cuda
def test_space_frontier_and_fifo_on_the_card_equal_cpu(card):
    dist, n, _, _, _, seed, kw = CASES["sampled_plans"]
    sc = pc.Scenario(dtype="float64", jobs_per_stream=12, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rows = frontier_job_times_dynamic(dist, n, [1, 2, 4], 96, seed=seed, scenario=sc)
        cpu = frontier_job_times_dynamic(dist, n, [1, 2, 4], 96, seed=seed, scenario=sc,
                                         device="cpu")
        parts = frontier_job_times_dynamic(dist, n, [1, 2, 4], 96, seed=seed,
                                           scenario=sc.replace(rep_chunk=3))
    np.testing.assert_array_equal(_bits(rows), _bits(cpu))
    np.testing.assert_array_equal(_bits(rows), _bits(parts))
    fifo = [pc.simulate_fifo(P.Pareto(1.0, 1.8), 16, 2, np.zeros(24), 64, seed=0,
                             scheduler="packed", workers_per_job=5, dtype="float64",
                             device=d) for d in (None, "cpu")]
    for f in ("starts", "finishes"):
        np.testing.assert_array_equal(_bits(getattr(fifo[0], f)), _bits(getattr(fifo[1], f)))


@pytest.mark.cuda
def test_golden_space_runs_on_the_card(card):
    """The JAX package's float64 runs, bitwise but the two sums (1e-12)."""
    golden = json.loads(GOLDEN.read_text())
    for name, g in golden.items():
        case = g["case"]
        kw = dict(case["scenario"], speeds=tuple(case["speeds"]),
                  churn=pc.ChurnProcess(**case["churn"]))
        if case["job_plans"] is not None:
            kw["job_plans"] = [None if p is None else pc.JobPlan(**p) for p in case["job_plans"]]
        dist = getattr(P, case["dist"]["kind"])(**case["dist"]["fields"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rep = simulate_epochs(dist, case["n_workers"], case["n_batches"],
                                  np.asarray(case["arrivals"]), case["n_reps"],
                                  seed=case["seed"], scenario=pc.Scenario(**kw))
        for f in EXACT:
            got = np.asarray(getattr(rep, f))
            want = np.asarray(g[f], dtype=got.dtype)
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{name} {f}")
        for f in SUMS:
            np.testing.assert_allclose(getattr(rep, f), g[f], rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cancel", [False, True], ids=["cancel_off", "cancel_on"])
@pytest.mark.parametrize("policy", ["fifo_gang", "packed", "balanced"])
def test_engine_equals_the_space_lane_on_the_card(card, policy, cancel):
    """tests/test_space_sharing.py's exact fixture: the port's engine on the
    host, the space lane on the card, float64."""
    d = P.Empirical((1.3,))
    jobs = [pc.Job(job_id=i, dist=d, n_tasks=6) for i in range(8)]
    er = pc.ClusterEngine(6, seed=3, n_batches=2, cancel_redundant=cancel, speeds=SPEEDS6,
                          churn_schedule=SCHEDULE, scheduler=policy, workers_per_job=2).run(jobs)
    vr = simulate_epochs(d, 6, 2, np.zeros(8), 1, seed=3,
                         scenario=pc.Scenario(cancel_redundant=cancel, speeds=SPEEDS6,
                                              churn_schedule=SCHEDULE, scheduler=policy,
                                              workers_per_job=2, dtype="float64"))
    assert engine_lane_mismatches(er, vr) == []
