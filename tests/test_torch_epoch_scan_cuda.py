"""The epoch scan's gang lane on the card, against the port's CPU run.

Every operation of a step is exact IEEE arithmetic (elementwise, gathers,
segment min and max), so the card's run equals the CPU's bit for bit in
float64 and float32, except the two worker-second sums over replica slots,
whose order the card's reduction picks (rtol 1e-12 in float64).  These tests
skip where no NVIDIA card is present and import neither jax nor the reference
package:

    PYTHONPATH=src python -m pytest tests/test_torch_epoch_scan_cuda.py -m cuda -q
"""
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
         "n_worker_failures", "n_replicas_rescued", "n_replans")
SUMS = ("worker_seconds", "cancelled_seconds_saved")
SCHEDULE = pc.ChurnSchedule(
    times=(0.7, 1.9, 3.35, 5.1, 7.77, 9.4),
    wids=(2, 5, 2, 0, 5, 0),
    ups=(False, False, True, False, True, True),
)
SPEEDS6 = (1.0, 1.5, 0.7, 1.2, 0.9, 1.1)


def _speeds(n, seed, lo=0.5, hi=2.0):
    return tuple(float(s) for s in np.random.default_rng(seed).uniform(lo, hi, size=n))


# the CPU parity tests' fixtures (tests/test_torch_epoch_scan.py)
CASES = {
    "static_exp": (P.Exponential(1.0), 8, 4, np.zeros(20), 150, 0, {}),
    "schedule_cancel_off": (P.Pareto(1.0, 2.0), 6, 3, np.arange(8) * 0.5, 40, 4,
                            dict(speeds=SPEEDS6, churn_schedule=SCHEDULE)),
    "schedule_cancel_on": (P.Pareto(1.0, 2.0), 6, 3, np.arange(8) * 0.5, 40, 4,
                           dict(cancel_redundant=True, speeds=SPEEDS6, churn_schedule=SCHEDULE)),
    "hetero": (P.Exponential(1.0), 6, 3, np.zeros(30), 300, 6, dict(speeds=_speeds(6, 11))),
    "sampled_churn": (P.ShiftedExponential(1.0, 0.5), 8, None, np.zeros(12), 48, 7,
                      dict(cancel_redundant=True, churn=pc.ChurnProcess(0.1, 1.0),
                           churn_pairs_per_worker=4, speeds=_speeds(8, 2))),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_epochs_on_the_card_equals_cpu(card, case, dtype):
    dist, n, b, arrivals, reps, seed, kw = CASES[case]
    sc = pc.Scenario(dtype=dtype, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = simulate_epochs(dist, n, b, arrivals, reps, seed=seed, scenario=sc)
        want = simulate_epochs(dist, n, b, arrivals, reps, seed=seed, scenario=sc, device="cpu")
    for f in EXACT:
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype and a.shape == w.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(w), err_msg=f)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    for f in SUMS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol, atol=0,
                                   err_msg=f)


@pytest.mark.cuda
def test_rep_chunk_on_the_card_is_bit_identical(card):
    dist, n, b, arrivals, reps, seed, kw = CASES["sampled_churn"]
    sc = pc.Scenario(dtype="float64", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = frontier_job_times_dynamic(dist, n, [1, 2, 4, 8], 200, seed=seed, scenario=sc)
        parts = frontier_job_times_dynamic(dist, n, [1, 2, 4, 8], 200, seed=seed,
                                           scenario=sc.replace(rep_chunk=4))
    np.testing.assert_array_equal(_bits(one), _bits(parts))


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["exponential", "pareto_heavy"])
def test_churned_planning_at_n100_on_the_card_equals_cpu(card, law):
    """The reference benchmark's dynamic scenario (``benchmarks/cluster_bench.py``
    ``bench_dynamic``) at N = 100, 4096 reps, float32: the frontier rows
    bitwise and the same B*."""
    dist = {"exponential": P.Exponential(1.0), "pareto_heavy": P.Pareto(1.0, 1.8)}[law]
    sc = pc.Scenario(churn=pc.ChurnProcess(fail_rate=0.02, mean_downtime=2.0),
                     speeds=_speeds(100, 0), churn_pairs_per_worker=2, jobs_per_stream=96)
    planner = P.RedundancyPlanner(100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rows = frontier_job_times_dynamic(dist, 100, planner.candidates, 4096, seed=0,
                                          scenario=sc)
        cpu = frontier_job_times_dynamic(dist, 100, planner.candidates, 4096, seed=0,
                                         scenario=sc, device="cpu")
        plan = planner.plan_cluster(dist, n_reps=4096, seed=0, scenario=sc)
        plan_cpu = planner.plan_cluster(dist, n_reps=4096, seed=0, scenario=sc, device="cpu")
    assert rows.shape == (9, 43 * 96)
    np.testing.assert_array_equal(_bits(rows), _bits(cpu))
    assert plan == plan_cpu
    assert np.isfinite(rows).mean() > 0.99
