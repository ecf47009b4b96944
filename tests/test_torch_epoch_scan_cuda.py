"""The epoch scan's gang lane on the card, against the port's CPU run.

Every operation of a step is exact IEEE arithmetic (elementwise, gathers,
segment min and max), so the card's run equals the CPU's bit for bit in
float64 and float32, except the two worker-second sums over replica slots,
whose order the card's reduction picks (rtol 1e-12 in float64).  The same
holds with speculative backups and through the streaming fold.  The
replanner's refit uses the card's own log and lgamma, so it is held to the
CPU's decisions, and its times bitwise given those.  The goldens
(``tests/golden/epoch_scan_*.json``) are the JAX package's float64 output.
These tests skip where no NVIDIA card is present and import neither jax nor
the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_epoch_scan_cuda.py -m cuda -q
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
from repro_torch.cluster.stream import _ACC_FIELDS, epoch_stream_stats  # noqa: E402

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


# --------------------------------------------------------------------------
# the adaptive policies and the streaming fold on the card
# --------------------------------------------------------------------------

GOLDEN = pathlib.Path(__file__).parent / "golden"
DECISIONS = ("n_replans", "n_batches_used", "replication_used")
REPLAN = pc.ReplanConfig(window=64, refit_every=16, min_observations=16)
POLICY_CASES = {
    "replan_cancel_speeds": (P.Pareto(1.0, 1.8), 8, 8, np.zeros(40), 6, 2,
                             dict(replan=REPLAN, cancel_redundant=True, speeds=_speeds(8, 1))),
    "replan_blend_churn": (P.ShiftedExponential(1.0, 0.5), 12, None, np.arange(30) * 0.5, 6, 7,
                           dict(replan=pc.ReplanConfig(window=96, refit_every=24,
                                                       min_observations=24, objective="blend"),
                                cancel_redundant=True, churn=pc.ChurnProcess(0.05, 1.0),
                                churn_pairs_per_worker=4, speeds=_speeds(12, 2))),
    "speculation_cancel": (P.Pareto(1.0, 1.5), 10, None, np.zeros(20), 8, 3,
                           dict(speculation=pc.Speculation(0.4, 2.0, 3), cancel_redundant=True)),
    "speculation_churn_nocancel": (P.Pareto(1.0, 1.8), 8, 4, np.zeros(12), 8, 4,
                                   dict(speculation=pc.Speculation(0.3, 1.5, 2),
                                        churn=pc.ChurnProcess(0.05, 2.0),
                                        churn_pairs_per_worker=4, speeds=_speeds(8, 3))),
}


def _run(case, dtype, device=None, **extra):
    dist, n, b, arrivals, reps, seed, kw = POLICY_CASES[case]
    sc = pc.Scenario(dtype=dtype, **kw, **extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return simulate_epochs(dist, n, b, arrivals, reps, seed=seed, scenario=sc, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_adaptive_policies_on_the_card_equal_cpu(card, case, dtype):
    """Speculation: bitwise but the two sums.  The replanner: the same
    decisions (its refit's log and lgamma are the card's own, so a flip at a
    tie is possible in principle; none occurs on these fixtures), then
    bitwise times."""
    got, want = _run(case, dtype), _run(case, dtype, "cpu")
    for f in DECISIONS + ("n_speculative",):
        if getattr(want, f) is not None:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in EXACT:
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(want, f)),
                                      err_msg=f)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    for f in SUMS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol, atol=0,
                                   err_msg=f)
    counter = got.n_replans if "replan" in case else got.n_speculative
    assert counter.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["speculation_churn_nocancel", "replan_blend_churn"])
def test_streaming_fold_on_the_card_is_bitwise(card, case):
    """float64: the card's streamed stats equal the host fold of the card's
    full report bit for bit, and the CPU's streamed stats bit for bit but
    ``busy_sum`` / ``saved_sum``, the lane's worker-second sums, whose order
    the card's reduction picks (rtol 1e-12)."""
    full = _run(case, "float64")
    got = _run(case, "float64", outputs="stream")
    cpu = _run(case, "float64", "cpu", outputs="stream")
    want = epoch_stream_stats(full)
    for f in _ACC_FIELDS:
        a, b, c = getattr(got.stats, f), getattr(want, f), getattr(cpu.stats, f)
        assert a.dtype == b.dtype == c.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        if f in ("busy_sum", "saved_sum"):
            np.testing.assert_allclose(a, c, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, c, err_msg=f)
    np.testing.assert_array_equal(got.n_unfinished, cpu.n_unfinished)


@pytest.mark.cuda
def test_dynamic_plan_slo_on_the_card_equals_cpu(card):
    sc = pc.Scenario(churn=pc.ChurnProcess(0.02, 2.0), speeds=_speeds(12, 0),
                     size_dependent=False, dtype="float64")
    kw = dict(n_jobs=60, n_reps=3, seed=5, schedulers=("fifo_gang",), scenario=sc)
    slo = pc.SLO(quantile=0.99, target_s=16.0, arrival_rate=0.02)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = P.RedundancyPlanner(12).plan_slo(P.Pareto(1.0, 1.8), slo, **kw)
        want = P.RedundancyPlanner(12).plan_slo(P.Pareto(1.0, 1.8), slo, device="cpu", **kw)
    assert got.source == want.source == "epoch_scan"
    assert got.feasible == want.feasible and got.best == want.best
    for g, w in zip(got.candidates, want.candidates):
        assert (g.n_batches, g.feasible, g.achieved, g.mean_response) == (
            w.n_batches, w.feasible, w.achieved, w.mean_response)
        np.testing.assert_allclose(g.cost_worker_seconds, w.cost_worker_seconds, rtol=1e-12)


def golden_run(name, device=None):
    """Run a golden's scenario (the JAX package's float64 output, written by
    ``tests/test_torch_replan.py`` / ``tests/test_torch_speculation.py``)."""
    golden = json.loads((GOLDEN / name).read_text())
    kw = dict(golden["scenario"], speeds=tuple(golden["speeds"]))
    if "replan" in golden:
        kw["replan"] = pc.ReplanConfig(**golden["replan"])
    if "speculation" in golden:
        kw["speculation"] = pc.Speculation(**golden["speculation"])
    if "churn" in golden:
        kw["churn"] = pc.ChurnProcess(**golden["churn"])
    dist = getattr(P, golden["dist"]["kind"])(**golden["dist"]["fields"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = simulate_epochs(dist, golden["n_workers"], golden["n_batches"],
                              np.asarray(golden["arrivals"]), golden["n_reps"],
                              seed=golden["seed"], scenario=pc.Scenario(**kw), device=device)
    return golden, rep


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["epoch_scan_replan.json", "epoch_scan_speculation.json"])
def test_goldens_on_the_card(card, name):
    """The card's run equals the JAX package's: decisions and counters
    exactly, times bitwise, the two worker-second sums within rtol 1e-12."""
    golden, rep = golden_run(name)
    for f, want in golden.items():
        if not hasattr(rep, f) or f in ("arrivals", "n_workers", "n_batches", "n_reps"):
            continue
        got = np.asarray(getattr(rep, f))
        want = np.asarray(want, dtype=got.dtype)
        if f in SUMS:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f)
