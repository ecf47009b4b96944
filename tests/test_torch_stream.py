"""The port's trace-scale stream against the reference, on the CPU.

Both packages draw a stream's service times on the host with numpy
(``TraceStream.sample_slab``), so the port is held to the reference exactly,
not in law.  In float64 every accumulator of ``simulate_stream`` and every
per-job array of ``outputs="full"`` is bitwise the reference's, except the
per-job slot sums (``busy_sum`` / ``saved_sum``, ``busy_j`` / ``planned_j`` /
``saved_j``): the port adds a job's replica times left to right in slot order,
on the CPU and the card alike, where the reference's ``jnp.sum`` takes XLA's
order, so those agree within rtol 1e-12.  The port's own streaming
accumulators equal its host fold of its full outputs bit for bit, under any
slab partition, and the golden 10k-job cluster-day reproduces in float32.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster as rc  # noqa: E402
import repro.core.traces as rt  # noqa: E402
import repro_torch.cluster as pc  # noqa: E402
import repro_torch.core.traces as pt  # noqa: E402
from repro_torch.cluster.stream import _ACC_FIELDS, _CLASS_FIELDS  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "trace_day_summary.json"
SLOT_SUMS = ("busy_sum", "saved_sum")
CASES = [
    ("fifo_gang", None, True),
    ("fifo_gang", None, False),
    ("packed", 6, True),
    ("balanced", 6, False),
]


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _small_stream(traces, n_jobs=96, seed=11):
    jobs = tuple(traces.synthetic_google_jobs(2020)[:4])
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0.0, 40.0 * n_jobs, size=n_jobs))
    job_ids = rng.integers(0, len(jobs), size=n_jobs)
    return traces.TraceStream(arrivals=arrivals, job_ids=job_ids, sources=jobs, seed=seed)


def _both(n_jobs=96, seed=11):
    return _small_stream(rt, n_jobs, seed), _small_stream(pt, n_jobs, seed)


def _assert_stats_equal(a, b, ctx="", fields=_ACC_FIELDS + _CLASS_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype, ctx)
        np.testing.assert_array_equal(x, y, err_msg=f"{f} {ctx}")


def _assert_stats_match_reference(got, want, ctx=""):
    """Bitwise, except the slot sums within rtol 1e-12."""
    exact = tuple(f for f in _ACC_FIELDS + _CLASS_FIELDS if f not in SLOT_SUMS)
    _assert_stats_equal(got, want, ctx, exact)
    for f in SLOT_SUMS:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, (f, ctx)
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=0, err_msg=f"{f} {ctx}")
    assert got.classes == want.classes


# --------------------------------------------------------------------------
# the port against the reference (float64, same TraceStream)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler,wpj,cancel", CASES)
def test_stream_matches_reference_f64(x64, scheduler, wpj, cancel):
    ref_st, st = _both()
    kw = dict(scheduler=scheduler, workers_per_job=wpj, cancel_redundant=cancel,
              dtype="float64")
    want = rc.simulate_stream(ref_st, 12, 6, 3, scenario=rc.Scenario(outputs="full", **kw),
                              slab=37)
    got = pc.simulate_stream(st, 12, 6, 3, scenario=pc.Scenario(outputs="full", **kw),
                             slab=37, device="cpu")
    assert isinstance(got, pc.StreamFullReport)
    _assert_stats_match_reference(got.stats, want.stats, scheduler)
    for f in ("waits", "t_job"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("busy_j", "planned_j", "saved_j"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(got.response_times, want.response_times)
    lean = pc.simulate_stream(st, 12, 6, 3, scenario=pc.Scenario(outputs="stream", **kw),
                              slab=37, device="cpu")
    assert isinstance(lean, pc.StreamStats)
    _assert_stats_equal(lean, got.stats, f"stream vs full {scheduler}")


@pytest.mark.parametrize("scheduler,wpj,cancel", CASES)
def test_fold_of_full_outputs_equals_carried_accumulators(x64, scheduler, wpj, cancel):
    _, st = _both()
    kw = dict(scheduler=scheduler, workers_per_job=wpj, cancel_redundant=cancel,
              dtype="float64")
    full = pc.simulate_stream(st, 12, 6, 3, scenario=pc.Scenario(outputs="full", **kw),
                              slab=37, device="cpu")
    folded = pc.fold_stream_stats(full.waits, full.t_job, full.busy_j, full.planned_j,
                                  full.saved_j, class_ids=st.job_ids, classes=full.stats.classes)
    _assert_stats_equal(folded, full.stats, f"fold vs full {scheduler}")
    assert np.all(full.waits >= 0.0) and int(full.stats.count.sum()) == 3 * 96
    np.testing.assert_array_equal(full.stats.class_count.sum(axis=1), full.stats.count)
    np.testing.assert_array_equal(full.stats.class_hist.sum(axis=1), full.stats.hist)


def test_stream_slab_partition_bitwise_f64():
    _, st = _both(60, seed=5)
    sc = pc.Scenario(outputs="stream", dtype="float64", scheduler="balanced",
                     workers_per_job=5, cancel_redundant=True)
    ref = pc.simulate_stream(st, 10, 5, 2, scenario=sc, slab=None, device="cpu")
    for slab in (1, 7, 60):
        got = pc.simulate_stream(st, 10, 5, 2, scenario=sc, slab=slab, device="cpu")
        _assert_stats_equal(got, ref, f"slab={slab}")


def test_stream_f32_slab_invariant_and_tracks_reference():
    ref_st, st = _both(50, seed=8)
    kw = dict(outputs="stream", scheduler="packed", workers_per_job=5)
    got = pc.simulate_stream(st, 10, 5, 2, scenario=pc.Scenario(**kw), slab=None, device="cpu")
    again = pc.simulate_stream(st, 10, 5, 2, scenario=pc.Scenario(**kw), slab=13, device="cpu")
    _assert_stats_equal(again, got, "f32 slab")
    want = rc.simulate_stream(ref_st, 10, 5, 2, scenario=rc.Scenario(**kw), slab=13)
    s, w = got.summary(), want.summary()
    assert s["n_jobs_done"] == w["n_jobs_done"] == 2 * 50
    for k in w:
        np.testing.assert_allclose(s[k], w[k], rtol=1e-5, err_msg=k)
    assert s["p50_response"] <= s["p95_response"] <= s["p99_response"]


def test_cluster_day_summary_matches_golden():
    """The reference's §VII fixture (tests/test_stream.py DAY_CFG / DAY_RUN):
    13824 workers in 2304 packed pools of 6, B = 3, 2 reps, slab 1024, f32."""
    golden = json.loads(GOLDEN.read_text())
    day = pt.synthetic_cluster_day(n_jobs=10_000, duration=86_400.0, seed=7)
    sc = pc.Scenario(outputs="stream", scheduler="packed", workers_per_job=6,
                     cancel_redundant=True)
    current = pc.simulate_stream(day, 13_824, 3, 2, scenario=sc, slab=1024,
                                 device="cpu").summary()
    assert set(current) == set(golden)
    assert current["n_jobs_done"] == golden["n_jobs_done"] == 20_000
    for k in golden:
        np.testing.assert_allclose(current[k], golden[k], rtol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# StreamStats: the reference's estimators on the same accumulators
# --------------------------------------------------------------------------


def test_quantile_summary_class_summary_equal_reference(x64):
    _, st = _both(80, seed=3)
    got = pc.simulate_stream(st, 12, 4, 3, scenario=pc.Scenario(outputs="stream",
                             dtype="float64"), slab=29, device="cpu")
    want = rc.StreamStats(**{f: getattr(got, f) for f in _ACC_FIELDS + _CLASS_FIELDS},
                          classes=got.classes)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert got.quantile(q) == want.quantile(q)
        for c in got.classes:
            assert got.quantile(q, job_class=c) == want.quantile(q, job_class=c)
    assert got.summary() == want.summary()
    assert got.class_summary() == want.class_summary()
    np.testing.assert_array_equal(got.mean_response, want.mean_response)
    np.testing.assert_array_equal(got.std_response, want.std_response)
    with pytest.raises(KeyError):
        got.quantile(0.5, job_class="nope")
    bare = pc.StreamStats(**{f: getattr(got, f) for f in _ACC_FIELDS})
    with pytest.raises(ValueError, match="per-class"):
        bare.class_summary()
    with pytest.raises(ValueError, match="per-class"):
        bare.quantile(0.9, job_class=0)


def test_stream_rejects_dynamic_knobs_and_bad_pools():
    ref_st, st = _both(10)
    cases = [
        (ValueError, "churn", dict(churn=("ChurnProcess", (0.1, 1.0))), 4),
        (ValueError, "speeds", dict(speeds=(1.0,) * 8), 4),
        (ValueError, "workers_per_job", dict(scheduler="packed"), 4),
        (ValueError, r"workers_per_job.*\[1, 8\]", dict(scheduler="packed", workers_per_job=16), 4),
        (ValueError, r"\[1, 8\]", {}, 9),
        (ValueError, "fifo_gang uses the whole cluster", dict(workers_per_job=4), 4),
    ]
    for exc, match, fields, b in cases:
        for mod, stream in ((rc, ref_st), (pc, st)):
            kw = dict(fields)
            if "churn" in kw:
                kw["churn"] = mod.ChurnProcess(*kw["churn"][1])
            with pytest.raises(exc, match=match):
                mod.simulate_stream(stream, 8, b, 1, scenario=mod.Scenario(outputs="stream", **kw),
                                    **({"device": "cpu"} if mod is pc else {}))
    for call in (lambda: rc.simulate_stream(np.zeros(3), 8, 4, 1),
                 lambda: pc.simulate_stream(np.zeros(3), 8, 4, 1, device="cpu")):
        with pytest.raises(TypeError, match="TraceStream"):
            call()
    pc.Scenario(outputs="stream").validate(8, backend="torch")
    with pytest.raises(ValueError, match="Python engine"):
        pc.Scenario(outputs="stream").validate(8, backend="python")


def test_stream_needs_a_device_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, st = _both(10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pc.simulate_stream(st, 8, 4, 1)


# --------------------------------------------------------------------------
# traces: the numpy copies
# --------------------------------------------------------------------------


def test_cluster_day_and_trace_helpers_equal_reference(tmp_path):
    for kw in ({}, dict(n_jobs=500, duration=3600.0, seed=9, families=("heavy",))):
        want, got = rt.synthetic_cluster_day(**kw), pt.synthetic_cluster_day(**kw)
        np.testing.assert_array_equal(got.arrivals, want.arrivals)
        np.testing.assert_array_equal(got.job_ids, want.job_ids)
        assert [s.name for s in got.sources] == [s.name for s in want.sources]
        assert got.seed == want.seed
    with pytest.raises(ValueError, match="families"):
        pt.synthetic_cluster_day(families=("none",))
    jobs = pt.synthetic_google_jobs(2020)
    for j in jobs:
        assert pt.tail_family(j.task_times) == rt.tail_family(j.task_times)
    assert pt.tail_family(np.arange(1.0, 6.0)) == rt.tail_family(np.arange(1.0, 6.0))
    pt.save_jobs(jobs[:3], tmp_path / "jobs")
    for loaded in (pt.load_jobs(tmp_path / "jobs"), rt.load_jobs(tmp_path / "jobs")):
        assert [(j.name, j.family) for j in loaded] == [(j.name, j.family) for j in jobs[:3]]
        for a, b in zip(loaded, jobs[:3]):
            np.testing.assert_array_equal(a.task_times, b.task_times)
