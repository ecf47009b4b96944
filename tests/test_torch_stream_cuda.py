"""The trace-scale stream and the membership cover on the card, against the port's CPU run.

Every operation of the stream slab is exact IEEE arithmetic in a fixed order
(the slot sums too, left to right), and the cover kernel is bitwise equal to
its plain version, so the card's run equals the CPU's bit for bit in float64
and float32.  These tests skip where no NVIDIA card is present and import
neither jax nor the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_stream_cuda.py -m cuda -q
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.cluster as pc  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.cluster.stream import _ACC_FIELDS, _CLASS_FIELDS  # noqa: E402
from repro_torch.core import batching, simulator, traces  # noqa: E402
from repro_torch.kernels import cover  # noqa: E402

CASES = [
    ("fifo_gang", None, True),
    ("fifo_gang", None, False),
    ("packed", 6, True),
    ("balanced", 6, False),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA cover kernel has no CPU mode")
    return torch.device("cuda")


def _stream(n_jobs=150, seed=11):
    jobs = tuple(traces.synthetic_google_jobs(2020)[:4])
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0.0, 40.0 * n_jobs, size=n_jobs))
    job_ids = rng.integers(0, len(jobs), size=n_jobs)
    return traces.TraceStream(arrivals=arrivals, job_ids=job_ids, sources=jobs, seed=seed)


def _assert_bitwise(a: np.ndarray, b: np.ndarray, what: str):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        bits = np.uint32 if a.dtype == np.float32 else np.uint64
        np.testing.assert_array_equal(a.view(bits), b.view(bits), err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scheduler,wpj,cancel", CASES)
def test_stream_on_the_card_equals_cpu_bitwise(card, dtype, scheduler, wpj, cancel):
    st = _stream()
    sc = pc.Scenario(outputs="full", scheduler=scheduler, workers_per_job=wpj,
                     cancel_redundant=cancel, dtype=dtype)
    want = pc.simulate_stream(st, 12, 6, 3, scenario=sc, slab=37, device="cpu")
    got = pc.simulate_stream(st, 12, 6, 3, scenario=sc, slab=37, device=card)
    for f in _ACC_FIELDS + _CLASS_FIELDS:
        _assert_bitwise(getattr(got.stats, f), getattr(want.stats, f), f)
    for f in ("waits", "t_job", "busy_j", "planned_j", "saved_j"):
        _assert_bitwise(getattr(got, f), getattr(want, f), f)


@pytest.mark.cuda
def test_stream_launches_kernel_a_once_per_slab(card):
    st = _stream(100)
    sc = pc.Scenario(outputs="stream", scheduler="packed", workers_per_job=6)
    before = (cover.draws_launches, cover.philox_launches)
    pc.simulate_stream(st, 12, 3, 2, scenario=sc, slab=32, device=card)
    torch.cuda.synchronize()
    assert (cover.draws_launches, cover.philox_launches) == (before[0] + 4, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scheme", ["cyclic", "hybrid", "non_overlapping", "uncovered"])
def test_membership_cover_on_the_card_equals_cpu_bitwise(card, dtype, scheme):
    if scheme == "uncovered":
        m = batching.non_overlapping(24, 6)
        m[:, 20:] = False
    else:
        m = getattr(batching, scheme)(24, 6)
    times = torch.as_tensor(np.random.default_rng(4).exponential(size=(3001, 24)), dtype=dtype)
    times[5] = 1.0  # every worker ties
    want = simulator.membership_cover_times(times, m)
    before = cover.draws_launches
    got = simulator.membership_cover_times(times.to(card), m)
    torch.cuda.synchronize()
    assert cover.draws_launches == before + 1
    _assert_bitwise(got.cpu().numpy(), want.numpy(), scheme)
    assert bool(torch.isinf(want).all()) == (scheme == "uncovered")


@pytest.mark.cuda
def test_simulate_membership_on_the_card(card, monkeypatch):
    m = batching.cyclic(12, 4)
    gen = torch.Generator(device=card).manual_seed(3)
    monkeypatch.setattr(simulator, "_MEMBERSHIP_CHUNK_ELEMENTS", 12 * 3 * 1000)
    before = cover.draws_launches
    t = simulator.simulate_membership(gen, P.Exponential(1.0), m, 4500, device=card)
    assert cover.draws_launches == before + 5  # 1000 samples a chunk
    assert t.shape == (4500,) and np.isfinite(t).all() and (t > 0).all()


@pytest.mark.cuda
def test_plan_slo_on_the_card_equals_cpu(card):
    kw = dict(n_jobs=300, n_reps=4, seed=2, schedulers=("fifo_gang", "packed", "balanced"),
              pool_widths=(2, 4))
    slo = pc.SLO(quantile=0.95, target_s=30.0, arrival_rate=0.05)
    sc = pc.Scenario(size_dependent=False, dtype="float64")
    want = P.RedundancyPlanner(8).plan_slo(P.Pareto(2.0, 1.5), slo, scenario=sc, device="cpu",
                                           **kw)
    got = P.RedundancyPlanner(8).plan_slo(P.Pareto(2.0, 1.5), slo, scenario=sc, device=card,
                                          **kw)
    assert got == want
