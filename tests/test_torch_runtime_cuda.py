"""The port's live runtime with the ``torch`` payload on the card.

The runtime is host code; its one piece of device work is the worker's
``torch`` payload (a timed ``tanh(a @ a.T / 96)`` chain on a 96 x 96 float64
matrix, one synchronise a step).  These tests run thread workers on the card
and hold each live run to its engine replay exactly, as the CPU tests do.
They skip where no NVIDIA card is present, and import neither jax nor the
reference package, so they also run on a machine that has only the port:

    PYTHONPATH=src python -m pytest tests/test_torch_runtime_cuda.py -m cuda -q

The helpers here (``replay_mismatches``, ``assert_exact_twin``,
``golden_mismatches``) are shared with the CPU tests and ``chip_smoke.py``.
"""
import asyncio
import json
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster.runtime import (  # noqa: E402
    LiveJob,
    Runtime,
    replay_trace,
    trace_accounting,
)
from repro_torch.cluster.runtime.worker import run_payload  # noqa: E402
from repro_torch.cluster.scenario import Scenario  # noqa: E402

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "runtime_traces.json"


def record_tuple(rec) -> tuple:
    return (rec.job_id, rec.name, rec.arrival, rec.start, rec.finish, rec.n_batches,
            rec.replication)


def replay_mismatches(report, events=None, n_workers=None, scenario=None) -> tuple:
    """Replay a live run's trace (``report.trace`` unless ``events`` is given)
    through the port's engine; return the engine's report and a list of where
    the trace fold, the replay and the live counters or job records differ
    (empty when they agree exactly)."""
    events = report.trace if events is None else events
    acct = trace_accounting(events)
    eng = replay_trace(events, n_workers, scenario=scenario)
    bad = []
    if acct != report.accounting():
        bad.append(f"trace fold {acct} != live {report.accounting()}")
    if eng.accounting() != acct:
        bad.append(f"replay {eng.accounting()} != trace fold {acct}")
    live = [record_tuple(r) for r in sorted(report.records, key=lambda r: r.job_id)]
    twin = [record_tuple(r) for r in sorted(eng.records, key=lambda r: r.job_id)]
    if live != twin:
        bad.append(f"job records {live} != the replay's {twin}")
    return eng, bad


def assert_exact_twin(report, events=None, n_workers=None, scenario=None):
    """The trace fold, the engine replay and the live counters agree exactly,
    and so do the job records."""
    eng, bad = replay_mismatches(report, events, n_workers, scenario)
    assert bad == []
    return eng


def golden_mismatches(replay=replay_trace, path=GOLDEN) -> list:
    """Replay every trace of ``tests/golden/runtime_traces.json`` (recorded by
    the reference's live runtime) and list where the replay's accounting or
    records differ from the reference's replay; empty when all agree."""
    golden = json.loads(pathlib.Path(path).read_text())
    bad = []
    for name, case in golden["traces"].items():
        eng = replay(case["trace"])
        if eng.accounting() != case["accounting"]:
            bad.append(f"{name}: accounting {eng.accounting()} != {case['accounting']}")
        got = [list(record_tuple(r)) for r in sorted(eng.records, key=lambda r: r.job_id)]
        if got != case["records"]:
            bad.append(f"{name}: records {got} != {case['records']}")
    return bad


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the torch payload runs on the worker's card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_torch_payload_twin_exact_on_card(card):
    """B=2, r=2 with a per-worker skew, the payload on the card: the slow
    replicas are cancelled and the replay is exact."""
    sc = Scenario(n_batches=2, cancel_redundant=True)
    jobs = [
        LiveJob(job_id=0, costs=(0.1, 0.1, 0.1, 0.1), skew=0.8, payload="torch"),
        LiveJob(job_id=1, costs=(0.08,) * 4, skew=0.8, payload="torch", arrival=0.02),
    ]
    report = Runtime(4, sc, device=card).run(jobs, timeout_s=60.0)
    assert [r.job_id for r in report.records] == [0, 1]
    assert report.cancelled_seconds_saved > 0.0
    assert_exact_twin(report)


@pytest.mark.cuda
def test_torch_payload_steps_and_cancels_on_card(card):
    steps = asyncio.run(run_payload("torch", (0.05,), 1.0, card))
    assert steps > 0

    async def cancelled() -> float:
        task = asyncio.ensure_future(run_payload("torch", (30.0,), 1.0, card))
        await asyncio.sleep(0.2)
        t0 = time.monotonic()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(task, 10.0)
        return time.monotonic() - t0

    assert asyncio.run(cancelled()) < 1.0


def test_golden_reference_traces_replay_through_the_port():
    """The reference-recorded traces replay through the port's engine to the
    reference's own replay, accounting and records."""
    assert golden_mismatches() == []
