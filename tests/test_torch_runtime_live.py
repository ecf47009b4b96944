"""The port's live runtime against the reference's, across packages.

Function level: protocol frames, the trace grid, the recorder, the trace fold,
the fault injector's verdicts and the journal reader are exact in both
packages on the same inputs.  Trace level: runs recorded by the reference's
live runtime on the CPU replay through the port's engine to the
reference's own replay and live accounting, record by record, with ``==``;
and runs recorded by the port's runtime replay through the reference's
engine to the port's live accounting.

``tests/golden/runtime_traces.json`` holds the reference-recorded traces of
:data:`SCENARIOS` with the reference's replay, for the card's machine (no jax
there; ``tests/test_torch_runtime_cuda.py`` and ``chip_smoke.py`` replay
them).  Rewrite it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_runtime_live.py
"""
import asyncio
import json
import os
import signal
import struct
import subprocess
import types

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.cluster as rcl  # noqa: E402
import repro.cluster.runtime as rrt  # noqa: E402
import repro_torch.cluster as pcl  # noqa: E402
import repro_torch.cluster.runtime as prt  # noqa: E402
from repro.cluster.runtime import chaos as rchaos  # noqa: E402
from repro.cluster.runtime import protocol as rproto  # noqa: E402
from repro.cluster.runtime import trace as rtrace  # noqa: E402
from repro_torch.cluster.runtime import chaos as pchaos  # noqa: E402
from repro_torch.cluster.runtime import protocol as pproto  # noqa: E402
from repro_torch.cluster.runtime import trace as ptrace  # noqa: E402
from test_torch_runtime_cuda import GOLDEN, record_tuple  # noqa: E402

pytestmark = pytest.mark.timeout(180)

# (runtime package, cluster package, worker keywords) per package: the
# port's workers run on the CPU here
PACKAGES = {
    "repro": (rrt, rcl, {}),
    "repro_torch": (prt, pcl, {"device": "cpu"}),
}


async def join_threads(threads, timeout_s=10.0):
    loop = asyncio.get_running_loop()
    for t in threads:
        await loop.run_in_executor(None, t.join, timeout_s)


async def stop_procs(procs, timeout_s=5.0):
    loop = asyncio.get_running_loop()
    for p in procs:
        try:
            await loop.run_in_executor(None, p.wait, timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            await loop.run_in_executor(None, p.wait, timeout_s)


# --------------------------------------------------------------------------
# the recorded scenarios: the reference's passing live tests, one run each
# --------------------------------------------------------------------------


def _partition(rt, cl, kw):
    """tests/test_runtime_live.py::test_twin_exact_basic_sleep (r = 1)."""
    jobs = [
        rt.LiveJob(job_id=0, costs=(0.08, 0.05, 0.06, 0.04, 0.07, 0.05), name="a"),
        rt.LiveJob(job_id=1, costs=(0.05, 0.04, 0.06), arrival=0.05, name="b"),
    ]
    return rt.Runtime(3, cl.Scenario(n_batches=3), **kw).run(jobs, timeout_s=30.0)


def _cancel_skew(rt, cl, kw):
    """test_twin_exact_cancel_on_earliest_cover: B=2, r=2, skewed siblings."""
    sc = cl.Scenario(n_batches=2, cancel_redundant=True)
    jobs = [rt.LiveJob(job_id=0, costs=(0.10, 0.10, 0.10, 0.10), skew=0.8)]
    return rt.Runtime(4, sc, **kw).run(jobs, timeout_s=30.0)


def _job_plan(rt, cl, kw):
    """test_twin_exact_job_plan_overrides."""
    sc = cl.Scenario(n_batches=2, cancel_redundant=False)
    jobs = [
        rt.LiveJob(job_id=0, costs=(0.08, 0.06), skew=0.7,
                   plan=cl.JobPlan(n_batches=1, cancel_redundant=True)),
        rt.LiveJob(job_id=1, costs=(0.05, 0.06), arrival=0.02),
    ]
    return rt.Runtime(2, sc, **kw).run(jobs, timeout_s=30.0)


def _speculation(rt, cl, kw):
    """test_twin_exact_speculative_backup: one backup launched and winning."""
    sc = cl.Scenario(n_batches=3, cancel_redundant=True,
                     speculation=cl.Speculation(interval=0.12, theta=2.0))
    jobs = [rt.LiveJob(job_id=0, costs=(0.15, 0.15, 1.0), skew=0.8)]
    return rt.Runtime(3, sc, **kw).run(jobs, timeout_s=30.0)


def _wire_chaos(rt, cl, kw, seed=0):
    """tests/test_chaos.py::test_wire_chaos_with_supervisor_replays_exactly."""
    sc = cl.Scenario(
        n_batches=2,
        retry=cl.Retry(max_attempts=3, backoff_s=0.05, max_backoff_s=0.2),
        faults=cl.FaultPlan(seed=seed, drop_p=0.15, dup_p=0.10, delay_p=0.10, delay_s=0.02),
    )

    async def run():
        master = rt.RuntimeMaster(2, sc, heartbeat_s=0.05, heartbeat_timeout_s=1.0,
                                  lease_factor=4.0, lease_floor_s=1.0)
        port = await master.start()
        threads = [rt.spawn_worker_thread(master.host, port, **kw) for _ in range(2)]

        async def supervise():
            handled = 0
            while not master._finalized:
                await asyncio.sleep(0.05)
                fails = sum(1 for e in master.recorder.events if e["ev"] == "fail")
                while handled < fails:
                    handled += 1
                    threads.append(rt.spawn_worker_thread(master.host, port, **kw))

        sup = None
        try:
            await master.wait_for_workers(30.0)
            sup = asyncio.ensure_future(supervise())
            return await master.run(
                [rt.LiveJob(job_id=0, costs=(0.2, 0.2, 0.2, 0.2), name="wired")], timeout_s=90.0
            )
        finally:
            if sup is not None:
                sup.cancel()
            await master.close()
            await join_threads(threads, 5.0)

    return asyncio.run(run())


def _retry_exhausted(rt, cl, kw):
    """tests/test_chaos.py::test_retry_budget_exhausted_abandons_exactly."""
    sc = cl.Scenario(n_batches=1, retry=cl.Retry(max_attempts=2, backoff_s=0.05))
    jobs = [rt.LiveJob(job_id=0, costs=(0.1,), payload="raise", name="doomed")]
    return rt.Runtime(1, sc, **kw).run(jobs, timeout_s=60.0)


def _subprocess_kill(rt, cl, kw):
    """test_subprocess_kill_mid_task_rescued_exactly: SIGKILL the worker
    holding batch 2's only replica; the batch is rescued."""

    async def run():
        master = rt.RuntimeMaster(3, cl.Scenario(n_batches=3), heartbeat_s=0.05,
                                  heartbeat_timeout_s=5.0)
        port = await master.start()
        procs = [rt.spawn_worker_subprocess(master.host, port, **kw) for _ in range(3)]
        try:
            await master.wait_for_workers(60.0)
            jobs = [rt.LiveJob(job_id=0, costs=(0.3, 0.3, 1.6), name="victim-run")]
            run_task = asyncio.ensure_future(master.run(jobs, timeout_s=60.0))
            for _ in range(3000):
                victim = next((e["wid"] for e in master.recorder.events
                               if e["ev"] == "dispatch" and e["batch"] == 2), None)
                if victim is not None:
                    break
                await asyncio.sleep(0.01)
            else:
                raise TimeoutError("batch 2 was never dispatched")
            await asyncio.sleep(0.3)  # let the batch be genuinely mid-task
            os.kill(master.workers[victim].pid, signal.SIGKILL)
            return await run_task
        finally:
            await master.close()
            await stop_procs(procs)

    return asyncio.run(run())


SCENARIOS = {
    "partition": _partition,
    "cancel_skew": _cancel_skew,
    "job_plan": _job_plan,
    "speculation": _speculation,
    "wire_chaos": _wire_chaos,
    "retry_exhausted": _retry_exhausted,
    "subprocess_kill": _subprocess_kill,
}


def check_scenario(name, report):
    """What each scenario must show, whichever package ran it."""
    if name == "cancel_skew":
        assert report.cancelled_seconds_saved > 0.05
    elif name == "speculation":
        assert report.n_speculative == 1
    elif name == "wire_chaos":
        assert any(e["ev"] == "chaos" for e in report.trace)
        assert report.records[0].finish < float("inf")
    elif name == "retry_exhausted":
        assert (report.n_task_failures, report.n_retries) == (3, 2)
        assert report.records[0].finish == float("inf")
    elif name == "subprocess_kill":
        assert (report.n_worker_failures, report.n_replicas_rescued) == (1, 1)


def replays_agree(trace, live, *replays):
    """Every replay of ``trace`` equals the live accounting and records."""
    want_records = [record_tuple(r) for r in sorted(live.records, key=lambda r: r.job_id)]
    for replay in replays:
        eng = replay(trace)
        assert eng.accounting() == live.accounting()
        got = [record_tuple(r) for r in sorted(eng.records, key=lambda r: r.job_id)]
        assert got == want_records


# --------------------------------------------------------------------------
# trace parity across packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_trace_replays_exactly_through_the_port(name):
    report = SCENARIOS[name](*PACKAGES["repro"])
    check_scenario(name, report)
    trace = json.loads(json.dumps(list(report.trace)))  # what a journal file holds
    replays_agree(trace, report, rrt.replay_trace, prt.replay_trace)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_trace_replays_exactly_through_the_reference(name):
    report = SCENARIOS[name](*PACKAGES["repro_torch"])
    check_scenario(name, report)
    trace = json.loads(json.dumps(list(report.trace)))
    replays_agree(trace, report, prt.replay_trace, rrt.replay_trace)


def test_golden_covers_every_scenario():
    golden = json.loads(GOLDEN.read_text())
    assert sorted(golden["traces"]) == sorted(SCENARIOS)
    for case in golden["traces"].values():
        eng = rrt.replay_trace(case["trace"])
        assert eng.accounting() == case["accounting"]


# --------------------------------------------------------------------------
# function-level parity
# --------------------------------------------------------------------------

FRAMES = [
    {"type": "hb", "wid": 3},
    {"type": "hb", "wid": 1, "job": 2, "batch": 0, "epoch": 4, "frac": 0.3183098861837907},
    {"type": "task", "job": 0, "batch": 1, "epoch": 0, "payload": "torch",
     "costs": [0.25, 0.5, 1e-9], "skew": 0.5, "lease_s": 2.0, "chaos_factor": 2.0,
     "chaos_raise": True},
    {"type": "fail", "wid": 0, "job": 0, "batch": 0, "epoch": 1,
     "error": "Traceback: ünïcödé → boom\n"},
    {"type": "welcome", "wid": 7, "heartbeat_s": 0.05, "hb_seed": 3},
    {"type": "shutdown"},
]


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f["type"])
def test_frames_are_byte_identical(frame):
    assert pproto._encode(frame) == rproto._encode(frame)
    assert pproto.MAX_FRAME == rproto.MAX_FRAME
    sink = types.SimpleNamespace(write=lambda b: pytest.fail("oversized frame was sent"))
    big = {"type": "x", "blob": "a" * (pproto.MAX_FRAME + 1)}
    for proto in (pproto, rproto):
        with pytest.raises(proto.ProtocolError, match="MAX_FRAME"):
            proto.send_nowait(sink, big)


def test_frames_read_back_identically():
    async def read_all(proto, data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        while (m := await proto.read_msg(reader)) is not None:
            out.append(m)
        return out

    data = b"".join(rproto._encode(f) for f in FRAMES)
    assert asyncio.run(read_all(pproto, data)) == asyncio.run(read_all(rproto, data)) == FRAMES
    bad = json.dumps([1, 2, 3]).encode()
    for proto in (pproto, rproto):
        with pytest.raises(proto.ProtocolError, match="typed message"):
            asyncio.run(read_all(proto, struct.pack(">I", len(bad)) + bad))


def test_quantize_equal_on_a_grid():
    rng = np.random.default_rng(0)
    xs = [0.0, 1e-12, ptrace.TICK / 2, ptrace.TICK, 3 * ptrace.TICK, 0.123456, 1.0, 2.5e4]
    xs += [float(x) for x in rng.uniform(0.0, 10.0, 2000)]
    xs += [float(x) for x in rng.exponential(1e-5, 500)]
    assert ptrace.TICK == rtrace.TICK
    assert [ptrace.quantize(x) for x in xs] == [rtrace.quantize(x) for x in xs]


def test_recorders_stamp_the_same_grid_and_freeze(tmp_path):
    events = [
        {"ev": "scenario", "t": ptrace.TICK, "n_workers": 2, "scenario": {}},
        {"ev": "join", "t": 2 * ptrace.TICK, "wid": 0, "pid": 1},
        {"ev": "join", "t": 0.5, "wid": 1, "pid": 2},
    ]
    for i, mod in enumerate((ptrace, rtrace)):
        rec = mod.TraceRecorder(journal=str(tmp_path / f"j{i}.jsonl"))
        stamps = [rec.stamp() for _ in range(50)]
        assert all(b - a >= mod.TICK * 0.999 for a, b in zip(stamps, stamps[1:]))
        assert all(s * (1 << 20) == int(s * (1 << 20)) for s in stamps)
        for e in events:
            rec.record(e["ev"], e["t"], **{k: v for k, v in e.items() if k not in ("ev", "t")})
        rec.frozen = True
        with pytest.raises(RuntimeError, match="frozen"):
            rec.record("join", 1.0, wid=2)
        rec.close_journal()
        # resuming continues strictly after the last journaled stamp
        resumed = mod.TraceRecorder(resume_events=events)
        assert resumed.stamp() > 0.5 and resumed.events == tuple(events)
    assert (tmp_path / "j0.jsonl").read_bytes() == (tmp_path / "j1.jsonl").read_bytes()


def _hand_built(tick):
    def ev(kind, t, **fields):
        return {"ev": kind, "t": t, **fields}

    t = [i * tick for i in range(1, 12)]
    return [
        ev("dispatch", t[0], wid=0, job=0, batch=0, planned=5 * tick, rescue=False),
        ev("dispatch", t[1], wid=1, job=0, batch=0, planned=5 * tick, rescue=False),
        ev("finish", t[2], wid=0, job=0, batch=0),
        ev("cancel", t[3], wid=1, job=0, batch=0, sched_end=t[1] + 5 * tick),
        ev("dispatch", t[4], wid=2, job=1, batch=0, planned=5 * tick, rescue=True),
        ev("fail", t[5], wid=2, cause="heartbeat"),
        ev("dispatch", t[6], wid=0, job=1, batch=0, planned=5 * tick, rescue=True),
        ev("flush", t[7], wid=0, job=1, batch=0, sched_end=t[6] + 5 * tick),
        ev("dispatch", t[8], wid=1, job=2, batch=0, planned=5 * tick, rescue=False, spec=True),
        ev("task_fail", t[9], wid=1, job=2, batch=0, attempt=1, error="boom"),
        ev("retry", t[9] + tick / 2, job=2, batch=0, attempt=1),
        ev("dispatch", t[10], wid=1, job=2, batch=0, planned=5 * tick, rescue=True, retry=True),
        ev("finish", t[10] + 4 * tick, wid=1, job=2, batch=0),
        ev("fail", t[10] + 5 * tick, wid=0, cause="eof"),
    ]


def test_trace_accounting_and_scripted_durations_equal():
    events = _hand_built(ptrace.TICK)
    acct = ptrace.trace_accounting(events)
    assert acct == rtrace.trace_accounting(events)
    assert acct["n_speculative"] == 1 and acct["n_retries"] == 1
    assert ptrace._scripted_durations(events) == rtrace._scripted_durations(events)


FAULT_PLANS = [
    dict(seed=0, drop_p=0.15, dup_p=0.10, delay_p=0.10, delay_s=0.02),
    dict(seed=1, drop_p=0.3, dup_p=0.0, delay_p=0.2, delay_s=0.01),
    dict(seed=7, kills=((1, 0.2), (0, 0.5)), slowdowns=((0, 0.0, 3.0), (0, 0.4, 2.0)),
         hb_stalls=((1, 0.1, 0.4),), payload_errors=((0, 0, 2), (1, 2, 1)),
         drop_p=0.05, dup_p=0.05, delay_p=0.05),
    dict(seed=12345),
]


@pytest.mark.parametrize("plan", FAULT_PLANS, ids=lambda p: f"seed{p['seed']}")
def test_fault_injector_verdicts_equal(plan):
    inj = {
        "p": pchaos.FaultInjector(pcl.FaultPlan(**plan)),
        "r": rchaos.FaultInjector(rcl.FaultPlan(**plan)),
    }

    def trace(i):
        out = []
        for k in range(600):
            out.append(i.wire("in" if k % 3 else "out"))
        for t in (0.0, 0.15, 0.3, 0.6):
            out.append((i.due_kills(t), [i.slow_factor(w, t) for w in (0, 1, 2)],
                        [i.stalled_window(w, t) for w in (0, 1)]))
        for job, batch in [(0, 0), (0, 0), (0, 0), (1, 2), (1, 2), (0, 1)]:
            out.append(i.payload_raise(job, batch))
        i.restore([{"kind": "kill", "wid": 1}, {"kind": "raise", "job": 1, "batch": 2},
                   {"kind": "hb_stall", "window": 0}])
        out.append((i.due_kills(1.0), i.payload_raise(1, 2), i.stall_needs_stamp(0),
                    i.stall_needs_stamp(3)))
        return out

    assert trace(inj["p"]) == trace(inj["r"])
    assert [pchaos._uniform(plan["seed"], d, k) for d in ("in", "out") for k in range(64)] == [
        rchaos._uniform(plan["seed"], d, k) for d in ("in", "out") for k in range(64)]


def test_read_journal_torn_tail_equal(tmp_path):
    path = tmp_path / "run.jsonl"
    events = _hand_built(ptrace.TICK)
    path.write_bytes(b"".join(json.dumps(e).encode() + b"\n" for e in events)
                     + b'{"ev": "disp')
    assert ptrace.read_journal(str(path)) == rtrace.read_journal(str(path)) == events
    path.write_bytes(b'{"ev": "join", "t": 1.0}\n???garbage???\n{"ev": "flush", "t": 2.0}\n')
    for mod in (ptrace, rtrace):
        with pytest.raises(json.JSONDecodeError):
            mod.read_journal(str(path))


# --------------------------------------------------------------------------
# the golden writer
# --------------------------------------------------------------------------


def write_golden() -> None:
    """Record each scenario with the reference's runtime and store its trace
    beside the reference's replay of it."""
    traces = {}
    for name in sorted(SCENARIOS):
        report = SCENARIOS[name](*PACKAGES["repro"])
        check_scenario(name, report)
        trace = json.loads(json.dumps(list(report.trace)))
        eng = rrt.replay_trace(trace)
        assert eng.accounting() == report.accounting(), name
        for e in trace:  # tracebacks name files relative to the checkout
            if "error" in e:
                e["error"] = e["error"].replace(str(GOLDEN.parents[2]) + os.sep, "")
        traces[name] = {
            "accounting": eng.accounting(),
            "records": [list(record_tuple(r))
                        for r in sorted(eng.records, key=lambda r: r.job_id)],
            "trace": trace,
        }
    GOLDEN.write_text(json.dumps({
        "about": "traces recorded by repro.cluster.runtime on the CPU, with repro's "
                 "replay_trace accounting and job records; written by "
                 "tests/test_torch_runtime_live.py",
        "traces": traces,
    }, indent=1) + "\n")
    print(f"wrote {GOLDEN} ({len(traces)} traces)")


if __name__ == "__main__":
    write_golden()
