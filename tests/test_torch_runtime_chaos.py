"""The chaos harness on the port's runtime: FaultPlan-injected faults,
payload-failure retries, a master crash with durable-journal recovery -- and
after all of it, the one journal still replays through the port's engine bit
for bit (the reference's ``tests/test_chaos.py`` on the port, workers on the
CPU).

The port carries one repair over the reference: a crashed master records
nothing more.  Since Python 3.12.1 ``Server.wait_closed()`` waits for the
open connections, so the reference's ``crash()`` journals a ``fail ...
cause="eof"`` for every connected worker before the journal closes, and its
recovered master never stamps the ``crash`` seam -- the five seeds of
``test_chaos_kill_retry_crash_recover_exact_twin`` fail on the reference and
pass here.  ``test_crash_records_nothing_and_recover_stamps_the_seam`` pins
the repair; the recovery tests below rebuild the same state in both packages
from one journal, the reference's included.
"""
import asyncio
import json
import os
import shutil
import types

import pytest

pytest.importorskip("torch")

import repro.cluster as rrt_cl  # noqa: E402
import repro.cluster.runtime as rrt  # noqa: E402
import repro_torch.cluster as prt_cl  # noqa: E402
import repro_torch.cluster.runtime as prt  # noqa: E402
from repro.cluster.runtime import trace as rtrace  # noqa: E402
from repro_torch.cluster import FaultPlan, Retry, Scenario  # noqa: E402
from repro_torch.cluster.runtime import (  # noqa: E402
    LiveJob,
    Runtime,
    RuntimeMaster,
    read_journal,
    spawn_worker_thread,
)
from repro_torch.cluster.runtime import trace as ptrace  # noqa: E402
from test_torch_runtime_cuda import assert_exact_twin, record_tuple  # noqa: E402

pytestmark = pytest.mark.timeout(180)

SEEDS = list(range(max(5, int(os.environ.get("CHAOS_SEEDS", "5")))))
CPU = {"device": "cpu"}
# a heartbeat gap of 10 s, not 2, fails a worker: on a loaded host a live
# worker's heartbeats can stall for seconds, and a worker failed for
# "heartbeat" first swallows the scheduled kill the assertions need
KW = dict(heartbeat_s=0.05, heartbeat_timeout_s=10.0, lease_floor_s=30.0)


async def join_threads(threads, timeout_s=10.0):
    """Join worker threads off the event loop (a blocking join on the loop
    thread would stall the callbacks that flush the master's socket closes)."""
    loop = asyncio.get_running_loop()
    for t in threads:
        await loop.run_in_executor(None, t.join, timeout_s)
    assert not any(t.is_alive() for t in threads)


def chaos_scenario(cl, seed):
    """tests/test_chaos.py's acceptance scenario, in package ``cl``."""
    return cl.Scenario(
        n_batches=3,
        retry=cl.Retry(max_attempts=2, backoff_s=0.05, max_backoff_s=0.2),
        faults=cl.FaultPlan(
            seed=seed,
            kills=((seed % 3, 0.35),),
            slowdowns=(((seed + 1) % 3, 0.0, 2.0),),
            payload_errors=((0, 1, 1),),
        ),
    )


def missing_before_crash(events) -> list:
    """What the acceptance scenario's journal must hold before the crash, and
    does not yet: job 1 in flight (dispatched, not finished), every delivered
    kill's ``eof`` failure, the payload raise's ``task_fail`` and ``retry``."""
    kills = {e["wid"] for e in events if e["ev"] == "chaos" and e["kind"] == "kill"}
    eofs = {e["wid"] for e in events if e["ev"] == "fail" and e["cause"] == "eof"}
    kinds = {e["ev"] for e in events}
    missing = [] if any(e["ev"] == "dispatch" and e["job"] == 1 for e in events) \
        else ["job 1 dispatched"]
    missing += [] if kills and kills <= eofs else ["the kill and its eof"]
    missing += [ev for ev in ("task_fail", "retry") if ev not in kinds]
    return missing


async def wait_for(master, run_task, missing_fn) -> None:
    """Wait until ``missing_fn(master.recorder.events)`` names nothing more
    (polled, not timed), failing if the run ends first."""
    for _ in range(3000):
        missing = missing_fn(master.recorder.events)
        if not missing:
            return
        if run_task.done():
            raise AssertionError(f"the run ended before the crash, missing {missing}")
        await asyncio.sleep(0.01)
    raise TimeoutError(f"never seen before the crash: {missing}")


async def crash_mid_run(rt, sc, journal, **kw):
    """Run two jobs under a journaling master and crash it once the journal
    holds what the assertions need (:func:`missing_before_crash`: waited on,
    not timed); returns (wids alive at the crash, the last stamp before it)."""
    master = rt.RuntimeMaster(3, sc, journal=journal, **KW)
    port = await master.start()
    threads = [rt.spawn_worker_thread(master.host, port, **kw) for _ in range(3)]
    crashed = False
    try:
        await master.wait_for_workers(30.0)
        jobs = [
            rt.LiveJob(job_id=0, costs=(0.5, 0.5, 0.5), name="chaotic"),
            rt.LiveJob(job_id=1, costs=(0.6, 0.6, 0.6), arrival=0.05, name="later"),
        ]
        run_task = asyncio.ensure_future(master.run(jobs, timeout_s=60.0))
        await wait_for(master, run_task, missing_before_crash)
        run_task.cancel()
        try:
            await run_task
        except asyncio.CancelledError:
            pass
        alive = [w.wid for w in master.workers if w.alive]
        last_t = master.recorder.events[-1]["t"]
        crashed = True
        await master.crash()
    finally:
        if not crashed:  # a failed wait: wave the workers off, so the failure is the wait's
            await master.close()
        await join_threads(threads, 5.0)
    return alive, last_t


async def recover_and_resume(journal):
    master = RuntimeMaster.recover(journal, **KW)
    port = await master.start()
    threads = [spawn_worker_thread(master.host, port, **CPU) for _ in range(3)]
    try:
        return await master.resume(timeout_s=60.0)
    finally:
        await master.close()
        await join_threads(threads, 5.0)


# --------------------------------------------------------------------------
# the acceptance scenario: kill + slowdown + payload raise + crash + recover
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_kill_retry_crash_recover_exact_twin(tmp_path, seed):
    journal = str(tmp_path / f"chaos-{seed}.jsonl")
    asyncio.run(crash_mid_run(prt, chaos_scenario(prt_cl, seed), journal, **CPU))
    mid = read_journal(journal)
    assert mid[0]["ev"] == "scenario"
    assert not any(e["ev"] == "recover" for e in mid)

    report = asyncio.run(recover_and_resume(journal))

    events = read_journal(journal)
    assert events == json.loads(json.dumps(list(report.trace)))
    assert [r.job_id for r in sorted(report.records, key=lambda r: r.job_id)] == [0, 1]
    assert all(r.finish < float("inf") for r in report.records)
    chaos_kinds = {e["kind"] for e in events if e["ev"] == "chaos"}
    assert "kill" in chaos_kinds and "raise" in chaos_kinds
    fail_causes = [e["cause"] for e in events if e["ev"] == "fail"]
    assert "eof" in fail_causes
    assert "crash" in fail_causes
    assert report.n_task_failures >= 1
    assert report.n_retries >= 1
    assert any(e["ev"] == "task_fail" for e in events)
    assert any(e["ev"] == "retry" for e in events)
    assert sum(1 for e in events if e["ev"] == "recover") == 1
    assert "PayloadError" in report.task_errors[0][3]
    assert_exact_twin(report, events)


# one raise of (job 0, batch 1), 1.5 s into its dispatch; the kill lands
# first, since it is delivered as soon as the raise's dispatch is journaled
LOST = Scenario(
    n_batches=3,
    retry=Retry(max_attempts=2, backoff_s=0.05, max_backoff_s=0.2),
    faults=FaultPlan(seed=0, payload_errors=((0, 1, 1),)),
)
LOST_JOBS = [LiveJob(job_id=0, costs=(3.0, 3.0, 3.0), name="lost")]


def raise_delivered(events) -> list:
    return [] if any(e["ev"] == "chaos" and e["kind"] == "raise" for e in events) \
        else ["the raise's dispatch"]


def raise_given_back(events) -> list:
    kinds = {(e["ev"], e.get("kind"), e.get("cause")) for e in events}
    return [] if {("chaos", "rearm", None), ("fail", None, "eof")} <= kinds \
        else ["the killed worker's eof and the give-back"]


async def kill_the_raise_holder(master, run_task) -> int:
    """Kill, through the master's chaos path, the worker whose dispatch
    carries the raise, once that dispatch is journaled; returns its wid."""
    await wait_for(master, run_task, raise_delivered)
    carried = next(e for e in master.recorder.events
                   if e["ev"] == "chaos" and e["kind"] == "raise")
    master._deliver_kill(master.workers[carried["wid"]])
    return carried["wid"]


def test_raise_lost_with_its_worker_goes_to_the_next_dispatch():
    """The port's injector gives back a payload raise whose worker died
    before it raised (a kill lands mid-payload): the plan's one raise of
    (job 0, batch 1) still fails a task, on the rescue dispatch, and the
    retry follows.  This is the race the acceptance scenario's kill of
    worker 1 (0.35 s on the master's clock, which starts before the workers
    join) ran against its raise (0.25 s into worker 1's first dispatch) on a
    loaded host: the raise died with the worker, and no ``task_fail`` came.
    Here the kill follows the raise's dispatch by construction."""

    async def run():
        master = RuntimeMaster(3, LOST, **KW)
        port = await master.start()
        threads = [spawn_worker_thread(master.host, port, **CPU) for _ in range(3)]
        try:
            await master.wait_for_workers(30.0)
            run_task = asyncio.ensure_future(master.run(LOST_JOBS, timeout_s=60.0))
            killed = await kill_the_raise_holder(master, run_task)
            return killed, await run_task
        finally:
            await master.close()
            await join_threads(threads, 5.0)

    killed, report = asyncio.run(run())
    events = list(report.trace)
    raises = [e for e in events if e["ev"] == "chaos" and e["kind"] == "raise"]
    kill = next(e for e in events if e["ev"] == "chaos" and e["kind"] == "kill")
    assert kill["wid"] == killed == raises[0]["wid"] and kill["t"] > raises[0]["t"]
    assert any(e["ev"] == "fail" and e["cause"] == "eof" and e["wid"] == killed for e in events)
    rearms = [e for e in events if e["ev"] == "chaos" and e["kind"] == "rearm"]
    assert [(e["job"], e["batch"], e["wid"]) for e in rearms] == [(0, 1, killed)]
    fails = [e for e in events if e["ev"] == "task_fail"]
    assert [(e["job"], e["batch"]) for e in fails] == [(0, 1)]
    assert fails[0]["t"] > kill["t"]  # the kill beat the first raise
    assert fails[0]["wid"] != killed  # the rescue dispatch raised, not the killed worker's
    assert len(raises) == 2  # delivered to the killed worker, lost with it, delivered again
    assert report.n_task_failures == 1 and report.n_retries == 1
    assert report.records[0].finish < float("inf")
    assert_exact_twin(report)


@pytest.mark.parametrize("lost_by", ["kill", "crash"])
def test_crash_after_a_lost_raise_recovers_the_give_back(tmp_path, lost_by):
    """A raise lost with its worker, then a crash before the rescue dispatch
    that would carry it.  ``kill``: the worker is killed mid-payload and the
    journal holds the give-back (``rearm``) before the crash.  ``crash``: the
    crash itself takes the worker, and recovery's ``crash`` fail gives the
    raise back.  Either way the recovered master delivers the raise again, as
    the uncrashed run does, and the one journal still replays exactly."""
    journal = str(tmp_path / "lost.jsonl")

    async def crash():
        master = RuntimeMaster(3, LOST, journal=journal, **KW)
        port = await master.start()
        threads = [spawn_worker_thread(master.host, port, **CPU) for _ in range(3)]
        crashed = False
        try:
            await master.wait_for_workers(30.0)
            run_task = asyncio.ensure_future(master.run(LOST_JOBS, timeout_s=60.0))
            if lost_by == "kill":
                await kill_the_raise_holder(master, run_task)
                await wait_for(master, run_task, raise_given_back)
            else:
                await wait_for(master, run_task, raise_delivered)
            run_task.cancel()
            try:
                await run_task
            except asyncio.CancelledError:
                pass
            crashed = True
            await master.crash()
        finally:
            if not crashed:
                await master.close()
            await join_threads(threads, 5.0)

    asyncio.run(crash())
    mid = read_journal(journal)
    carried = next(e for e in mid if e["ev"] == "chaos" and e["kind"] == "raise")
    # the crash fell before the batch's next dispatch, and before any task failed
    assert max(i for i, e in enumerate(mid) if e["ev"] == "dispatch"
               and (e["job"], e["batch"]) == (0, 1)) < mid.index(carried)
    assert not any(e["ev"] == "task_fail" for e in mid)

    report = asyncio.run(recover_and_resume(journal))
    events = read_journal(journal)
    after = events[len(mid):]
    assert sum(1 for e in after if e["ev"] == "recover") == 1
    rearms = [e for e in events if e["ev"] == "chaos" and e["kind"] == "rearm"]
    assert [(e["job"], e["batch"], e["wid"]) for e in rearms] == [(0, 1, carried["wid"])]
    assert (rearms[0] in after) == (lost_by == "crash")
    if lost_by == "crash":
        assert any(e["ev"] == "fail" and e["cause"] == "crash" and e["wid"] == carried["wid"]
                   for e in after[:after.index(rearms[0])])
    raises = [e for e in events if e["ev"] == "chaos" and e["kind"] == "raise"]
    assert len(raises) == 2 and raises[1] in after  # recovery delivers the raise given back
    fails = [e for e in events if e["ev"] == "task_fail"]
    assert [(e["job"], e["batch"]) for e in fails] == [(0, 1)] and fails[0] in after
    assert report.n_task_failures == 1 and report.n_retries == 1
    assert report.records[0].finish < float("inf")
    assert_exact_twin(report, events)


def test_crash_records_nothing_and_recover_stamps_the_seam(tmp_path):
    """The repair itself: the journal ends where the crash struck (no
    ``fail`` after the last pre-crash event), and recovery stamps one
    ``cause="crash"`` fail for every worker alive at the crash, before the
    ``recover`` seam."""
    journal = str(tmp_path / "crash.jsonl")
    alive, last_t = asyncio.run(crash_mid_run(prt, chaos_scenario(prt_cl, 1), journal, **CPU))
    assert alive  # the crash struck live workers
    mid = read_journal(journal)
    assert mid[-1]["t"] == last_t
    assert not any(e["ev"] == "fail" and e["t"] > last_t for e in mid)

    report = asyncio.run(recover_and_resume(journal))
    events = read_journal(journal)
    seam = events[len(mid): len(mid) + len(alive) + 1]
    assert [(e["ev"], e.get("wid"), e.get("cause")) for e in seam] == [
        ("fail", wid, "crash") for wid in alive] + [("recover", None, None)]
    assert seam[0]["t"] > last_t
    assert_exact_twin(report, events)


# --------------------------------------------------------------------------
# recovery from one journal rebuilds the same state in both packages
# --------------------------------------------------------------------------


def master_state(m) -> dict:
    """Everything recovery rebuilds, in plain values."""
    return {
        "queue": [j.job_id for j in m.queue],
        "active": {
            j: (x.job.job_id, x.job.costs, x.start, x.n_batches, x.replication, x.cancel,
                sorted(x.done), {b: sorted(w) for b, w in x.outstanding.items()},
                list(x.obs), x.spec_used)
            for j, x in m.active.items()
        },
        "rescue": list(m.rescue),
        "pending_retries": list(m._pending_retries),
        "retry_batches": sorted(m._retry_batches),
        "attempts": dict(m._attempts),
        "workers": [(w.wid, w.alive, w.assignment, w.epoch, w.busy_since, w.scheduled_end,
                     w.writer) for w in m.workers],
        "records": [record_tuple(r) for r in m.records],
        "completion_order": list(m.completion_order),
        "n_jobs_expected": m._n_jobs_expected,
        "task_errors": list(m.task_errors),
        "accounting": (m._ws, m._saved, m._n_failures, m._n_rescued, m._n_spec,
                       m._n_task_failures, m._n_retries),
        "chaos": (sorted(m._chaos._killed), dict(m._chaos._raises),
                  sorted(m._chaos._stalls_stamped)) if m._chaos else None,
        "events": list(m.recorder.events),
    }


def both_recover_alike(journal, tmp_path, monkeypatch):
    """Recover from copies of ``journal`` in both packages, on a stopped
    clock (the seam's stamps then follow the journal's last one by whole
    ticks, alike in both), and return the one state both rebuilt."""
    stopped = types.SimpleNamespace(monotonic=lambda: 1000.0)
    monkeypatch.setattr(ptrace, "time", stopped)
    monkeypatch.setattr(rtrace, "time", stopped)
    n = len(read_journal(journal))
    states = {}
    for name, rt in (("repro", rrt), ("repro_torch", prt)):
        copy = str(tmp_path / f"{name}.jsonl")
        shutil.copyfile(journal, copy)
        m = rt.RuntimeMaster.recover(copy, **KW)
        try:
            states[name] = master_state(m)
        finally:
            m.recorder.close_journal()
        assert read_journal(copy) == list(m.recorder.events)  # the seam is journaled
    assert states["repro_torch"] == states["repro"]
    state = states["repro_torch"]
    state["seam"] = state["events"][n:]
    return state


@pytest.mark.parametrize("seed", [0, 3])
def test_reference_journal_cut_by_crash_recovers_alike(tmp_path, monkeypatch, seed):
    """A journal the reference's runtime left at its crash (cut after its
    connection handlers journaled their EOFs, so no worker is alive in it)
    rebuilds the same queue, active set, rescue list, pending retries and
    accounting in both packages."""
    journal = str(tmp_path / "ref.jsonl")
    asyncio.run(crash_mid_run(rrt, chaos_scenario(rrt_cl, seed), journal))
    state = both_recover_alike(journal, tmp_path, monkeypatch)
    assert state["active"] or state["queue"]  # the crash left work to resume


def test_port_journal_cut_by_crash_recovers_alike(tmp_path, monkeypatch):
    journal = str(tmp_path / "port.jsonl")
    alive, _ = asyncio.run(crash_mid_run(prt, chaos_scenario(prt_cl, 2), journal, **CPU))
    state = both_recover_alike(journal, tmp_path, monkeypatch)
    assert [e["wid"] for e in state["seam"] if e["ev"] == "fail"] == alive
    assert state["seam"][-1]["ev"] == "recover"
    assert not any(w[1] for w in state["workers"])  # every slot awaits a re-join


# --------------------------------------------------------------------------
# wire faults, retry exhaustion, journal plumbing, serialization
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_chaos_with_supervisor_replays_exactly(seed):
    sc = Scenario(
        n_batches=2,
        retry=Retry(max_attempts=3, backoff_s=0.05, max_backoff_s=0.2),
        faults=FaultPlan(seed=seed, drop_p=0.15, dup_p=0.10, delay_p=0.10, delay_s=0.02),
    )

    async def run():
        master = RuntimeMaster(2, sc, heartbeat_s=0.05, heartbeat_timeout_s=1.0,
                               lease_factor=4.0, lease_floor_s=1.0)
        port = await master.start()
        threads = [spawn_worker_thread(master.host, port, **CPU) for _ in range(2)]

        async def supervise():
            handled = 0
            while not master._finalized:
                await asyncio.sleep(0.05)
                fails = sum(1 for e in master.recorder.events if e["ev"] == "fail")
                while handled < fails:
                    handled += 1
                    threads.append(spawn_worker_thread(master.host, port, **CPU))

        sup = None
        try:
            await master.wait_for_workers(30.0)
            sup = asyncio.ensure_future(supervise())
            return await master.run(
                [LiveJob(job_id=0, costs=(0.2, 0.2, 0.2, 0.2), name="wired")], timeout_s=90.0
            )
        finally:
            if sup is not None:
                sup.cancel()
            await master.close()
            await join_threads(threads, 5.0)

    report = asyncio.run(run())
    assert len(report.records) == 1
    assert report.records[0].finish < float("inf")
    assert any(e["ev"] == "chaos" for e in report.trace)
    assert_exact_twin(report)


def test_retry_budget_exhausted_abandons_exactly():
    sc = Scenario(n_batches=1, retry=Retry(max_attempts=2, backoff_s=0.05))
    report = Runtime(1, sc, **CPU).run(
        [LiveJob(job_id=0, costs=(0.1,), payload="raise", name="doomed")], timeout_s=60.0
    )
    assert (report.n_task_failures, report.n_retries) == (3, 2)
    assert len(report.records) == 1 and report.records[0].finish == float("inf")
    retries = [e for e in report.trace if e["ev"] == "retry"]
    assert [e["attempt"] for e in retries] == [1, 2]
    assert any(e["ev"] == "job_fail" for e in report.trace)
    fails = [e for e in report.trace if e["ev"] == "task_fail"]
    for f, r in zip(fails, retries):
        assert r["t"] - f["t"] >= 0.05 - 1e-9
    assert_exact_twin(report)


def test_journal_equals_trace_and_survives_torn_tail(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sc = Scenario(n_batches=2)
    report = Runtime(2, sc, journal=path, **CPU).run(
        [LiveJob(job_id=0, costs=(0.05, 0.05), name="journaled")], timeout_s=30.0
    )
    events = read_journal(path)
    assert events == json.loads(json.dumps(list(report.trace)))
    assert_exact_twin(report, events)
    with open(path, "ab") as f:
        f.write(b'{"ev": "disp')
    assert read_journal(path) == events
    with open(path, "wb") as f:
        f.write(b'{"ev": "join", "t": 1.0}\n???garbage???\n{"ev": "flush", "t": 2.0}\n')
    with pytest.raises(json.JSONDecodeError):
        read_journal(path)


def test_faultplan_and_retry_serialize_and_validate():
    kw = dict(
        seed=7, kills=((1, 0.2),), slowdowns=((0, 0.0, 3.0),), hb_stalls=((1, 0.1, 0.4),),
        payload_errors=((0, 0, 2),), drop_p=0.05, dup_p=0.05, delay_p=0.05, delay_s=0.01,
    )
    sc = Scenario(n_batches=2, retry=Retry(max_attempts=3, backoff_s=0.01, max_backoff_s=0.5),
                  faults=FaultPlan(**kw))
    assert Scenario.from_dict(json.loads(json.dumps(sc.to_dict()))) == sc
    # the same dict in both packages: a journal's scenario header reads in either
    ref = rrt_cl.Scenario(n_batches=2, faults=rrt_cl.FaultPlan(**kw),
                          retry=rrt_cl.Retry(max_attempts=3, backoff_s=0.01, max_backoff_s=0.5))
    assert sc.to_dict() == ref.to_dict()
    with pytest.raises(ValueError, match="faults"):
        Scenario(faults=FaultPlan(seed=1)).validate(n_workers=2, backend="python")
    with pytest.raises(ValueError, match="retry"):
        Scenario(retry=Retry()).validate(n_workers=2, backend="torch")
    with pytest.raises(ValueError, match="worker ids"):
        Scenario(faults=FaultPlan(seed=0, kills=((5, 0.1),))).validate(
            n_workers=2, backend="live")
    r = Retry(max_attempts=4, backoff_s=0.1, max_backoff_s=0.35)
    assert [r.backoff(k) for k in (1, 2, 3, 4)] == [0.1, 0.2, 0.35, 0.35]


def test_recovered_master_refuses_run_and_fresh_refuses_resume(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sc = Scenario(n_batches=1)
    Runtime(1, sc, journal=path, **CPU).run([LiveJob(job_id=0, costs=(0.02,))], timeout_s=30.0)

    async def check():
        fresh = RuntimeMaster(1, sc)
        with pytest.raises(RuntimeError, match="resume"):
            await fresh.resume()
        recovered = RuntimeMaster.recover(path)
        with pytest.raises(RuntimeError, match="resume"):
            await recovered.run([])
        report = await recovered.resume(timeout_s=5.0)
        await recovered.close()
        return report

    report = asyncio.run(check())
    assert len(report.records) == 1
    assert report.records[0].finish < float("inf")
