"""The port's live runtime on its own: real localhost master-worker runs whose
traces replay bit for bit through the port's engine (the digital twin), the
reference's ``tests/test_runtime_live.py`` on the port with its workers on the
CPU, plus the ``torch`` payload, the device rule of every worker entry point,
and the port's own subprocess worker.

Every wait is bounded in code (``Runtime.run(timeout_s=...)``,
``asyncio.wait_for``, loops with an iteration cap, ``join`` / ``wait`` with a
timeout and a kill), since no plugin here enforces ``pytest.mark.timeout``.
"""
import asyncio
import json
import os
import pathlib
import signal
import socket
import struct
import subprocess
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster.runtime import (  # noqa: E402
    TICK,
    LiveJob,
    Runtime,
    RuntimeMaster,
    TraceRecorder,
    replay_trace,
    spawn_worker_subprocess,
    spawn_worker_thread,
    trace_accounting,
    worker_loop,
)
from repro_torch.cluster.runtime import worker as worker_mod  # noqa: E402
from repro_torch.cluster.runtime.protocol import (  # noqa: E402
    MAX_FRAME,
    ProtocolError,
    read_msg,
    send_nowait,
)
from repro_torch.cluster.runtime.trace import quantize  # noqa: E402
from repro_torch.cluster.scenario import Scenario, Speculation  # noqa: E402
from repro_torch.cluster.scheduler import JobPlan  # noqa: E402
from test_torch_runtime_cuda import assert_exact_twin  # noqa: E402

pytestmark = pytest.mark.timeout(120)

CPU = {"device": "cpu"}
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


async def wait_until(cond, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not met within {timeout_s} s")
        await asyncio.sleep(0.01)


async def stop_procs(procs, timeout_s=5.0):
    loop = asyncio.get_running_loop()
    for p in procs:
        try:
            await loop.run_in_executor(None, p.wait, timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            await loop.run_in_executor(None, p.wait, timeout_s)


def dispatched_wid(master, batch):
    return next((e["wid"] for e in master.recorder.events
                 if e["ev"] == "dispatch" and e["batch"] == batch), None)


# --------------------------------------------------------------------------
# e2e exact-twin runs (thread workers, real sockets)
# --------------------------------------------------------------------------


def test_twin_exact_basic_sleep():
    sc = Scenario(n_batches=3)
    jobs = [
        LiveJob(job_id=0, costs=(0.08, 0.05, 0.06, 0.04, 0.07, 0.05), name="a"),
        LiveJob(job_id=1, costs=(0.05, 0.04, 0.06), arrival=0.05, name="b"),
    ]
    report = Runtime(3, sc, **CPU).run(jobs, timeout_s=30.0)
    assert [r.job_id for r in report.records] == [0, 1]
    assert report.completion_order == (0, 1)
    assert report.n_worker_failures == 0
    assert report.cancelled_seconds_saved == 0.0
    assert_exact_twin(report, n_workers=3, scenario=sc)
    assert report.records[1].start >= report.records[0].finish


def test_twin_exact_cancel_on_earliest_cover():
    sc = Scenario(n_batches=2, cancel_redundant=True)
    jobs = [LiveJob(job_id=0, costs=(0.10, 0.10, 0.10, 0.10), skew=0.8)]
    report = Runtime(4, sc, **CPU).run(jobs, timeout_s=30.0)
    assert report.records[0].replication == 2
    assert report.cancelled_seconds_saved > 0.05
    assert report.n_worker_failures == 0
    assert len([e for e in report.trace if e["ev"] == "cancel"]) == 2
    assert_exact_twin(report, n_workers=4, scenario=sc)


def test_twin_exact_job_plan_overrides():
    sc = Scenario(n_batches=2, cancel_redundant=False)
    jobs = [
        LiveJob(job_id=0, costs=(0.08, 0.06), skew=0.7,
                plan=JobPlan(n_batches=1, cancel_redundant=True)),
        LiveJob(job_id=1, costs=(0.05, 0.06), arrival=0.02),
    ]
    report = Runtime(2, sc, **CPU).run(jobs, timeout_s=30.0)
    assert (report.records[0].n_batches, report.records[0].replication) == (1, 2)
    assert (report.records[1].n_batches, report.records[1].replication) == (2, 1)
    assert report.cancelled_seconds_saved > 0.0
    assert_exact_twin(report, n_workers=2, scenario=sc)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_twin_exact_matmul_payloads(payload):
    """Real compute payloads (the host numpy chain, and the torch chain on the
    worker's device): jittery wall-clock, still an exact replay."""
    sc = Scenario(n_batches=2)
    jobs = [LiveJob(job_id=0, costs=(0.06, 0.05, 0.04, 0.05), payload=payload)]
    report = Runtime(2, sc, **CPU).run(jobs, timeout_s=30.0)
    assert len(report.records) == 1
    assert_exact_twin(report, n_workers=2, scenario=sc)


def test_twin_exact_torch_payload_cancel_on_earliest_cover():
    sc = Scenario(n_batches=2, cancel_redundant=True)
    jobs = [LiveJob(job_id=0, costs=(0.08,) * 4, skew=0.8, payload="torch"),
            LiveJob(job_id=1, costs=(0.06,) * 4, skew=0.8, payload="torch", arrival=0.01)]
    report = Runtime(4, sc, **CPU).run(jobs, timeout_s=30.0)
    assert report.cancelled_seconds_saved > 0.0
    assert len([e for e in report.trace if e["ev"] == "cancel"]) == 4
    assert_exact_twin(report, n_workers=4, scenario=sc)


def test_trace_fold_matches_live_counters():
    sc = Scenario(n_batches=2, cancel_redundant=True)
    report = Runtime(4, sc, **CPU).run(
        [LiveJob(job_id=0, costs=(0.08, 0.08, 0.08, 0.08), skew=0.5)], timeout_s=30.0
    )
    assert trace_accounting(report.trace) == report.accounting()


def test_twin_exact_speculative_backup():
    sc = Scenario(n_batches=3, cancel_redundant=True,
                  speculation=Speculation(interval=0.12, theta=2.0))
    jobs = [LiveJob(job_id=0, costs=(0.15, 0.15, 1.0), skew=0.8)]
    report = Runtime(3, sc, **CPU).run(jobs, timeout_s=30.0)
    assert report.n_speculative == 1
    assert report.accounting()["n_speculative"] == 1
    specs = [e for e in report.trace if e["ev"] == "dispatch" and e.get("spec")]
    assert len(specs) == 1 and specs[0]["batch"] == 2 and not specs[0]["rescue"]
    assert report.cancelled_seconds_saved > 0.5
    assert report.records[0].finish < 2.0
    eng = assert_exact_twin(report, n_workers=3, scenario=sc)
    assert eng.n_speculative == 1


def test_trace_alone_replays_with_embedded_scenario():
    sc = Scenario(n_batches=3, cancel_redundant=True,
                  speculation=Speculation(interval=0.12, theta=2.0))
    report = Runtime(3, sc, **CPU).run(
        [LiveJob(job_id=0, costs=(0.15, 0.15, 1.0), skew=0.8)], timeout_s=30.0
    )
    head = report.trace[0]
    assert head["ev"] == "scenario" and head["n_workers"] == 3
    assert Scenario.from_dict(head["scenario"]) == sc
    events = json.loads(json.dumps(list(report.trace)))
    assert replay_trace(events).accounting() == report.accounting()
    bare = [e for e in events if e["ev"] != "scenario"]
    with pytest.raises(ValueError, match="n_workers"):
        replay_trace(bare)
    with pytest.raises(ValueError, match="Speculation"):
        replay_trace(bare, 3)


# --------------------------------------------------------------------------
# chaos: SIGKILL a subprocess worker mid-task -> rescue -> exact replay
# --------------------------------------------------------------------------


def test_subprocess_kill_mid_task_rescued_exactly():
    async def run():
        sc = Scenario(n_batches=3)
        master = RuntimeMaster(3, sc, heartbeat_s=0.05, heartbeat_timeout_s=5.0)
        port = await master.start()
        procs = [spawn_worker_subprocess(master.host, port, **CPU) for _ in range(3)]
        try:
            await master.wait_for_workers(60.0)
            jobs = [LiveJob(job_id=0, costs=(0.3, 0.3, 1.6), name="victim-run")]
            run_task = asyncio.ensure_future(master.run(jobs, timeout_s=60.0))
            await wait_until(lambda: dispatched_wid(master, 2) is not None, what="dispatch")
            victim = dispatched_wid(master, 2)
            await asyncio.sleep(0.3)  # let the batch be genuinely mid-task
            os.kill(master.workers[victim].pid, signal.SIGKILL)
            report = await run_task
        finally:
            await master.close()
            await stop_procs(procs)
        return report, victim

    report, victim = asyncio.run(run())
    assert (report.n_worker_failures, report.n_replicas_rescued) == (1, 1)
    fails = [e for e in report.trace if e["ev"] == "fail"]
    assert [e["wid"] for e in fails] == [victim] and fails[0]["cause"] == "eof"
    rescues = [e for e in report.trace if e["ev"] == "dispatch" and e["rescue"]]
    assert len(rescues) == 1 and rescues[0]["batch"] == 2
    assert report.records[0].finish < float("inf")
    assert_exact_twin(report, n_workers=3, scenario=Scenario(n_batches=3))


# The survivor's batch (costs[0::2]) must outlast a replacement subprocess's
# start, or the survivor itself serves the rescue.  A port worker registered
# 0.88 to 0.96 s after its spawn on an idle 8-core host and 1.02 to 1.22 s with
# eight CPU-bound processes beside it; 8 s keeps the order with room to spare
# under a loaded parallel test run (the reference's 2.5 s did not always).
SURVIVOR_COST_S = 8.0


def test_subprocess_rejoin_serves_rescue_and_replays_exactly():
    async def run():
        sc = Scenario(n_batches=2)
        master = RuntimeMaster(2, sc, heartbeat_s=0.05, heartbeat_timeout_s=5.0)
        port = await master.start()
        procs = [spawn_worker_subprocess(master.host, port, **CPU) for _ in range(2)]
        try:
            await master.wait_for_workers(60.0)
            jobs = [LiveJob(job_id=0, costs=(SURVIVOR_COST_S, 1.2), name="rejoin-run")]
            run_task = asyncio.ensure_future(master.run(jobs, timeout_s=60.0))
            await wait_until(lambda: dispatched_wid(master, 1) is not None, what="dispatch")
            victim = dispatched_wid(master, 1)
            await asyncio.sleep(0.3)
            os.kill(master.workers[victim].pid, signal.SIGKILL)
            await wait_until(lambda: any(e["ev"] == "fail" for e in master.recorder.events),
                             what="the victim's fail")
            t_spawn = master.recorder.elapsed()
            procs.append(spawn_worker_subprocess(master.host, port, **CPU))
            report = await run_task
        finally:
            await master.close()
            await stop_procs(procs)
        return report, victim, t_spawn

    report, victim, t_spawn = asyncio.run(run())
    joins = [e for e in report.trace if e["ev"] == "join"]
    fails = [e for e in report.trace if e["ev"] == "fail"]
    # the replacement started well inside the survivor's batch
    assert joins[-1]["t"] - t_spawn < SURVIVOR_COST_S / 2
    assert (report.n_worker_failures, report.n_replicas_rescued) == (1, 1)
    assert [e["wid"] for e in fails] == [victim]
    assert len(joins) == 3 and joins[2]["wid"] == victim
    assert joins[2]["t"] > fails[0]["t"]
    rescues = [e for e in report.trace if e["ev"] == "dispatch" and e["rescue"]]
    assert len(rescues) == 1 and rescues[0]["batch"] == 1
    assert rescues[0]["wid"] == victim and rescues[0]["t"] >= joins[2]["t"]
    assert report.records[0].finish < float("inf")
    assert_exact_twin(report, n_workers=2, scenario=Scenario(n_batches=2))


# --------------------------------------------------------------------------
# payload failures, failure detection, validation
# --------------------------------------------------------------------------


def test_raising_payload_surfaces_in_live_report():
    sc = Scenario(n_batches=2)
    report = Runtime(2, sc, **CPU).run(
        [LiveJob(job_id=0, costs=(0.08, 0.06), payload="raise")], timeout_s=30.0
    )
    assert (report.n_task_failures, report.n_retries) == (1, 0)
    assert len(report.task_errors) == 1
    job_id, _batch, _wid, err = report.task_errors[0]
    assert job_id == 0 and "PayloadError" in err and "payload exploded" in err
    fails = [e for e in report.trace if e["ev"] == "task_fail"]
    assert len(fails) == 1 and fails[0]["attempt"] == 1
    assert any(e["ev"] == "job_fail" for e in report.trace)
    assert report.records[0].finish == float("inf")
    assert_exact_twin(report, n_workers=2, scenario=sc)


def test_heartbeat_timeout_detection_within_window():
    timeout_s = 0.4

    async def run():
        master = RuntimeMaster(2, Scenario(n_batches=2), heartbeat_s=0.05,
                               heartbeat_timeout_s=timeout_s)
        port = await master.start()
        threads = [spawn_worker_thread(master.host, port, **CPU) for _ in range(2)]
        try:
            await master.wait_for_workers(30.0)
            jobs = [LiveJob(job_id=0, costs=(1.5, 1.5), payload="block")]
            run_task = asyncio.ensure_future(master.run(jobs, timeout_s=60.0))
            await wait_until(lambda: master._n_failures >= 2, what="two heartbeat failures")
            run_task.cancel()
            try:
                await run_task
            except asyncio.CancelledError:
                pass
            events = master.recorder.events
        finally:
            await master.close()
        for t in threads:
            t.join(timeout=5.0)
        assert not any(t.is_alive() for t in threads)
        return events

    events = asyncio.run(run())
    fails = {e["wid"]: e for e in events if e["ev"] == "fail"}
    dispatches = {e["wid"]: e for e in events if e["ev"] == "dispatch"}
    assert set(fails) == {0, 1}
    for wid, f in fails.items():
        assert f["cause"] == "heartbeat"
        latency = f["t"] - dispatches[wid]["t"]
        assert timeout_s - 0.07 <= latency <= timeout_s + 1.0


def test_short_block_survives_heartbeat_window():
    sc = Scenario(n_batches=2)
    rt = Runtime(2, sc, heartbeat_s=0.05, heartbeat_timeout_s=1.0, **CPU)
    report = rt.run([LiveJob(job_id=0, costs=(0.15, 0.12), payload="block")], timeout_s=30.0)
    assert report.n_worker_failures == 0
    assert len(report.records) == 1
    assert_exact_twin(report, n_workers=2, scenario=sc)


def test_runtime_rejects_simulation_only_knobs():
    with pytest.raises(ValueError, match="simulation-only"):
        RuntimeMaster(4, Scenario(speeds=(1.0, 1.0, 2.0, 1.0)))
    with pytest.raises(ValueError, match="space-sharing"):
        RuntimeMaster(4, Scenario(workers_per_job=2))
    with pytest.raises(ValueError, match="Scenario.n_batches"):
        RuntimeMaster(2, Scenario(n_batches=5))
    with pytest.raises(ValueError, match="spawn"):
        Runtime(2, spawn="fork-bomb", **CPU)


# --------------------------------------------------------------------------
# the device: every worker entry point needs a card or device="cpu"
# --------------------------------------------------------------------------


def test_worker_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runtime(2, Scenario(n_batches=2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn_worker_thread("127.0.0.1", port)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn_worker_subprocess("127.0.0.1", port)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(asyncio.wait_for(worker_loop("127.0.0.1", port), 10.0))
        # ... and raises before it connects: nothing reached the socket
        lst.settimeout(0.2)
        with pytest.raises(socket.timeout):
            lst.accept()
    finally:
        lst.close()
    # the CLI: a worker process without a card exits with the message
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.cluster.runtime", "127.0.0.1",
                          str(port)], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_torch_payload_cancels_at_a_step_boundary(monkeypatch):
    """A cancel lands at the await between steps: no step is cut short and
    none runs after it."""
    steps = {"begun": 0, "ended": 0}
    real = worker_mod._torch_step

    def counted(a):
        steps["begun"] += 1
        a = real(a)
        steps["ended"] += 1
        return a

    monkeypatch.setattr(worker_mod, "_torch_step", counted)

    async def run():
        task = asyncio.ensure_future(worker_mod.run_payload("torch", (30.0,), 1.0, "cpu"))
        await asyncio.sleep(0.2)
        at_cancel = dict(steps)
        t0 = time.monotonic()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(task, 10.0)
        return at_cancel, time.monotonic() - t0

    at_cancel, latency = asyncio.run(run())
    assert at_cancel["begun"] == at_cancel["ended"] > 0
    assert steps == at_cancel
    assert latency < 1.0
    n = asyncio.run(worker_mod.run_payload("torch", (0.02, 0.02), 1.0, "cpu"))
    assert n > 0 and steps["ended"] == at_cancel["ended"] + n


def test_spawned_subprocess_is_the_port_worker():
    async def run():
        master = RuntimeMaster(1, Scenario(n_batches=1))
        port = await master.start()
        proc = spawn_worker_subprocess(master.host, port, **CPU)
        try:
            await master.wait_for_workers(60.0)
            pid = master.workers[0].pid
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            report = await master.run([LiveJob(job_id=0, costs=(0.02,))], timeout_s=30.0)
        finally:
            await master.close()
            await stop_procs([proc])
        return pid, proc.pid, argv, report

    pid, popen_pid, argv, report = asyncio.run(run())
    assert pid == popen_pid
    assert argv[1:3] == [b"-m", b"repro_torch.cluster.runtime"]
    assert argv[-3:-1] == [b"--device", b"cpu"]
    assert len(report.records) == 1


def test_subprocess_worker_starts_outside_the_repo(tmp_path):
    """The child finds the port through the PYTHONPATH its spawner builds
    from its own location, whatever the working directory."""
    lst = socket.socket()
    lst.settimeout(60.0)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    script = (
        "import sys\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "from repro_torch.cluster.runtime.worker import spawn_worker_subprocess\n"
        f"p = spawn_worker_subprocess('127.0.0.1', {port}, device='cpu')\n"
        "print(p.pid, flush=True)\n"
        "p.wait(60)\n"
    )
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    parent = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              cwd=tmp_path, env=env)
    conn = None
    try:
        worker_pid = int(parent.stdout.readline())
        conn, _ = lst.accept()
        conn.settimeout(30.0)
        head = b""
        while len(head) < 4:
            head += conn.recv(4 - len(head))
        (n,) = struct.unpack(">I", head)
        body = b""
        while len(body) < n:
            body += conn.recv(n - len(body))
        assert json.loads(body) == {"type": "register", "pid": worker_pid}
    finally:
        if conn is not None:
            conn.close()  # the worker sees EOF instead of a welcome and exits
        lst.close()
        try:
            parent.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            parent.kill()
            parent.wait(timeout=10.0)
    assert parent.returncode == 0


# --------------------------------------------------------------------------
# trace + protocol units
# --------------------------------------------------------------------------


def test_trace_recorder_strictly_increasing_and_freezes():
    rec = TraceRecorder()
    stamps = [rec.stamp() for _ in range(50)]
    assert all(b - a >= TICK * 0.999 for a, b in zip(stamps, stamps[1:]))
    rec.record("join", stamps[0], wid=0)
    rec.frozen = True
    with pytest.raises(RuntimeError, match="frozen"):
        rec.record("join", stamps[1], wid=1)


def test_quantize_grid_exactness():
    assert quantize(0.0) == TICK
    assert quantize(TICK / 2) == TICK
    q = quantize(0.123456)
    assert q >= 0.123456
    assert q * (1 << 20) == int(q * (1 << 20))


def test_protocol_roundtrip_and_frame_guards():
    async def run():
        msgs = []

        async def handle(reader, writer):
            while True:
                m = await read_msg(reader)
                if m is None:
                    break
                msgs.append(m)
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        send_nowait(writer, {"type": "hb", "wid": 3})
        send_nowait(writer, {"type": "task", "costs": [0.25, 0.5], "payload": "sleep"})
        await writer.drain()
        writer.close()
        await wait_until(lambda: len(msgs) == 2, 10.0, "both frames")
        server.close()
        await asyncio.wait_for(server.wait_closed(), 10.0)
        return msgs

    assert asyncio.run(run()) == [
        {"type": "hb", "wid": 3},
        {"type": "task", "costs": [0.25, 0.5], "payload": "sleep"},
    ]
    sink = types.SimpleNamespace(write=lambda b: pytest.fail("oversized frame was sent"))
    with pytest.raises(ProtocolError, match="MAX_FRAME"):
        send_nowait(sink, {"type": "x", "blob": "a" * (MAX_FRAME + 1)})


def test_protocol_split_header_and_coalesced_frames():
    def encode(obj):
        data = json.dumps(obj, separators=(",", ":")).encode()
        return struct.pack(">I", len(data)) + data

    async def run():
        frame = encode({"type": "hb", "wid": 1})
        reader = asyncio.StreamReader()
        pending = asyncio.ensure_future(read_msg(reader))
        reader.feed_data(frame[:2])
        await asyncio.sleep(0.01)
        assert not pending.done()
        reader.feed_data(frame[2:7])
        await asyncio.sleep(0.01)
        assert not pending.done()
        reader.feed_data(frame[7:])
        assert await asyncio.wait_for(pending, 5.0) == {"type": "hb", "wid": 1}
        reader.feed_data(encode({"type": "finish", "wid": 0}) + encode({"type": "hb", "wid": 2}))
        assert await read_msg(reader) == {"type": "finish", "wid": 0}
        assert await read_msg(reader) == {"type": "hb", "wid": 2}
        reader.feed_eof()
        assert await read_msg(reader) is None

    asyncio.run(run())


def test_protocol_rejects_untyped_and_oversized_frames():
    async def run():
        reader = asyncio.StreamReader()
        payload = json.dumps([1, 2, 3]).encode()
        reader.feed_data(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(ProtocolError, match="typed message"):
            await read_msg(reader)
        reader2 = asyncio.StreamReader()
        reader2.feed_data(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(ProtocolError, match="MAX_FRAME"):
            await read_msg(reader2)
        reader3 = asyncio.StreamReader()
        reader3.feed_data(b"\x00\x00")
        reader3.feed_eof()
        assert await read_msg(reader3) is None

    asyncio.run(run())


# --------------------------------------------------------------------------
# worker-subprocess orphan prevention (PDEATHSIG + atexit fallback)
# --------------------------------------------------------------------------


def _dead_or_zombie(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, IndexError):
        return True


def test_spawn_worker_subprocess_atexit_fallback_kills_orphans():
    lst = socket.socket()
    lst.settimeout(60.0)
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    port = lst.getsockname()[1]
    proc = worker_mod.spawn_worker_subprocess("127.0.0.1", port, **CPU)
    conn = None
    try:
        assert proc in worker_mod._children
        conn, _ = lst.accept()
        assert proc.poll() is None
        worker_mod._kill_orphans()
        proc.wait(timeout=10.0)
        assert proc.poll() is not None
    finally:
        if conn is not None:
            conn.close()
        lst.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="PR_SET_PDEATHSIG is linux-only")
def test_pdeathsig_reaps_worker_when_parent_is_sigkilled():
    lst = socket.socket()
    lst.settimeout(60.0)
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    port = lst.getsockname()[1]
    script = (
        "import time\n"
        "from repro_torch.cluster.runtime.worker import spawn_worker_subprocess\n"
        f"p = spawn_worker_subprocess('127.0.0.1', {port}, device='cpu')\n"
        "print(p.pid, flush=True)\n"
        "time.sleep(120)\n"
    )
    env = os.environ.copy()
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    parent = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, env=env)
    conn = None
    worker_pid = None
    try:
        worker_pid = int(parent.stdout.readline())
        conn, _ = lst.accept()
        os.kill(parent.pid, signal.SIGKILL)
        parent.wait(timeout=10.0)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if _dead_or_zombie(worker_pid):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"worker {worker_pid} survived its parent's SIGKILL")
    finally:
        if conn is not None:
            conn.close()
        lst.close()
        for pid in (parent.pid, worker_pid):
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
