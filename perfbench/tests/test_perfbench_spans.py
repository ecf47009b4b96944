"""The program's spans as the benchmark reads them: matching, self time, the four readers.

On made-up events (ns): a device operation belongs to the span in which its
launch call began, on any thread, and to no span that was open only while it
ran; a span's self time leaves out its nested spans; the stream's order
stands in for the correlation id only where launch calls and device
operations are as many.  On the card (``-m cuda``), a traced tiny train step:
the stream's order gives each device operation the launch call that the
profiler's correlation id gives it, and no program span is drawn on the
device's timeline.
"""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, spans  # noqa: E402
from perfbench.trace import Trace  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

US = 1_000  # ns
READERS = ("select_ms.plan", "upload_ms.plan", "adamw_ms.train", "attn_bwd_ms.train")


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "m_" + name)


def test_a_launch_inside_a_span_on_another_thread_is_the_spans():
    # train.backward is open 0..100 us on the main thread; attention.backward
    # 20..40 us on autograd's thread, which launches operation 2 at 30 us
    sp = [("train.backward", 0, 100 * US), ("attention.backward", 20 * US, 40 * US)]
    launches = [(1, 10 * US), (2, 30 * US), (3, 60 * US)]
    device = [(1, 50 * US, 70 * US), (2, 70 * US, 90 * US), (3, 90 * US, 95 * US)]
    rows = spans.attribute(sp, launches, device)
    assert rows["attention.backward"].device_ns == 20 * US
    assert rows["train.backward"].device_ns == (20 + 20 + 5) * US


def test_an_operation_that_runs_while_a_span_is_open_but_was_launched_before_is_not_its():
    # the optimizer opens at 100 us; operation 1, launched at 90 us, runs 100..300 us
    sp = [("train.backward", 0, 95 * US), ("train.optimizer", 100 * US, 200 * US)]
    launches = [(1, 90 * US), (2, 150 * US)]
    device = [(1, 100 * US, 300 * US), (2, 300 * US, 310 * US)]
    rows = spans.attribute(sp, launches, device)
    assert rows["train.optimizer"].device_ns == 10 * US
    assert rows["train.backward"].device_ns == 200 * US


def test_an_operation_of_no_launch_in_the_window_is_nobodys():
    rows = spans.attribute([("plan.frontier", 0, 10 * US)], [(1, 5 * US)],
                           [(1, 20 * US, 21 * US), (7, 22 * US, 30 * US)])
    assert rows["plan.frontier"].device_ns == 1 * US


def test_self_time_leaves_out_the_nested_spans():
    sp = [("plan.frontier", 0, 100 * US), ("cover.upload", 10 * US, 30 * US),
          ("cover.launch", 30 * US, 35 * US), ("cover.readback", 40 * US, 90 * US),
          ("plan.select", 100 * US, 120 * US),
          ("plan.frontier", 200 * US, 250 * US), ("cover.upload", 210 * US, 220 * US)]
    rows = spans.attribute(sp, [], [])
    assert rows["plan.frontier"].count == 2
    assert rows["plan.frontier"].host_ns == 150 * US
    assert rows["plan.frontier"].self_ns == (100 - 20 - 5 - 50 + 50 - 10) * US
    assert rows["cover.upload"].self_ns == rows["cover.upload"].host_ns == 30 * US
    assert rows["plan.select"].self_ns == 20 * US


def test_self_time_counts_a_covered_instant_once():
    # two children that overlap in time (two threads) cover 10..50 us of the parent
    sp = [("train.backward", 0, 100 * US), ("attention.backward", 10 * US, 40 * US),
          ("rmsnorm.backward", 30 * US, 50 * US)]
    rows = spans.attribute(sp, [], [])
    assert rows["train.backward"].self_ns == 60 * US


def _trace(host, device, units=2, window=(0, 1000 * US)):
    return Trace(device, host + [("perfbench.unit", window[0], window[1])], window, units)


def _step_trace():
    """One step's made-up events: every launch call and its operation.

    The forward launches 2 kernels, the backward's attention 1 (on another
    thread) and the optimizer 2; the device runs them late, in their order."""
    host = [("train.forward", 0, 100 * US), ("cudaLaunchKernel", 10 * US, 12 * US),
            ("cuLaunchKernel", 20 * US, 22 * US),
            ("train.backward", 100 * US, 300 * US),
            ("attention.backward", 150 * US, 200 * US), ("cudaLaunchKernel", 160 * US, 162 * US),
            ("cudaMalloc", 210 * US, 290 * US),
            ("train.optimizer", 300 * US, 400 * US), ("cudaLaunchKernel", 310 * US, 311 * US),
            ("cudaMemsetAsync", 320 * US, 321 * US)]
    device = [("gemm_a", 50 * US, 150 * US), ("nvjet_b", 150 * US, 170 * US),
              ("softmax_bwd", 200 * US, 260 * US),
              ("vectorized_elementwise_kernel", 400 * US, 430 * US),
              ("Memset (Device)", 430 * US, 431 * US),
              ("train.forward", 50 * US, 170 * US)]  # a host range drawn on the device
    return _trace(host, device, units=1)


def test_stream_order_matches_each_operation_to_its_launch():
    launches, device = spans.stream_order(_step_trace())
    assert [c for c, _ in launches] == [c for c, _, _ in device] == [0, 1, 2, 3, 4]
    assert [t for _, t in launches] == [10 * US, 20 * US, 160 * US, 310 * US, 320 * US]
    assert [a for _, a, _ in device] == [50 * US, 150 * US, 200 * US, 400 * US, 430 * US]


def test_stream_order_says_nothing_where_the_counts_differ():
    tr = _step_trace()
    tr.host.append(("cudaLaunchKernel", 500 * US, 501 * US))
    assert spans.stream_order(tr) == (None, None)
    rows = spans.table(tr)
    assert rows["train.optimizer"].device_ns is None
    assert rows["train.optimizer"].host_ns == 100 * US


def test_the_train_readers_by_hand():
    tr = _step_trace()
    assert reader("adamw_ms.train").read(tr, {}) == pytest.approx(0.031)
    assert reader("attn_bwd_ms.train").read(tr, {}) == pytest.approx(0.060)
    rows = spans.table(tr)
    assert rows["train.forward"].device_ns == 120 * US
    assert rows["train.backward"].device_ns == 60 * US
    assert rows["train.backward"].self_ns == 150 * US


def test_the_plan_readers_by_hand():
    host = [("plan.scenario", 0, 5 * US), ("plan.frontier", 5 * US, 60 * US),
            ("cover.upload", 6 * US, 30 * US), ("cudaMemcpyAsync", 8 * US, 12 * US),
            ("cover.launch", 30 * US, 34 * US), ("cudaLaunchKernel", 31 * US, 33 * US),
            ("plan.select", 60 * US, 100 * US),
            ("plan.scenario", 100 * US, 104 * US), ("plan.frontier", 104 * US, 150 * US),
            ("cover.upload", 105 * US, 121 * US), ("plan.select", 150 * US, 170 * US)]
    device = [("Memcpy HtoD (Pageable -> Device)", 12 * US, 13 * US),
              ("sample_cover_f32_empirical", 33 * US, 37 * US)]
    tr = _trace(host, device, units=2, window=(0, 170 * US))
    assert reader("select_ms.plan").read(tr, {}) == pytest.approx(0.030)
    assert reader("upload_ms.plan").read(tr, {}) == pytest.approx(0.020)
    rows = spans.table(tr)
    assert rows["cover.upload"].device_ns == 1 * US
    assert rows["cover.launch"].device_ns == rows["plan.frontier"].device_ns - US == 4 * US


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_where_its_span_is_missing(name):
    host = [("cudaLaunchKernel", 10 * US, 12 * US), ("aten::add", 5 * US, 20 * US)]
    tr = _trace(host, [("vectorized_elementwise_kernel", 30 * US, 40 * US)], units=1)
    assert reader(name).read(tr, {}) is None
    assert reader(name).read(Trace([], [("perfbench.unit", 0, 1)], (0, 1), 1), {}) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_finds_nothing_in_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # its import fails
    assert spans.program_spans() == ()
    assert reader(name).read(_step_trace(), {}) is None


def test_the_device_readers_find_nothing_in_a_run_without_a_device():
    host = [("train.optimizer", 0, 10 * US), ("attention.backward", 0, 5 * US)]
    tr = _trace(host, [], units=1)
    assert reader("adamw_ms.train").read(tr, {}) is None
    assert reader("attn_bwd_ms.train").read(tr, {}) is None


def test_a_traced_tiny_cpu_plan_reads_its_host_spans():
    result = tiny.run(tiny.cell("plan"), seed=2**31 + 5, traced=True)
    assert result["metrics"]["select_ms.plan"]["value"] > 0
    # on the CPU kernel B's wrapper uploads nothing and nothing runs on a device
    for name in ("upload_ms.plan", "adamw_ms.train", "attn_bwd_ms.train"):
        assert name not in result["metrics"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stream_order_agrees_with_the_correlation_ids_on_the_card(card):
    import torch

    from perfbench import trace as trace_mod

    kept = {}
    result = trace_mod.Tracer.result

    def keep(self):
        kept["events"] = list(self.prof.profiler.kineto_results.events())
        kept["trace"] = result(self)
        return kept["trace"]

    cell = tiny.cell("train")
    trace_mod.Tracer.result = keep
    try:
        harness.run_cell(cell, 2**31 + 13, 1.0, True, card, harness.process_start())
    finally:
        trace_mod.Tracer.result = result
    tr = kept["trace"]
    lo, hi = tr.window_ns
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in kept["events"]
              if e.start_ns() + e.duration_ns() > lo and e.start_ns() < hi]
    host = [e for e in events if e.device_type() != cuda]
    device = [e for e in events if e.device_type() == cuda]
    assert not any(e.name() in spans.program_spans() for e in device)
    host_names = {e.name() for e in host}
    calls = sorted((e for e in host if e.name() in spans.LAUNCH_CALLS), key=lambda e: e.start_ns())
    ops = sorted((e for e in device if not e.is_user_annotation() and e.name() not in host_names),
                 key=lambda e: e.start_ns())
    assert len(calls) == len(ops) > 0
    assert [c.correlation_id() for c in calls] == [o.correlation_id() for o in ops]
    rows = spans.table(tr)
    busy = sum(b - a for a, b in spans._merge([(a, b) for n, a, b in tr.device
                                               if n not in host_names]))
    phases = sum(rows[n].device_ns for n in ("train.forward", "train.backward",
                                             "train.optimizer"))
    assert rows["attention.backward"].count == cell.config["n_layers"] * tr.units
    assert 0.9 * busy <= phases <= busy
