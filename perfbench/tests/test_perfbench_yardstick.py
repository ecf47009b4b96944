"""The yardstick against hand-computed shapes: work, bounds, the readers on a made-up trace."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, work  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

QWEN = json.loads((ROOT / "perfbench" / "configs" / "qwen2-1.5b.json").read_text())
MS = 1_000_000  # ns


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "m_" + name)


def test_qwen2_parameters_by_hand():
    per_layer = (1536 * 1536 + 2 * 1536 * 256 + 1536 * 1536  # q, k, v, o
                 + 1536 + 2 * 256                              # q, k, v biases
                 + 3 * 1536 * 8960 + 2 * 1536)                 # gate, up, down, two norms
    assert work.param_count(QWEN) == 151936 * 1536 + 28 * per_layer + 1536 == 1_543_714_304


@pytest.mark.parametrize("batch,seq", [(4, 4096), (32, 512)])
def test_train_flops_by_hand(batch, seq):
    dense = 6 * 1_543_714_304 * batch * seq
    attention = 12 * 128 * 12 * (seq * (seq + 1) // 2) * batch * 28
    assert work.train_flops(QWEN, batch, seq) == pytest.approx(dense + attention, rel=1e-15)


@pytest.mark.parametrize("n, n_cands, cand_sum, reps", [(720, 30, 2418, 32768),
                                                       (20, 6, 42, 400)])
def test_kernel_b_work_by_hand(n, n_cands, cand_sum, reps):
    cands = work.divisors(n)
    assert len(cands) == n_cands and sum(cands) == cand_sum
    ops = 25 * n_cands * reps * n + reps * cand_sum
    assert work.frontier_ops(n, cands, reps) == ops
    bound, which = work.frontier_bound_s(n, cands, reps, 1000)
    assert which == "operations"
    assert bound == pytest.approx(ops / (132 * 128 * 1.98e9))


def test_attention_and_rmsnorm_bounds_by_hand():
    rows = 4 * 4096
    n_bytes = 2 * rows * 12 * 128 * 2 + 2 * rows * 2 * 128 * 2 + 2 * rows * 4
    ops = 4 * 128 * 12 * (4096 * 4097 // 2) * 4
    assert work.attention_fwd_bound_s(QWEN, 4, 4096) == pytest.approx(
        (max(n_bytes / 3.35e12, ops / 989.4e12), "operations"))
    assert work.rmsnorm_fwd_bound_s(QWEN, 4, 4096) == pytest.approx(
        ((2 * rows * 1536 * 2 + 1536 * 2) / 3.35e12, "bytes"))


def _plan_trace():
    device = [("sample_cover_f32_empirical", 0, 1 * MS), ("Memcpy DtoH", 1 * MS, 2 * MS),
              ("sample_cover_f32_empirical", 5 * MS, 6 * MS), ("Memcpy DtoH", 5 * MS, 7 * MS)]
    host = [("perfbench.unit", 0, 4 * MS), ("perfbench.unit", 4 * MS, 8 * MS),
            ("aten::to", 3 * MS, 4 * MS)]
    return Trace(device, host, (0, 8 * MS), 2)


def test_plan_readers_on_a_made_up_trace():
    tr = _plan_trace()
    assert tr.busy_s == pytest.approx(4e-3)  # overlapping copies counted once
    facts = {"n_workers": 720, "n_reps": 32768, "candidates": work.divisors(720),
             "tables": [1000, 1000]}
    assert reader("kernel_b_ms.plan").read(tr, facts) == pytest.approx(1.0)
    assert reader("host_ms.plan").read(tr, facts) == pytest.approx(2.0)
    assert reader("idle_share.plan").read(tr, facts) == pytest.approx(50.0)
    bound = work.frontier_bound_s(720, work.divisors(720), 32768, 1000)[0]
    assert reader("kernel_b_roofline.plan").read(tr, facts) == pytest.approx(
        100 * 2 * bound / 2e-3)
    # the gap 2..5 ms is named by what covers its middle, 3.5 ms: aten::to
    assert tr.idle_gaps() == [["aten::to", pytest.approx(3e-3)],
                              ["perfbench.unit", pytest.approx(1e-3)]]


def test_train_readers_on_a_made_up_trace():
    device = [("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", 0, 4 * MS),
              ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 4 * MS, 5 * MS),
              ("void wgmma_fa::wgmma_kernel<2>(...)", 5 * MS, 6 * MS),
              ("void rmsnorm_kernel<__nv_bfloat16>(...)", 6 * MS, 7 * MS)]
    tr = Trace(device, [("perfbench.unit", 0, 10 * MS)], (0, 10 * MS), 1)
    facts = {"arch": QWEN, "batch": 4, "seq": 4096, "flops_per_step": 1e12}
    assert reader("gemm_ms.train").read(tr, facts) == pytest.approx(4.0)
    assert reader("train_mfu").read(tr, facts) == pytest.approx(100 * 1e12 / 1e-2 / 989.4e12)
    assert reader("attn_fwd_roofline.train").read(tr, facts) == pytest.approx(
        100 * work.attention_fwd_bound_s(QWEN, 4, 4096)[0] / 1e-3)
    assert reader("rmsnorm_roofline.train").read(tr, facts) == pytest.approx(
        100 * work.rmsnorm_fwd_bound_s(QWEN, 4, 4096)[0] / 1e-3)
    assert reader("host_ms.train").read(tr, facts) == pytest.approx(3.0)
    assert reader("idle_share.train").read(tr, facts) == pytest.approx(30.0)


def test_readers_that_find_nothing_return_nothing():
    empty = Trace([], [("perfbench.unit", 0, MS)], (0, MS), 1)
    facts = {"arch": QWEN, "batch": 4, "seq": 4096, "flops_per_step": 1e12,
             "n_workers": 720, "n_reps": 32768, "candidates": [1], "tables": [1]}
    for name in ("kernel_b_ms.plan", "kernel_b_roofline.plan", "host_ms.plan", "idle_share.plan",
                 "gemm_ms.train", "attn_fwd_roofline.train", "rmsnorm_roofline.train",
                 "host_ms.train", "idle_share.train"):
        assert reader(name).read(empty, facts) is None, name
