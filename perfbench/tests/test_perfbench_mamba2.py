"""The Mamba-2 cell on the CPU: a tiny ``train_ssm`` cell, its reference's scan, its faults, its layout.

The tiny cell is ``train.mamba2-2.7b.seq4k``'s own files cut in size: two
layers of width 64, a state of 16, heads of 16, chunks of 8 over rows of 32
(four chunks a row), a vocabulary of 512, 4 rows a step, under limits of its
own (:data:`LIMITS`).  At this size the program's gaps from the reference
read, over seeds 5 to 9, 2**31 + 77 and 2**31 + 99: loss 1.0e-4 to 1.7e-4,
first gradient 2.2e-3 to 5.2e-3, change 2.0e-3 to 1.5e-2.  Over seeds 11 to
13 the float8 control reads loss 1.6e-3 to 2.4e-3, half the batch loss
1.2e-2 to 1.4e-2, and the state not carried between chunks loss 1.0e-3 to
1.6e-3 and first gradient 0.13 to 0.23.
"""
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, mamba2  # noqa: E402

CELL = "train.mamba2-2.7b.seq4k"
SIZE = {"n_layers": 2, "d_model": 64, "ssm_state": 16, "ssm_headdim": 16, "ssm_chunk": 8,
        "vocab_size": 512}
MIX = {"batch": 4, "seq": 32, "block_tokens": 64, "trace_steps": 2}
LIMITS = {"loss_gap": 8e-4, "grad_gap": 2e-2, "change_gap": 4e-2}
SEED = 2**31 + 77


def _cell() -> harness.Cell:
    full = harness.load_cell(CELL)
    return harness.Cell("train_ssm.tiny", 1, {**full.config, **SIZE}, {**full.traffic, **MIX},
                        LIMITS, full.end_to_end, full.per_layer)


def _reference():
    return harness.load_module(harness.HERE / "reference" / "train_ssm.py", "ref_train_ssm")


def _run(seed=SEED, traced=False) -> dict:
    line = json.dumps(harness.run_cell(_cell(), seed, 0.5, traced, torch.device("cpu"),
                                       harness.process_start()))
    return json.loads(line)


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_is_correct(traced):
    result = _run(traced=traced)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if traced:
        assert "train_mfu" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    counters = result["counters"]
    # 32 tokens in chunks of 8 over 2 layers, a forward and a recompute a step
    assert counters["ssm_chunk_steps"] == 4 * 2 * 2
    assert counters["attention_launches"] == 0


@pytest.mark.parametrize("s", [37, 64])
def test_reference_scan_is_the_sequential_recurrence(s):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t^T h_t + D x_t``, float64."""
    ref = _reference()
    g = torch.Generator().manual_seed(s)
    b, h, p, n, chunk = 2, 3, 4, 5, 16
    x = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, s, h, generator=g, dtype=torch.float64) + 0.1
    a = -torch.rand(h, generator=g, dtype=torch.float64) - 0.5
    bm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    cm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    d = torch.randn(h, generator=g, dtype=torch.float64)
    got, final = ref.ssd(x * dt[..., None], dt * a, bm, cm, chunk)
    got = got + d[:, None] * x
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(s):
        state = torch.exp(dt[:, t] * a)[..., None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        want.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]) + d[:, None] * x[:, t])
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(final, state, rtol=1e-12, atol=1e-12)
    cut, _ = ref.ssd(x * dt[..., None], dt * a, bm, cm, chunk, carry=False)
    assert not torch.allclose(cut + d[:, None] * x, got)


def _fails(readings: dict) -> bool:
    return any(not math.isfinite(readings[k]) or readings[k] > v for k, v in LIMITS.items())


@pytest.mark.parametrize("fault", [{"precision": "fp8"}, {"rows": 2}, {"carry": False}],
                         ids=["control_fp8", "half_batch", "state_not_carried"])
def test_reference_side_faults_fail_the_tiny_comparison(fault):
    ref, cell = _reference(), _cell()
    want = ref.follow(cell.config, cell.traffic, 12, 3, "cpu")
    assert _fails(ref.compare(ref.follow(cell.config, cell.traffic, 12, 3, "cpu", **fault), want))


def _unchanged(real):
    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def train_step(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return train_step
    return make_train_step


def _not_carried(real):
    def ssd_chunked(x, dt, a_neg, bmat, cmat, d_skip, chunk, h0=None):
        ys = []
        for lo in range(0, x.shape[1], chunk):
            part = slice(lo, lo + chunk)
            y, h = real(x[:, part], dt[:, part], a_neg, bmat[:, part], cmat[:, part], d_skip,
                        chunk)
            ys.append(y)
        return torch.cat(ys, 1), h
    return ssd_chunked


@pytest.mark.parametrize("fault", ["state_unchanged", "state_not_carried"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.models import ssm
    from repro_torch.runtime import train

    owner, name, breaker = {"state_unchanged": (train, "make_train_step", _unchanged),
                            "state_not_carried": (ssm, "ssd_chunked", _not_carried)}[fault]
    monkeypatch.setattr(owner, name, breaker(getattr(owner, name)))
    result = _run()
    assert result["correct"] is False, result["checks"]


def test_layout_names_the_ports_leaves():
    cell = _cell()
    entry = harness.load_module(harness.HERE / "drivers" / "train_ssm.py", "entry_train_ssm")
    model, _, _ = entry.build(cell.config, cell.traffic, "cpu")
    leaves = model.init(torch.Generator().manual_seed(0)).leaves()
    arch = cell.config
    lay = mamba2.layout(arch)
    assert {name: tuple(shape) for name, shape, *_ in lay} == {
        name: tuple(t.shape) for name, t in leaves.items()}
    assert mamba2.param_count(arch) == sum(t.numel() for t in leaves.values())


def test_initial_weights_repeat_by_seed_and_follow_mamba_ssm():
    lay = mamba2.layout(_cell().config)
    one, again = mamba2.make(lay, 7, "cpu"), mamba2.make(lay, 7, "cpu")
    assert all(torch.equal(one[k], again[k]) for k in one)
    a = torch.exp(one["layers.0.mixer.A_log"])
    dt = torch.nn.functional.softplus(one["layers.1.mixer.dt_bias"])
    assert bool(((a >= 1) & (a <= 16)).all()) and bool(((dt >= 1e-4) & (dt <= 0.1 + 1e-6)).all())
    assert all(v == 0.0 for v in mamba2.change_norms(one, lay, 7).values())
    assert mamba2.change_norms(one, lay, 8)["layers.0.mixer.dt_bias"] > 0
