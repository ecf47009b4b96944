"""The port's spans (``repro_torch.spans``): gated on the profiler, named, nested, harmless.

* With no profiler recording, :func:`span` hands back one shared null context
  and no record is opened on either path (a plan, a train step).
* Under ``torch.profiler.profile`` on the CPU, a plan records ``plan.scenario``,
  ``plan.frontier`` and ``plan.select`` once each, in that order, with
  ``cover.readback`` inside the frontier; a train step records
  ``train.forward``, ``train.backward`` and ``train.optimizer``, one
  ``attention.backward`` a layer and one ``rmsnorm.backward`` a norm, the
  kernels' backwards inside ``train.backward``.  None of them is a user
  annotation, which the profiler would also draw on the device's timeline.
* Every name the package passes to :func:`span` is in :data:`spans.NAMES`, and
  every name there is passed somewhere (read from the sources' syntax trees).
* A plan and a train step are bitwise the same with the profiler on and off.
* On the card (``-m cuda``): a traced plan copies 4 tensors to the card
  (kernel B's scales, geometry, constants and the class's table), each copy
  launched inside ``cover.upload``.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planner import RedundancyPlanner  # noqa: E402
from repro_torch.core.service_time import Empirical, ShiftedExponential  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.runtime.train import init_state, make_train_step  # noqa: E402

SRC = pathlib.Path(spans.__file__).resolve().parent
PLAN = ("plan.scenario", "plan.frontier", "plan.select")
STEP = ("train.forward", "train.backward", "train.optimizer")


def _plan():
    return RedundancyPlanner(12).plan_cluster(ShiftedExponential(1.0, 0.5), n_reps=200, seed=3,
                                              device="cpu")


def _train_setup():
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 5, 20))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             SyntheticLM(PipelineConfig(cfg.vocab_size, 16, 4, seed=0)).global_batch(0).items()}
    return cfg, model, opt, make_train_step(model, opt), batch


def _step():
    cfg, model, opt, step, batch = _train_setup()
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    return step(state, batch)


def _recorded(fn):
    """``fn()``'s result and the program spans it recorded: ``(name, start, end)``
    in the order they began, as the profiler keeps them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in spans.NAMES]
    assert not any(e.is_user_annotation() for e in events)
    return out, sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events),
                       key=lambda r: r[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_gives_the_shared_null_context_and_opens_no_record(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    first = spans.span("plan.select")
    assert first is spans.span("train.forward") and first is spans._OFF
    with first:
        pass
    opened = []
    monkeypatch.setattr(spans, "_record", lambda name: opened.append(name))
    _plan()
    _step()
    assert opened == []


def test_a_span_under_the_profiler_is_a_record_of_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = spans.span("plan.select")
        assert ctx is not spans._OFF
        with ctx:
            torch.ones(2).sum()
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "plan.select"]
    assert not event.is_user_annotation() and event.duration_ns() > 0


def test_a_plan_records_its_three_parts_in_order_with_the_readback_inside():
    _, rec = _recorded(_plan)
    parts = [r for r in rec if r[0] in PLAN]
    assert [r[0] for r in parts] == list(PLAN)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    readback = [r for r in rec if r[0].startswith("cover.")]
    # on the CPU the frontier draws in plain torch: no upload, no launch, one readback
    assert [r[0] for r in readback] == ["cover.readback"]
    assert _inside(readback[0], parts[1])


def test_a_train_step_records_its_phases_and_one_backward_a_kernel_call():
    cfg = get_config("qwen2-1.5b", smoke=True)
    _, rec = _recorded(_step)
    phases = [r for r in rec if r[0] in STEP]
    assert [r[0] for r in phases] == list(STEP)
    attn = [r for r in rec if r[0] == "attention.backward"]
    norms = [r for r in rec if r[0] == "rmsnorm.backward"]
    assert len(attn) == cfg.n_layers
    assert len(norms) == 2 * cfg.n_layers + 1  # two a layer and the final norm
    assert all(_inside(r, phases[1]) for r in attn + norms)


def _span_names(path: pathlib.Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
            (arg,) = node.args
            assert isinstance(arg, ast.Constant), f"{path}: a span's name is a literal"
            names.append(arg.value)
    return names


def test_every_span_name_is_in_names_and_every_name_is_used():
    used = [n for p in sorted(SRC.rglob("*.py")) if p.name != "spans.py" for n in _span_names(p)]
    assert set(used) <= set(spans.NAMES), sorted(set(used) - set(spans.NAMES))
    assert set(spans.NAMES) <= set(used), sorted(set(spans.NAMES) - set(used))
    assert len(spans.NAMES) == len(set(spans.NAMES))


def test_a_plan_is_bitwise_the_same_under_the_profiler():
    plain = _plan()
    traced, _ = _recorded(_plan)
    assert traced.n_batches == plain.n_batches
    np.testing.assert_array_equal(np.asarray(traced.frontier_mean), np.asarray(plain.frontier_mean))
    np.testing.assert_array_equal(np.asarray(traced.frontier_cov), np.asarray(plain.frontier_cov))


def test_a_train_step_is_bitwise_the_same_under_the_profiler():
    plain_state, plain_metrics = _step()
    (state, metrics), _ = _recorded(_step)
    for k, v in plain_metrics.items():
        assert torch.equal(metrics[k], v), k
    got, want = state.params.leaves(), plain_state.params.leaves()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in plain_state.opt_state.m:
        assert torch.equal(state.opt_state.m[k], plain_state.opt_state.m[k]), k
        assert torch.equal(state.opt_state.v[k], plain_state.opt_state.v[k]), k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel B's wrapper copies to the card only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_obs", [400, 1200])
def test_a_plan_copies_four_arguments_to_the_card_inside_its_upload_span(card, n_obs):
    obs = tuple(float(x) for x in np.random.default_rng(n_obs).exponential(size=n_obs) + 1.0)
    planner = RedundancyPlanner(20)
    planner.plan_cluster(Empirical(obs), n_reps=400, seed=1, device=card)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in range(3):
            planner.plan_cluster(Empirical(obs), n_reps=400, seed=seed, device=card)
    events = list(prof.profiler.kineto_results.events())
    on_card = torch.autograd.DeviceType.CUDA
    copies = [e for e in events
              if e.device_type() == on_card and e.name().startswith("Memcpy HtoD")]
    assert len(copies) == 3 * 4
    began = {e.correlation_id(): e.start_ns() for e in events
             if e.device_type() != on_card and e.name().startswith("cudaMemcpy")}
    upload = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name() == "cover.upload"]
    assert len(upload) == 3
    for copy in copies:
        t = began[copy.correlation_id()]
        assert any(a <= t < b for a, b in upload)
