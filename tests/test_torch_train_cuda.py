"""The training path on the card: the kernels' Functions and a train step against the CPU.

The two ``torch.autograd.Function``s on CUDA tensors launch their kernels
(the launch counters move, the plain versions never run) and their
gradients agree with ``torch.autograd`` through the kernels' plain versions
on the card: float32 within 2e-5 and bfloat16 within 2**-6 of each
tensor's largest gradient (``tests/test_torch_train_kernels.py``'s bounds,
which it holds to ``jax.grad``).  One smoke train step on the card agrees
with the same step on the CPU from the same weights (float32, TF32 off)
under :func:`train_step_mismatches`, the contract ``chip_smoke.py`` also
holds the full-width step to: every gradient and moment, and every
parameter element within its own first-step allowance (a CPU test holds
that contract to built records).  The attention backward's kernels
(``csrc/flash_bwd.cuh``) agree with the closed form ``attention_bwd`` within
the bf16 bound at the training cells' shapes (4 x 4096 and 32 x 512, 12
heads over 2, hd 128, causal) and at each zoo family's shape the route sends
to them, give bitwise the same gradients on a second call, and run once a
layer in a full-width qwen2-1.5b step; hd 256 keeps the plain backward.  The
kernels have no CPU mode, so the card tests skip where no card is present;
they import no jax:

    PYTHONPATH=src python -m pytest tests/test_torch_train_cuda.py -m cuda -q
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, apply_updates, cosine_with_warmup  # noqa: E402
from repro_torch.runtime.train import TrainState, _value_and_grad  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GRAD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-6}  # of each tensor's max
# one train step, the card against the CPU (float32 compute, TF32 off)
LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4  # each leaf's gradient and first moment, of the leaf's max
STEP_V_RTOL = 2e-4  # the second moment is quadratic in the gradient
PARAM_TOL = 1e-5  # atol and rtol: parameters after the update (train_step_mismatches)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|`` in float32 (0 where both are zero)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def step_record(state: TrainState, batch: dict, model, optimizer) -> dict:
    """One step's loss, gradients by leaf, and next parameters and moments, on
    the state's device: ``make_train_step``'s body (one microbatch), its
    gradients kept, with what the update read (``old`` parameters, ``lr``)."""
    loss, _, grads = _value_and_grad(model, state.params, batch)
    updates, opt_state, metrics = optimizer.update(grads, state.opt_state, state.params)
    params = apply_updates(state.params, updates)
    return {"loss": loss, "grads": grads, "params": params.leaves(), "m": opt_state.m,
            "v": opt_state.v, "old": state.params.leaves(), "count": opt_state.count,
            "lr": metrics["lr"], "opt": optimizer}


def _adamw_from_moments(rec: dict, path: str) -> torch.Tensor:
    """The parameter AdamW's expressions give from ``rec``'s own moments, on the CPU."""
    opt = rec["opt"]
    p = rec["old"][path].detach().cpu()
    m, v = rec["m"][path].detach().cpu(), rec["v"][path].detach().cpu()
    count = rec["count"].cpu().float()
    c1, c2 = 1.0 - opt.b1 ** count, 1.0 - opt.b2 ** count
    step = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
    if opt.weight_decay and p.dim() >= opt.decay_min_ndim:
        step = step + opt.weight_decay * p.float()
    return (p.float() + -rec["lr"].cpu() * step).to(p.dtype)


def _within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    a, b = got.detach().float().cpu(), want.detach().float().cpu()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def train_step_mismatches(got: dict, want: dict, stats: dict = None) -> list:
    """What disagrees between two first-step records (empty when they agree).

    * the loss within ``LOSS_RTOL``;
    * every leaf's gradient and first moment within ``STEP_GRAD_RTOL`` of the
      leaf's largest, the second moment within ``STEP_V_RTOL``;
    * each side's new parameters equal, within ``PARAM_TOL``, to AdamW's
      expressions over its own moments (recomputed on the CPU);
    * every element of the two sides' new parameters within ``PARAM_TOL``
      (atol and rtol) plus what the disagreement of its gradient allows.
      The first step moves an element by ``lr g / (|g| + eps)`` plus the
      decay (``g`` the clipped gradient, ``m / (1 - b1)``), a map whose
      slope ``eps / (|g| + eps)**2`` is ``1 / eps`` at ``g = 0``.  Two
      gradients ``g1, g2`` of one sign give steps at most ``lr eps |g1 -
      g2| / (min |g| + eps)**2`` apart, of opposite signs ``lr |g1 - g2| /
      eps``.  At full width most of a 151936-row tied embedding's gradient
      lies below ``100 eps`` (each row's share of the softmax is about
      1 / 151936), where float32 rounding of ``g`` alone moves the step
      beyond ``PARAM_TOL``; the allowance is each element's own.

    ``stats``, when given, receives the number of elements beyond
    ``PARAM_TOL`` alone (held by the allowance) and the largest parameter
    difference.
    """
    bad = []
    lw = float(want["loss"])
    if not abs(float(got["loss"]) - lw) <= LOSS_RTOL * abs(lw):
        bad.append(f"loss {float(got['loss'])} vs {lw}")
    for what, tol in (("grads", STEP_GRAD_RTOL), ("m", STEP_GRAD_RTOL), ("v", STEP_V_RTOL)):
        if got[what].keys() != want[what].keys():
            bad.append(f"{what}: leaves differ")
            continue
        for path, w in want[what].items():
            r = relative_error(got[what][path], w)
            if not r <= tol:
                bad.append(f"{what} {path}: {r:.3e} of its max, beyond {tol}")
    if bad:
        return bad
    if int(got["count"]) != 1 or int(want["count"]) != 1:
        return bad + [f"not a first step (counts {int(got['count'])}, {int(want['count'])})"]
    opt, lr = want["opt"], float(want["lr"])
    n_allowed, largest = 0, 0.0
    for path, w in want["params"].items():
        for side, rec in (("got", got), ("want", want)):
            if not _within(rec["params"][path], _adamw_from_moments(rec, path), PARAM_TOL):
                bad.append(f"param {path} ({side}): not AdamW's update of its own moments")
        g1 = got["m"][path].detach().float().cpu() / (1 - opt.b1)
        g2 = want["m"][path].detach().float().cpu() / (1 - opt.b1)
        lo = torch.where(g1 * g2 > 0, torch.minimum(g1.abs(), g2.abs()), torch.zeros_like(g1))
        allowance = lr * opt.eps * (g1 - g2).abs() / (lo + opt.eps) ** 2
        del g1, g2, lo
        a, b = got["params"][path].detach().float().cpu(), w.detach().float().cpu()
        diff, tol = (a - b).abs(), PARAM_TOL + PARAM_TOL * b.abs()
        if not bool((diff <= tol + allowance).all()):
            bad.append(f"param {path}: beyond {PARAM_TOL} and its gradient's allowance")
        n_allowed += int((diff > tol).sum())
        largest = max(largest, float(diff.max()) if diff.numel() else 0.0)
    if stats is not None:
        stats.update(beyond_param_tol=n_allowed, largest_param_diff=largest)
    return bad


def _randn(shape, dtype, seed, dev, requires_grad=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype).requires_grad_(requires_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_function_on_card(dtype, plus_one, card):
    dt = DTYPES[dtype]
    x = _randn((4, 33, 256), dt, 0, card)
    w = _randn((256,), torch.float32, 1, card)
    g = _randn(x.shape, dt, 2, card, requires_grad=False)
    before = rmsnorm.launches
    out = rmsnorm.RMSNormFunction.apply(x, w, 1e-6, plus_one)
    assert rmsnorm.launches == before + 1
    dx, dw = torch.autograd.grad(out, (x, w), g)
    ref = rmsnorm.rms_norm_ref(x, w, 1e-6, plus_one)
    rx, rw = torch.autograd.grad(ref, (x, w), g)
    assert relative_error(out, ref) <= GRAD_RTOL[dt]
    assert relative_error(dx, rx) <= GRAD_RTOL[dt]
    assert relative_error(dw, rw) <= GRAD_RTOL[dt]
    assert rmsnorm.launches == before + 1  # the backward launches no kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kh,causal,window", [(2, True, None), (1, True, 9), (4, False, None)])
def test_attention_function_on_card(dtype, kh, causal, window, card):
    dt = DTYPES[dtype]
    b, s, h, hd = 2, 40, 4, 64
    q, k, v = (_randn((b, s, n, hd), dt, i, card) for i, n in enumerate((h, kh, kh)))
    g = _randn(q.shape, dt, 5, card, requires_grad=False)
    pos = torch.arange(s, dtype=torch.int32, device=card).expand(b, s).contiguous()
    before = (flash.launches, flash.wgmma_launches, flash.simt_launches)
    bwd0 = flash.bwd_launches
    out = flash.AttentionFunction.apply(q, k, v, pos, pos, causal, window, None)
    want_path = 1 if dt == torch.bfloat16 else 2  # wgmma for bf16, CUDA cores for f32
    after = (flash.launches, flash.wgmma_launches, flash.simt_launches)
    assert after[0] == before[0] + 1 and after[want_path] == before[want_path] + 1
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = flash.attention_ref(q, k, v, pos, pos, causal, window)
    plain = torch.autograd.grad(ref, (q, k, v), g)
    assert relative_error(out, ref) <= GRAD_RTOL[dt]
    for name, a, r in zip("qkv", grads, plain):
        assert relative_error(a, r) <= GRAD_RTOL[dt], name
    assert flash.launches == before[0] + 1  # the backward launches no forward kernel
    # bf16 took the wgmma forward, so its backward is the kernels' (one call);
    # float32 keeps the closed form in plain torch
    assert flash.bwd_launches == bwd0 + (dt == torch.bfloat16)


# (name, B, Sq, Sk, H, KH, hd, causal, window): the training cells' shapes, each
# zoo family's attention that the backward kernels take, a window over a ragged
# last tile, and queries at the end of a longer run of keys (a sequence-parallel
# rank's chunk)
BWD_SHAPES = [
    ("qwen2-1.5b-seq4k", 4, 4096, 4096, 12, 2, 128, True, None),
    ("qwen2-1.5b-seq512", 32, 512, 512, 12, 2, 128, True, None),
    ("hubert-xlarge", 2, 1024, 1024, 16, 16, 80, False, None),
    ("qwen2-vl-7b", 1, 1024, 1024, 28, 4, 128, True, None),
    ("qwen3-moe-235b-a22b", 1, 1024, 1024, 64, 4, 128, True, None),
    ("window-ragged", 2, 1000, 1000, 12, 2, 128, True, 300),
    ("continuation", 2, 300, 1000, 12, 2, 128, True, None),
]


def _bwd_inputs(shape, dev, seed=0):
    _, b, sq, sk, h, kh, hd, causal, window = shape
    q = _randn((b, sq, h, hd), torch.bfloat16, seed, dev)
    k, v = (_randn((b, sk, kh, hd), torch.bfloat16, seed + i, dev) for i in (1, 2))
    g = _randn(q.shape, torch.bfloat16, seed + 5, dev, requires_grad=False)
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk).contiguous()
    return q, k, v, g, kpos[:, sk - sq:].contiguous(), kpos, causal, window


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=[s[0] for s in BWD_SHAPES])
def test_attention_backward_kernels_on_card(shape, card):
    """Through ``AttentionFunction``: the wgmma forward writes ``lse`` (the
    rows' log-sum-exp, against the plain version's), the backward takes the
    kernels (one call), its gradients are the closed form's within
    ``GRAD_RTOL`` on the same bf16 inputs and output, and a second call of
    the kernels gives them bitwise."""
    q, k, v, g, qpos, kpos, causal, window = _bwd_inputs(shape, card)
    before = (flash.wgmma_launches, flash.bwd_launches)
    out = flash.AttentionFunction.apply(q, k, v, qpos, kpos, causal, window, None)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (flash.wgmma_launches, flash.bwd_launches) == (before[0] + 1, before[1] + 1)
    qd, kd, vd, od = q.detach(), k.detach(), v.detach(), out.detach()
    again_out, lse = flash.attention_with_lse(qd, kd, vd, qpos, kpos, causal, window)
    assert torch.equal(again_out, od)
    want_lse = flash.attention_lse_ref(qd, kd, qpos, kpos, causal, window)
    assert float((lse - want_lse).abs().max()) <= 1e-3  # float32 sums in another order
    plain = flash.attention_bwd(g, qd, kd, vd, od, qpos, kpos, causal, window)
    for name, a, r in zip(("dq", "dk", "dv"), grads, plain):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert relative_error(a, r) <= GRAD_RTOL[torch.bfloat16], name
    again = flash.attention_backward(g, qd, kd, vd, od, lse, qpos, kpos, causal, window)
    for name, a, r in zip(("dq", "dk", "dv"), again, grads):
        assert torch.equal(a, r), name


@pytest.mark.cuda
def test_attention_backward_kernels_give_rows_that_see_no_key_no_gradient(card):
    """``backward_route``'s precondition pinned: in a sequence whose first
    keys are invalid (``kv_positions`` -1) the first causal queries see no
    key; the kernels give those rows no gradient (dq rows zero), and all
    three gradients are the closed form's with those rows' ``dO`` set to
    zero, within ``GRAD_RTOL``."""
    shape = ("blind-rows", 2, 200, 200, 12, 2, 128, True, None)
    q, k, v, g, qpos, kpos, causal, window = _bwd_inputs(shape, card)
    kpos = kpos.clone()
    kpos[0, :70] = -1  # past the first 64-row tile
    blind = ~flash._visible(qpos, kpos, causal, window).any(dim=-1)
    assert int(blind.sum()) == 70
    out, lse = flash.attention_with_lse(q, k, v, qpos, kpos, causal, window)
    assert flash.backward_route(q, k, v, lse) == "kernels"
    got = flash.attention_backward(g, q, k, v, out, lse, qpos, kpos, causal, window)
    quiet = torch.where(blind[..., None, None], 0.0, g.float()).to(g.dtype)
    want = flash.attention_bwd(quiet, q, k, v, out, qpos, kpos, causal, window)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert relative_error(a, r) <= GRAD_RTOL[torch.bfloat16], name
    assert not bool(got[0][blind].any())


@pytest.mark.cuda
def test_attention_backward_keeps_plain_for_hd256(card):
    """recurrentgemma-2b's hd 256 (window 2048) takes the wgmma forward but not
    the backward kernels: no ``lse`` is asked for and the closed form runs."""
    shape = ("recurrentgemma-2b", 1, 1024, 1024, 10, 1, 256, True, 2048)
    q, k, v, g, pos, _, causal, window = _bwd_inputs(shape, card)
    before = (flash.wgmma_launches, flash.bwd_launches)
    out = flash.AttentionFunction.apply(q, k, v, pos, pos, causal, window, None)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (flash.wgmma_launches, flash.bwd_launches) == (before[0] + 1, before[1])
    plain = flash.attention_bwd(g, q.detach(), k.detach(), v.detach(), out.detach(), pos, pos,
                                causal, window)
    for name, a, r in zip(("dq", "dk", "dv"), grads, plain):
        assert relative_error(a, r) <= GRAD_RTOL[torch.bfloat16], name


@pytest.mark.cuda
def test_qwen2_step_runs_the_backward_kernels_once_a_layer(card):
    """One full-width qwen2-1.5b forward and backward (bf16 compute, ``full``
    remat): 28 calls of the backward kernels, one a layer, beside the 56
    wgmma forwards (the forward and the remat recompute)."""
    cfg = get_config("qwen2-1.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0)).trainable()
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, 512, 2, seed=0)).global_batch(0)
    before = (flash.wgmma_launches, flash.bwd_launches)
    loss, _, grads = _value_and_grad(
        model, params, {k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert flash.bwd_launches - before[1] == cfg.n_layers == 28
    assert flash.wgmma_launches - before[0] == 2 * cfg.n_layers
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(t).all()) for t in grads.values())


@pytest.mark.cuda
def test_smoke_train_step_on_card_matches_cpu(card):
    cfg = get_config("qwen2-1.5b", smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 1, 20))
    params = model.init(torch.Generator().manual_seed(0)).trainable()
    cpu_state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    card_params = copy.deepcopy(params).to(card)
    card_state = TrainState(cpu_state.step.to(card), card_params, opt.init(card_params))
    batch = SyntheticLM(PipelineConfig(cfg.vocab_size, 32, 4, seed=0)).global_batch(0)
    before = (rmsnorm.launches, flash.launches)
    got = step_record(card_state, {k: torch.from_numpy(v).to(card) for k, v in batch.items()},
                      model, opt)
    # one forward and the backward's remat recompute of every block
    assert rmsnorm.launches - before[0] == (2 * cfg.n_layers + 1) + 2 * cfg.n_layers
    assert flash.launches - before[1] == 2 * cfg.n_layers
    want = step_record(cpu_state, {k: torch.from_numpy(v) for k, v in batch.items()}, model, opt)
    assert train_step_mismatches(got, want) == []
    assert np.isfinite(float(got["loss"]))


def test_step_contract_allows_rounding_and_catches_a_moved_element():
    """:func:`train_step_mismatches` on the CPU, from two first-step records
    built with AdamW's expressions: gradients spread over 1e-10 to 1e-2 (many
    near ``eps``, where a step is ill-conditioned) and disagreeing by noise
    at 1e-5 of their largest (within ``STEP_GRAD_RTOL``, signs flipped near
    0) pass; one parameter element moved by 2e-5 where the gradients agree
    exactly fails, and so does a wrong learning rate."""
    opt = AdamW(3e-3)
    gen = torch.Generator().manual_seed(0)

    def record(g, p_old, lr=3e-3):
        rec = {"loss": torch.tensor(1.0), "grads": {"w": g}, "m": {"w": (1 - opt.b1) * g},
               "v": {"w": (1 - opt.b2) * g * g}, "old": {"w": p_old},
               "count": torch.tensor(1), "lr": torch.tensor(lr), "opt": opt, "params": {}}
        rec["params"]["w"] = _adamw_from_moments(rec, "w")
        return rec

    p = torch.randn(400, 100, generator=gen) * 0.02
    g = torch.randn(400, 100, generator=gen) * torch.logspace(-10, -2, 100)
    noisy = g + 1e-5 * float(g.abs().max()) * torch.randn(g.shape, generator=gen)
    noisy[0, 99] = g[0, 99]  # a resolved element with no disagreement
    stats = {}
    assert train_step_mismatches(record(noisy, p), record(g, p), stats) == []
    assert stats["beyond_param_tol"] > 0 and int((g * noisy < 0).sum()) > 0
    moved = record(noisy, p)
    moved["params"]["w"][0, 99] += 2e-5
    assert any("allowance" in m for m in train_step_mismatches(moved, record(g, p)))
    assert train_step_mismatches(record(noisy, p, lr=3.1e-3), record(g, p)) != []
