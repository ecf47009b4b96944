"""The norms' epsilon, Mamba-2's published preset, and the SSD scan's spans and counter.

* ``ArchConfig.norm_eps`` left at its default gives the qwen2 smoke model a
  loss and gradients bitwise those of an explicit 1e-6 (the kernels' own
  default, so every model but mamba2 is as it was).
* ``get_config("mamba2-2.7b")`` is the published model: chunk 256, the
  vocabulary 50,277 padded to 50,288, tied embeddings, epsilon 1e-5, the
  residual in float32.
* With ``residual_in_fp32`` the residual stream is float32 at a bfloat16
  compute dtype (every layer's input and the final norm's), and a float32
  model is bitwise the same with or without it; the causal conv sums in
  float32 and rounds once to the compute dtype, and its checkpoint changes
  no gradient; the gated norm (``ssm._GatedNorm``) gives the float32 gate's
  RMSNorm and autograd's gradients of it, keeping only its bf16 inputs.
* The mamba2 smoke model at epsilon 1e-5 gives a plain float32 computation's
  logits (norms, conv, the sequential recurrence, the gated norm written out
  here) within 1e-4; its hidden states are scaled to a mean square near
  1e-6, where 1e-5 and 1e-6 give different outputs, so the test sees
  whether the epsilon reaches every norm.
* ``ssm.ssd_scan`` (the scan between its span Functions) gives
  ``ssd_chunked``'s values and gradients bitwise, alone and in a remat
  training step; a traced CPU step opens ``ssd.forward`` once a layer a pass
  (forward and recompute) and ``ssd.backward`` once a layer, inside
  ``train.backward``; ``chunk_steps`` counts the chunks walked.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model, mamba, ssm  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.runtime.train import init_state, make_train_step  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _batch(cfg, seq=16, rows=4):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            SyntheticLM(PipelineConfig(cfg.vocab_size, seq, rows, seed=0)).global_batch(0).items()}


def _loss_and_grads(cfg):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0)).trainable()
    loss, _ = model.train_loss(params, _batch(cfg))
    leaves = params.leaves()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads))


def test_default_norm_eps_is_bitwise_the_explicit_one():
    default = get_config("qwen2-1.5b", smoke=True)
    assert default.norm_eps == 1e-6
    loss, grads = _loss_and_grads(default)
    loss2, grads2 = _loss_and_grads(dataclasses.replace(default, norm_eps=1e-6))
    assert torch.equal(loss, loss2)
    assert grads.keys() == grads2.keys()
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_mamba2_preset_is_the_published_model():
    cfg = get_config("mamba2-2.7b")
    assert (cfg.ssm_chunk, cfg.vocab_size, cfg.tie_embeddings, cfg.norm_eps,
            cfg.residual_in_fp32) == (256, 50288, True, 1e-5, True)
    assert cfg.vocab_size == -(-50277 // 16) * 16
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_expand,
            cfg.ssm_conv) == (64, 2560, 128, 64, 2, 4)


@pytest.mark.parametrize("fp32", [False, True])
def test_residual_in_fp32_keeps_the_stream_in_float32(monkeypatch, fp32):
    cfg = get_config("mamba2-2.7b", smoke=True, remat=False, residual_in_fp32=fp32)
    assert cfg.dtype("compute") == torch.bfloat16
    params = build_model(cfg).init(torch.Generator().manual_seed(0)).trainable()
    seen = []
    layer_fn = mamba._layer_fn

    def spy(x, *a, **k):
        out = layer_fn(x, *a, **k)
        seen.append((x.dtype, out.dtype))
        return out

    monkeypatch.setattr(mamba, "_layer_fn", spy)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 11)))
    loss, _ = mamba.train_loss(params, cfg, {"tokens": tokens, "labels": tokens,
                                             "loss_mask": torch.ones(tokens.shape)})
    want = torch.float32 if fp32 else torch.bfloat16
    assert seen == [(want, want)] * cfg.n_layers
    grads = torch.autograd.grad(loss, [params["embed"], params["layers"][0]["norm1"]])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_residual_in_fp32_is_bitwise_nothing_in_a_float32_model():
    cfg = get_config("mamba2-2.7b", smoke=True, remat=False, **F32)
    loss, grads = _loss_and_grads(cfg)
    loss2, grads2 = _loss_and_grads(dataclasses.replace(cfg, residual_in_fp32=True))
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_causal_conv_sums_in_float32_and_rounds_once():
    g = torch.Generator().manual_seed(1)
    x, w, b = (torch.randn(shape, generator=g).to(torch.bfloat16)
               for shape in ((2, 9, 6), (4, 6), (6,)))
    got, tail = ssm._causal_conv(x, w, b)
    xp = F.pad(x.float(), (0, 0, 3, 0))
    want = F.silu(sum(xp[:, i: i + 9] * w[i].float() for i in range(4)) + b.float())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(tail, x[:, -3:])


def test_causal_conv_checkpoint_changes_no_gradient():
    g = torch.Generator().manual_seed(2)
    ins = [torch.randn(shape, generator=g).to(torch.bfloat16).requires_grad_()
           for shape in ((2, 9, 6), (4, 6), (6,))]
    got = torch.autograd.grad(ssm._causal_conv(*ins)[0].float().square().sum(), ins)
    want = torch.autograd.grad(ssm._conv_f32(*ins, None)[0].float().square().sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gated_norm_is_the_float32_gates_rmsnorm():
    g = torch.Generator().manual_seed(3)
    y, z = (torch.randn(3, 5, 16, generator=g).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    w = (1 + 0.1 * torch.randn(16, generator=g)).to(torch.bfloat16).requires_grad_()
    got = ssm._GatedNorm.apply(y, z, w, 1e-5, ssm.tp.SINGLE)
    yf, zf, wf = (t.detach().float().requires_grad_() for t in (y, z, w))
    want = _plain_rms(yf * F.silu(zf), wf, 1e-5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    gout = torch.randn(3, 5, 16, generator=g).to(torch.bfloat16)
    grads = torch.autograd.grad(got, (y, z, w), gout)
    wants = torch.autograd.grad(want, (yf, zf, wf), gout.float())
    for a, b in zip(grads, wants):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.to(torch.bfloat16).float().numpy(),
                                   rtol=8e-3, atol=1e-3)


def _plain_rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _plain_forward(params, cfg, tokens, eps):
    """The mamba2 forward in float32, written out: pre-norm blocks, the mixer
    with its causal convs, the sequential recurrence, the gated norm."""
    dims = ssm.SSMDims.from_config(cfg)
    x = params["embed"][tokens.long()]
    for p in params["layers"]:
        m = p["mixer"]
        u = _plain_rms(x, p["norm1"], eps)
        b, s, _ = u.shape

        def conv(v, w, bias):
            k = w.shape[0]
            vp = F.pad(v, (0, 0, k - 1, 0))
            return F.silu(sum(vp[:, i: i + s] * w[i] for i in range(k)) + bias)

        z = u @ m["w_z"]
        xr = conv(u @ m["w_x"], m["conv_x"], m["conv_x_b"]).reshape(b, s, dims.n_heads, -1)
        bm, cm = conv(u @ m["w_bc"], m["conv_bc"], m["conv_bc_b"]).chunk(2, -1)
        dt = F.softplus(u @ m["w_dt"] + m["dt_bias"])
        a = -torch.exp(m["A_log"])
        h = torch.zeros(b, dims.n_heads, dims.d_state, dims.headdim)
        ys = []
        for t in range(s):
            h = torch.exp(dt[:, t] * a)[..., None, None] * h + torch.einsum(
                "bn,bh,bhp->bhnp", bm[:, t], dt[:, t], xr[:, t])
            ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], h) + m["D"][:, None] * xr[:, t])
        y = torch.stack(ys, 1).reshape(b, s, -1)
        x = x + _plain_rms(y * F.silu(z), m["norm_w"], eps) @ m["out_proj"]
    x = _plain_rms(x, params["final_norm"], eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def test_mamba2_smoke_at_its_epsilon_matches_a_plain_float32_forward():
    cfg = get_config("mamba2-2.7b", smoke=True, norm_eps=1e-5, remat=False, **F32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        params["embed"].mul_(1e-3)  # the residual's mean square near 1e-6
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 11)))
    with torch.no_grad():
        got, _ = mamba.forward(params, cfg, tokens)
        want = _plain_forward(params, cfg, tokens, 1e-5)
        other = _plain_forward(params, cfg, tokens, 1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    assert float((want - other).abs().max()) > 100 * float((got - want).abs().max())


def _scan_inputs(seed=0, b=2, s=19, h=3, p=4, n=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, p, generator=g).requires_grad_(),
            torch.rand(b, s, h, generator=g).requires_grad_(),
            (-torch.rand(h, generator=g)).requires_grad_(),
            torch.randn(b, s, n, generator=g).requires_grad_(),
            torch.randn(b, s, n, generator=g).requires_grad_(),
            torch.randn(h, generator=g).requires_grad_())


@pytest.mark.parametrize("want_state", [False, True])
def test_ssd_scan_is_bitwise_ssd_chunked(want_state):
    ins = _scan_inputs()
    y, h = ssm.ssd_chunked(*ins, 8)
    want = torch.autograd.grad((y.square().sum() + (h.sum() if want_state else 0)), ins)
    out = ssm.ssd_scan(*ins, 8, want_state=want_state)
    y2, h2 = out if want_state else (out, h)
    got = torch.autograd.grad((y2.square().sum() + (h2.sum() if want_state else 0)), ins)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _smoke_step():
    cfg = get_config("mamba2-2.7b", smoke=True, remat=True)
    model = build_model(cfg)
    opt = AdamW(cosine_with_warmup(3e-3, 5, 20))
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    return cfg, make_train_step(model, opt), state


def test_remat_step_through_the_spans_is_bitwise_the_plain_scan(monkeypatch):
    cfg, step, state = _smoke_step()
    new, metrics = step(state, _batch(cfg))

    calls = []

    def plain(x, dt, a_neg, bmat, cmat, d_skip, chunk, h0=None, want_state=False):
        calls.append(chunk)
        y, h = ssm.ssd_chunked(x, dt, a_neg, bmat, cmat, d_skip, chunk, h0)
        return (y, h) if want_state else y

    monkeypatch.setattr(ssm, "ssd_scan", plain)
    cfg, step, state = _smoke_step()
    new2, metrics2 = step(state, _batch(cfg))
    assert len(calls) == 2 * cfg.n_layers  # the forward's and the recompute's
    assert torch.equal(metrics["loss"], metrics2["loss"])
    a, b = new.params.leaves(), new2.params.leaves()
    assert all(torch.equal(a[k], b[k]) for k in a)
    m, m2 = new.opt_state.m, new2.opt_state.m
    assert all(torch.equal(m[k], m2[k]) for k in m)


def test_a_traced_step_opens_the_ssd_spans_once_a_layer_a_pass():
    cfg, step, state = _smoke_step()
    batch = _batch(cfg)
    before = ssm.chunk_steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    walked = ssm.chunk_steps - before
    events = [e for e in prof.events() if e.name.startswith(("ssd.", "train."))]
    count = {name: sum(e.name == name for e in events) for name in
             ("ssd.forward", "ssd.backward", "train.backward")}
    assert count == {"ssd.forward": 2 * cfg.n_layers, "ssd.backward": cfg.n_layers,
                     "train.backward": 1}
    (bwd,) = [e for e in events if e.name == "train.backward"]
    for e in events:
        if e.name == "ssd.backward":
            assert bwd.time_range.start <= e.time_range.start <= e.time_range.end <= \
                bwd.time_range.end
    # 16 tokens in chunks of 8: two chunks a scan, a forward and a recompute a layer
    assert walked == 2 * 2 * cfg.n_layers
