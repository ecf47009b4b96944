"""The model zoo's families on the card against the CPU, and the kernels at their new shapes.

Each family's smoke model runs on the card (the RMSNorm and attention
kernels) and on the CPU (their plain versions) from one set of weights, in
float32 with TF32 off: logits within 1e-4, prefill and decode against the
card's own teacher-forced forward within 2e-3, and the MoE router's top-k
expert ids equal.  The kernels at the zoo's new shapes: RMSNorm at d 5120
(Mamba-2's gated norm over d_inner, which takes the kernel's scalar path in
bf16) and attention at head_dim 80, non-causal (hubert-xlarge).  Tolerance
as ``tests/test_torch_model_cuda.py``.  The kernels have no CPU mode, so
these tests skip where no card is present; they import no jax:

    PYTHONPATH=src python -m pytest tests/test_torch_zoo_cuda.py -m cuda -q
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import build_model, hybrid, mamba, moe, transformer  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}
FAMILIES = ["dbrx-132b", "qwen3-moe-235b-a22b", "qwen2-vl-7b", "hubert-xlarge",
            "recurrentgemma-2b", "mamba2-2.7b"]
B, S_PRE, S_DEC = 2, 11, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(DTYPES[dtype])


def _close(got, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


def _forward(cfg, params, x):
    if cfg.family == "hybrid":
        return hybrid.forward(params, cfg, x)[0]
    if cfg.family == "ssm":
        return mamba.forward(params, cfg, x)[0]
    key = "embeds" if cfg.family == "encoder" else "tokens"
    return transformer.forward(params, cfg, **{key: x})[0]


def _launches_per_forward(cfg):
    """(RMSNorm, attention) kernel launches of one forward."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1, 0
    rms = 0 if cfg.norm_type == "layer" else 2 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_attn = (cfg.n_layers // len(pat)) * pat.count("attn") \
            + pat[: cfg.n_layers % len(pat)].count("attn")
        return rms, n_attn
    return rms, cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_card_matches_cpu(arch, card):
    overrides = dict(param_dtype="float32", compute_dtype="float32")
    if arch in ("dbrx-132b", "qwen3-moe-235b-a22b"):
        cfg0 = get_config(arch, smoke=True)
        overrides["capacity_factor"] = cfg0.n_experts / cfg0.n_experts_per_tok  # no drops
    cfg = get_config(arch, smoke=True, **overrides)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "encoder":
        x = torch.randn((B, S_PRE + S_DEC, cfg.d_model), generator=gen)
    else:
        x = torch.randint(0, cfg.vocab_size, (B, S_PRE + S_DEC), generator=gen, dtype=torch.int32)
    want = _forward(cfg, params, x)
    params_c = params.to(card)
    rms0, att0 = rmsnorm.launches, flash.launches
    got = _forward(cfg, params_c, x.to(card))
    assert (rmsnorm.launches - rms0, flash.launches - att0) == _launches_per_forward(cfg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    if cfg.family == "encoder":
        return
    logits, cache, t = model.prefill(params_c, {"tokens": x[:, :S_PRE].to(card)}, S_PRE + S_DEC)
    steps = [(logits, got[:, S_PRE - 1])]
    for i in range(S_DEC):
        logits, cache, t = model.decode_step(params_c, cache, x[:, S_PRE + i: S_PRE + i + 1].to(card),
                                             t)
        steps.append((logits, got[:, S_PRE + i]))
    for i, (a, b) in enumerate(steps):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} step {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_moe_routing_on_card_equals_cpu(arch, card):
    cfg = get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg.d_model, cfg.d_ff, cfg.n_experts,
                     torch.float32)
    x = torch.randn((3, 17, cfg.d_model), generator=torch.Generator().manual_seed(3))
    k = cfg.n_experts_per_tok
    ids, w = moe._route(x @ p["router"], k)
    ids_c, w_c = moe._route(x.to(card) @ p["router"].to(card), k)
    np.testing.assert_array_equal(ids_c.cpu().numpy(), ids.numpy())
    np.testing.assert_allclose(w_c.cpu().numpy(), w.numpy(), atol=1e-6, rtol=1e-5)
    capacity = 3
    _, meta = moe._dispatch_rows(x, ids, cfg.n_experts, capacity)
    _, meta_c = moe._dispatch_rows(x.to(card), ids.to(card), cfg.n_experts, capacity)
    for a, b in zip(meta_c, meta):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    pc = {name: t.to(card) for name, t in p.items()}
    got, aux = moe.moe_ffn(pc, x.to(card), k, capacity_factor=1.0)
    want, want_aux = moe.moe_ffn(p, x, k, capacity_factor=1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    # bf16: two runs on the card give the same bits (the combine adds in a fixed order)
    pb = {name: (t if name == "router" else t.bfloat16()) for name, t in pc.items()}
    xb = x.to(card).bfloat16()
    a, _ = moe.moe_ffn(pb, xb, k)
    b, _ = moe.moe_ffn(pb, xb, k)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows", [1, 1024])
def test_rmsnorm_at_d_inner_5120(dtype, rows, card):
    x = _randn((rows, 5120), dtype, card, 30)
    w = _randn((5120,), dtype, card, 31) * 0.1
    before = rmsnorm.launches
    got = rmsnorm.rms_norm_fused(x, w)
    assert rmsnorm.launches == before + 1
    _close(got, rmsnorm.rms_norm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [1024, 70])
def test_attention_head_dim_80_non_causal(dtype, s, card):
    # hubert-xlarge: 16 heads of 80 over 16 kv heads, no mask
    q = _randn((1, s, 16, 80), dtype, card, 32)
    k = _randn((1, s, 16, 80), dtype, card, 33)
    v = _randn((1, s, 16, 80), dtype, card, 34)
    pos = torch.arange(s, dtype=torch.int32, device=card)[None]
    before = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
    got = flash.attention(q, k, v, pos, pos, causal=False)
    after = (flash.splitkv_launches, flash.wgmma_launches, flash.simt_launches)
    want_path = (0, 1, 0) if dtype == "bf16" else (0, 0, 1)
    assert tuple(a - b for a, b in zip(after, before)) == want_path
    _close(got, flash.attention_ref(q, k, v, pos, pos, False, None), dtype)


@pytest.mark.cuda
def test_depth_cut_config_serves_on_card(card, capsys):
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("qwen2-vl-7b", smoke=True, param_dtype="bfloat16"),
                              n_layers=1)
    records = serve.serve(cfg, requests=1, prompt_len=9, gen=2, workers=4, seed=0)
    assert len(records) == 1 and "[plan]" in capsys.readouterr().out
