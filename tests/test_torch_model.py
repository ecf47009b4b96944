"""The port's dense decoder against the reference's, on the reference's weights.

The reference's smoke models are initialised with ``jax.random`` and their
weights carried across with ``params_from_jax``; identical numpy tokens then
go through both.  Compute is float32 on both sides, so the comparison holds
the algorithm, not bf16 rounding.  Logits agree to 1e-4 (atol and rtol):
both sides compute in float32, but the matmuls, the softmax and the norms
sum in other orders (XLA's CPU kernels against PyTorch's), and those
differences grow through 2 layers and a 512-way unembedding; logits are
O(1).  The port's own prefill + decode against teacher forcing uses the 2e-3
of ``tests/test_model_numerics.py:280``.  The models run on the CPU, so
every norm and attention is the kernels' plain version.
"""
import dataclasses
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import applicable_shapes as jax_applicable_shapes  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention, rmsnorm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, common, convert, transformer  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2-1.5b", "gemma-7b"]
B, S_PRE, S_DEC = 2, 7, 4


def _pair(arch, **overrides):
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32", **overrides)
    jcfg = jax_get_config(arch, **kw)
    cfg = configs.get_config(arch, **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S_PRE + S_DEC))
    return jcfg, jparams, cfg, params, tokens.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    jcfg, jparams, cfg, params, tokens = _pair(arch)
    want, _, _ = jax_transformer.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, _, _ = transformer.forward(params, cfg, tokens=_t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    max_len = S_PRE + S_DEC
    jl, jcache, jt = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S_PRE])}, max_len)
    tl, cache, t = model.prefill(params, {"tokens": _t(tokens[:, :S_PRE])}, max_len)
    assert t == int(jt) == S_PRE
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(S_DEC):
        tok = tokens[:, S_PRE + i: S_PRE + i + 1]
        jl, jcache, jt = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), jt)
        tl, cache, t = model.decode_step(params, cache, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"{arch} step {i}", **TOL)
    # the caches agree too: the ring buffer's positions exactly, its keys to TOL
    np.testing.assert_array_equal(cache[0]["pos"].numpy(), np.asarray(jcache["pos"][0]))
    np.testing.assert_allclose(cache[1]["k"].numpy(), np.asarray(jcache["k"][1]), **TOL)


def test_windowed_ring_buffer_matches_reference():
    # a window shorter than the prompt: prefill keeps the last W positions and
    # decode wraps the ring (the recurrentgemma field on a dense model).  The
    # reference's prefill attends every prompt query over the ring alone, which
    # is wrong for prompt 7 > window 5 (ROADMAP.md section 3); the port attends
    # over the prompt's own k/v and equals the reference's cache-free forward.
    # The reference's decode reads k/v its faulty prefill wrote into the ring
    # of layer 2 (positions 2..5) until decode has overwritten them: from step
    # W - 2 = 3 on, its decode is right and the port equals it again.
    jcfg, jparams, cfg, params, tokens = _pair("qwen2-1.5b", window=5)
    w = cfg.window
    full, _, _ = jax_transformer.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    full = np.asarray(full)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    max_len = S_PRE + S_DEC
    jl, jcache, jt = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S_PRE])}, max_len)
    tl, cache, t = model.prefill(params, {"tokens": _t(tokens[:, :S_PRE])}, max_len)
    assert cache[0]["k"].shape[1] == w < S_PRE
    np.testing.assert_allclose(tl.numpy(), full[:, S_PRE - 1], **TOL)
    assert np.abs(np.asarray(jl) - full[:, S_PRE - 1]).max() > 1e-2, \
        "the reference's windowed prefill fault is gone: revisit ROADMAP.md section 3"
    for i in range(S_DEC):
        tok = tokens[:, S_PRE + i: S_PRE + i + 1]
        jl, jcache, jt = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), jt)
        tl, cache, t = model.decode_step(params, cache, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), full[:, S_PRE + i], err_msg=f"step {i}", **TOL)
        if i >= w - 2:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
    np.testing.assert_array_equal(cache[1]["pos"].numpy(), np.asarray(jcache["pos"][1]))


def test_windowed_prefill_within_window_equals_reference_prefill():
    # prompt 7 <= window 8: the ring holds the whole prompt and both agree
    jcfg, jparams, cfg, params, tokens = _pair("qwen2-1.5b", window=8)
    jl, _, _ = jax_build_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :S_PRE])}, S_PRE + S_DEC)
    tl, _, _ = build_model(cfg).prefill(params, {"tokens": _t(tokens[:, :S_PRE])}, S_PRE + S_DEC)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    cfg = configs.get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S_PRE + S_DEC),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    full, _, _ = transformer.forward(params, cfg, tokens=tokens)
    logits, cache, t = model.prefill(params, {"tokens": tokens[:, :S_PRE]}, S_PRE + S_DEC)
    np.testing.assert_allclose(logits, full[:, S_PRE - 1], atol=2e-3, rtol=2e-3)
    for i in range(S_DEC):
        logits, cache, t = model.decode_step(params, cache, tokens[:, S_PRE + i: S_PRE + i + 1], t)
        np.testing.assert_allclose(logits, full[:, S_PRE + i], atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_param_counts_match_reference(arch):
    jcfg, jparams, cfg, params, _ = _pair(arch)
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert common.count_params(params) == jax_common.count_params(jparams)
    assert common.count_params(own) == jax_common.count_params(jparams)
    names = sorted(n for n, _ in own.named_parameters())
    assert names == sorted(n for n, _ in params.named_parameters())
    for name, p in own.named_parameters():
        assert p.dtype == torch.float32 and not p.requires_grad, name


def test_bf16_serving_copy_matches_reference_bf16():
    # serving's compute-dtype copy (cast once) against the reference's
    # per-step cast, bf16 compute on both sides.  bf16 rounds at other places
    # in the two frameworks, and every activation of both layers and the
    # logits themselves are bf16 (an ulp is 2**-7 = 0.0078 for |x| in [1, 2)),
    # so the logits are held to 8 such ulps absolute, 3e-2 relative
    kw = dict(smoke=True)
    jcfg, cfg = jax_get_config("qwen2-1.5b", **kw), configs.get_config("qwen2-1.5b", **kw)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    served = build_model(cfg).for_serving(params)
    assert served["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert served["final_norm"].dtype == torch.float32
    assert common.cast_for_compute(served["layers"][0], torch.bfloat16) is served["layers"][0]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 9)).astype(np.int32)
    want, _, _ = jax_transformer.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, _, _ = transformer.forward(served, cfg, tokens=_t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=8 * 2.0**-7, rtol=3e-2)


def test_head_layout_matches_reference():
    for h, kh, pad in [(12, 2, 0), (12, 2, 8), (16, 16, 4), (8, 1, 16), (28, 4, 8)]:
        ref = jax_transformer.HeadLayout.make(h, kh, pad)
        got = transformer.HeadLayout.make(h, kh, pad)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
        np.testing.assert_array_equal(got.head_mask().numpy(), np.asarray(ref.head_mask()))


# where the port's presets depart from the reference's, (arch, smoke) -> the
# port's values: mamba2-2.7b's full preset is the published model (the
# reference's has chunk 128, vocab 50,280, untied embeddings, RMSNorm at 1e-6
# and the residual in the compute dtype)
PORT_PRESETS = {("mamba2-2.7b", False): {"ssm_chunk": 256, "vocab_size": 50288,
                                         "tie_embeddings": True, "norm_eps": 1e-5,
                                         "residual_in_fp32": True}}
# the port's fields that the reference lacks, at their defaults
PORT_FIELDS = {"norm_eps": 1e-6, "residual_in_fp32": False}


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_registry_matches_reference(arch):
    assert configs.ARCH_IDS == JAX_ARCH_IDS
    for smoke in (False, True):
        port = PORT_PRESETS.get((arch, smoke), {})
        got = configs.get_config(arch, smoke=smoke)
        want = dataclasses.replace(jax_get_config(arch, smoke=smoke),
                                   **{k: v for k, v in port.items() if k not in PORT_FIELDS})
        assert dataclasses.asdict(got) == {**dataclasses.asdict(want), **PORT_FIELDS,
                                           **{k: port[k] for k in PORT_FIELDS if k in port}}
        assert got.param_count_estimate() == want.param_count_estimate()
        assert configs.applicable_shapes(arch).keys() == jax_applicable_shapes(arch).keys()
    assert got.dtype("compute") == torch.bfloat16 and got.dtype("param") == torch.float32


def _family_forward(arch, params, jparams, cfg, jcfg, inputs):
    """Both packages' cache-free forward of one family on ``inputs`` (numpy)."""
    from repro.models import hybrid as jax_hybrid
    from repro.models import mamba as jax_mamba
    from repro_torch.models import hybrid, mamba

    if cfg.family == "hybrid":
        return hybrid.forward(params, cfg, _t(inputs))[0], jax_hybrid.forward(
            jparams, jcfg, jnp.asarray(inputs))[0]
    if cfg.family == "ssm":
        return mamba.forward(params, cfg, _t(inputs))[0], jax_mamba.forward(
            jparams, jcfg, jnp.asarray(inputs))[0]
    key = "embeds" if cfg.family == "encoder" else "tokens"
    got = transformer.forward(params, cfg, **{key: _t(inputs)})[0]
    return got, jax_transformer.forward(jparams, jcfg, **{key: jnp.asarray(inputs)})[0]


# the five families refused before the MoE, VLM, encoder, hybrid and SSM port
@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b", "recurrentgemma-2b",
                                  "qwen2-vl-7b", "hubert-xlarge"])
def test_every_family_builds_and_matches_reference(arch):
    jcfg, jparams, cfg, params, tokens = _pair(arch)
    model = build_model(cfg)
    assert model.cfg is cfg
    own = model.init(torch.Generator().manual_seed(0))
    assert common.count_params(own) == common.count_params(params) \
        == jax_common.count_params(jparams)
    if cfg.family == "encoder":
        inputs = np.random.default_rng(2).standard_normal(
            (B, S_PRE, cfg.d_model)).astype(np.float32)
    else:
        inputs = tokens
    got, want = _family_forward(arch, params, jparams, cfg, jcfg, inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_build_model_takes_every_configuration(arch):
    for smoke in (True, False):  # the full configs build their Model (no weights made)
        model = build_model(configs.get_config(arch, smoke=smoke))
        assert model.cfg.name.startswith(arch)
    # the training path is ported: every family's train_loss gives a finite
    # loss and the reference's metric names
    cfg = configs.get_config(arch, smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    key = "embeds" if cfg.family in ("vlm", "encoder") else "tokens"
    inputs = torch.randn(B, S_PRE, cfg.d_model, generator=gen).to(cfg.dtype("compute")) \
        if key == "embeds" else torch.randint(0, cfg.vocab_size, (B, S_PRE), generator=gen)
    batch = {key: inputs, "labels": torch.randint(0, cfg.vocab_size, (B, S_PRE), generator=gen)}
    if cfg.family == "vlm":
        batch["mrope_positions"] = torch.arange(S_PRE, dtype=torch.int32)[None, :, None] \
            .expand(B, S_PRE, 3).contiguous()
    loss, metrics = model.train_loss(model.init(gen), batch)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert set(metrics) == ({"loss"} if cfg.family in ("hybrid", "ssm") else {"loss", "moe_aux"})


def test_unported_paths_raise():
    # the sequence-sharded cache is ported: the true-KV ring (its decode is
    # held to the reference in tests/test_torch_seq_sharded.py)
    cfg = configs.get_config("qwen2-1.5b", smoke=True, decode_kv_seq_sharded=True)
    cache = transformer.init_cache(cfg, 1, 8, device="cpu")
    assert tuple(cache[0]["ks"].shape) == (1, 8, cfg.n_kv_heads, cfg.head_dim)
    assert cache[0]["poss"].tolist() == [-1] * 8
    # MoE blocks are ported: a smoke MoE model initialises
    moe = configs.get_config("dbrx-132b", smoke=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), moe)
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32


def _mrope_grid(b, s, n_text, grid_w):
    """M-RoPE ids of ``n_text`` text tokens then an image of ``grid_w``-wide rows:
    text ids equal on t/h/w; the image's t fixed, h its row, w its column."""
    pos = np.zeros((b, s, 3), dtype=np.int32)
    pos[:, :n_text] = np.arange(n_text)[None, :, None]
    img = np.arange(s - n_text)
    pos[:, n_text:, 0] = n_text
    pos[:, n_text:, 1] = n_text + img // grid_w
    pos[:, n_text:, 2] = n_text + img % grid_w
    return pos


def test_vlm_mrope_image_grid_matches_reference():
    # an image grid after text, so the t, h and w sections rotate by different ids
    jcfg, jparams, cfg, params, tokens = _pair("qwen2-vl-7b")
    s = S_PRE + S_DEC
    pos = _mrope_grid(B, s, 3, 4)
    assert (pos[:, 3:, 0] != pos[:, 3:, 1]).any() and (pos[:, 3:, 1] != pos[:, 3:, 2]).any()
    embeds = np.random.default_rng(4).standard_normal((B, s, cfg.d_model)).astype(np.float32)
    want, _, _ = jax_transformer.forward(jparams, jcfg, embeds=jnp.asarray(embeds),
                                         mrope_positions=jnp.asarray(pos))
    got, _, _ = transformer.forward(params, cfg, embeds=_t(embeds), mrope_positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # prefill over the grid, then text decode (t = h = w = position), both packages
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    batch = {"embeds": embeds[:, :S_PRE], "mrope_positions": pos[:, :S_PRE]}
    jl, jcache, jt = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, s)
    tl, cache, t = model.prefill(params, {k: _t(v) for k, v in batch.items()}, s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(S_DEC):
        tok = tokens[:, S_PRE + i: S_PRE + i + 1]
        jl, jcache, jt = jmodel.decode_step(jparams, jcache, jnp.asarray(tok), jt)
        tl, cache, t = model.decode_step(params, cache, _t(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)


def test_encoder_forward_over_embeds_matches_reference():
    jcfg, jparams, cfg, params, _ = _pair("hubert-xlarge")
    assert not cfg.is_causal and cfg.norm_type == "layer"
    embeds = np.random.default_rng(5).standard_normal((B, 13, cfg.d_model)).astype(np.float32)
    want, _, want_aux = jax_transformer.forward(jparams, jcfg, embeds=jnp.asarray(embeds))
    got, _, aux = transformer.forward(params, cfg, embeds=_t(embeds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(want_aux) == 0.0
    # non-causal: the first frame's output depends on the last frame
    moved = embeds.copy()
    moved[:, -1] = np.random.default_rng(6).standard_normal((B, cfg.d_model))
    got2, _, _ = transformer.forward(params, cfg, embeds=_t(moved))
    assert np.abs(got2[:, 0].numpy() - got[:, 0].numpy()).max() > 1e-4


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hubert-xlarge"])
def test_vlm_and_encoder_decode_match_teacher_forcing(arch):
    cfg = configs.get_config(arch, smoke=True, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.family == "encoder":  # no decode: prefill is the forward's last frame
        embeds = torch.randn((B, S_PRE, cfg.d_model), generator=torch.Generator().manual_seed(1))
        full, _, _ = transformer.forward(params, cfg, embeds=embeds)
        logits, _, t = model.prefill(params, {"embeds": embeds}, S_PRE)
        np.testing.assert_allclose(logits, full[:, -1], atol=2e-3, rtol=2e-3)
        return
    tokens = torch.randint(0, cfg.vocab_size, (B, S_PRE + S_DEC),
                           generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    text = torch.arange(S_PRE + S_DEC, dtype=torch.int32)[None, :, None].expand(B, -1, 3)
    full, _, _ = transformer.forward(params, cfg, tokens=tokens, mrope_positions=text)
    embeds = params["embed"][tokens[:, :S_PRE].long()]
    logits, cache, t = model.prefill(
        params, {"embeds": embeds, "mrope_positions": text[:, :S_PRE].contiguous()},
        S_PRE + S_DEC)
    np.testing.assert_allclose(logits, full[:, S_PRE - 1], atol=2e-3, rtol=2e-3)
    for i in range(S_DEC):
        logits, cache, t = model.decode_step(params, cache, tokens[:, S_PRE + i: S_PRE + i + 1], t)
        np.testing.assert_allclose(logits, full[:, S_PRE + i], atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-vl-7b", "recurrentgemma-2b",
                                  "mamba2-2.7b"])
def test_serve_takes_every_decoder_family(arch, capsys):
    # depth cut as chip_smoke.py cuts it: dataclasses.replace on the config
    cfg = configs.get_config(arch, smoke=True, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, n_layers=2 if arch != "recurrentgemma-2b" else 4)
    rms0, att0 = rmsnorm.launches, flash_attention.launches
    records = serve.serve(cfg, requests=2, prompt_len=5, gen=2, workers=4, device="cpu")
    assert len(records) == 2 and all(total >= pre > 0 for total, pre, _ in records)
    out = capsys.readouterr().out
    assert out.count("request ") == 2 and "[plan]" in out
    assert (rmsnorm.launches, flash_attention.launches) == (rms0, att0)


def test_serve_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_serve_main_runs_and_plans(capsys):
    rms0, att0 = rmsnorm.launches, flash_attention.launches
    assert serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "6", "--gen", "3", "--workers", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("request ") == 3 and "prefill" in out and "ms/token" in out
    assert "[plan]" in out and "the planner picks B=" in out
    # on the CPU the wrappers run their plain versions: no kernel launch
    assert (rmsnorm.launches, flash_attention.launches) == (rms0, att0)


def test_serve_refuses_to_pick_the_cpu_silently():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-1.5b", "--smoke", "--requests", "1"])


def test_serving_path_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.launch.serve, repro_torch.models.convert\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
