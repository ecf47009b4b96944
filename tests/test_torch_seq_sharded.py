"""The sequence-sharded decode cache and padded head layouts, one process.

* ``decode_kv_seq_sharded``'s single-device branch (no logical-axes
  context): the true-KV ring's shapes, a prefill and three decode steps
  against the reference's own seq-sharded model on one device (its
  ``_seq_sharded_decode`` fallback), float32, 1e-5; a windowed config keeps
  the plain ring, as the reference's ``init_cache``.
* ``pad_heads_to`` 4 and 8: the port's logits (cache-free forward, prefill
  and decode on the plain ring) against the reference's on the reference's
  weights, float32, 1e-5; and, as the reference's
  ``test_padded_heads_exact_semantics``, noise in the padded query slots of
  ``wq`` leaves the port's loss unchanged.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, convert, transformer  # noqa: E402

B, S_PRE, S_MAX = 4, 12, 16
TOL = 1e-5


def _pair(arch="qwen2-1.5b", **kw):
    kw = dict(smoke=True, param_dtype="float32", compute_dtype="float32", **kw)
    ref = jax_build_model(jax_get_config(arch, **kw))
    port = build_model(get_config(arch, **kw))
    rp = ref.init(jax.random.key(0))
    pp = convert.params_from_jax(jax.tree.map(np.asarray, rp), port.cfg, device="cpu")
    return ref, rp, port, pp


def _tokens(vocab, s=S_MAX, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, s), dtype=np.int32)


def _decode_both(ref, rp, port, pp, toks, steps=3):
    """Prefill then ``steps`` decode steps in both packages -> max |diff| per call."""
    rl, rc, rt = ref.prefill(rp, {"tokens": jnp.asarray(toks[:, :S_PRE])}, max_len=S_MAX)
    with torch.no_grad():
        pl, pc, pt = port.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S_PRE])}, S_MAX)
        diffs = [float(np.abs(np.asarray(rl) - pl.numpy()).max())]
        for i in range(steps):
            tok = toks[:, S_PRE + i:S_PRE + i + 1]
            rl, rc, rt = ref.decode_step(rp, rc, jnp.asarray(tok), rt)
            pl, pc, pt = port.decode_step(pp, pc, torch.from_numpy(tok), pt)
            diffs.append(float(np.abs(np.asarray(rl) - pl.numpy()).max()))
    return diffs, rc, pc


@pytest.mark.parametrize("pad", [0, 4, 8])
def test_seq_sharded_fallback_decode_matches_reference(pad):
    ref, rp, port, pp = _pair(pad_heads_to=pad, decode_kv_seq_sharded=True)
    toks = _tokens(ref.cfg.vocab_size)
    diffs, rc, pc = _decode_both(ref, rp, port, pp, toks)
    assert max(diffs) < TOL, diffs
    # the true-KV ring: TRUE kv heads, no repetition; the reference stacks layers
    layer = pc[0]
    assert sorted(layer) == ["ks", "poss", "vs"]
    assert tuple(layer["ks"].shape) == (B, S_MAX, port.cfg.n_kv_heads, port.cfg.head_dim)
    np.testing.assert_allclose(layer["ks"].numpy(), np.asarray(rc["ks"][0]), atol=TOL)
    assert layer["poss"].tolist() == np.asarray(rc["poss"][0]).tolist()
    assert layer["poss"].tolist() == list(range(S_PRE + 3)) + [-1] * (S_MAX - S_PRE - 3)


def test_seq_sharded_decode_equals_plain_ring_decode():
    """The true-KV ring's decode against the repeated-KV ring's, same weights."""
    _, _, port_s, pp = _pair(pad_heads_to=4, decode_kv_seq_sharded=True)
    port_p = build_model(dataclasses.replace(port_s.cfg, decode_kv_seq_sharded=False))
    toks = torch.from_numpy(_tokens(port_s.cfg.vocab_size))
    with torch.no_grad():
        a, ca, ta = port_s.prefill(pp, {"tokens": toks[:, :S_PRE]}, S_MAX)
        b, cb, tb = port_p.prefill(pp, {"tokens": toks[:, :S_PRE]}, S_MAX)
        assert "k" in cb[0] and "ks" in ca[0]
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
        for i in range(S_MAX - S_PRE):
            tok = toks[:, S_PRE + i:S_PRE + i + 1]
            a, ca, ta = port_s.decode_step(pp, ca, tok, ta)
            b, cb, tb = port_p.decode_step(pp, cb, tok, tb)
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def test_windowed_config_keeps_the_plain_ring():
    cfg = get_config("qwen2-1.5b", smoke=True, decode_kv_seq_sharded=True, window=5)
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    assert sorted(cache[0]) == ["k", "pos", "v"] and cache[0]["k"].shape[1] == 5
    ref = jax_build_model(jax_get_config("qwen2-1.5b", smoke=True, decode_kv_seq_sharded=True,
                                         window=5))
    assert sorted(ref.init_cache({"tokens": jnp.zeros((2, 1), jnp.int32)}, 8)) == \
        ["k", "pos", "v"]


@pytest.mark.parametrize("pad", [4, 8])
def test_padded_heads_match_reference(pad):
    ref, rp, port, pp = _pair(pad_heads_to=pad)
    lo = transformer.HeadLayout.make(port.cfg.n_heads, port.cfg.n_kv_heads, pad)
    assert lo.h_pad % pad == 0 and lo.k_pad % pad == 0
    toks = _tokens(ref.cfg.vocab_size)
    from repro.models import transformer as jax_transformer

    want, _, _ = jax_transformer.forward(rp, ref.cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = transformer.forward(pp, port.cfg, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    diffs, _, _ = _decode_both(ref, rp, port, pp, toks)
    assert max(diffs) < TOL, diffs


@pytest.mark.parametrize("pad", [4, 8])
def test_padded_slots_do_not_change_the_loss(pad):
    """The reference's exact-semantics check on the port: noise in the masked
    query slots of ``wq`` leaves the loss as it was."""
    cfg = get_config("qwen2-1.5b", smoke=True, pad_heads_to=pad)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    lo = transformer.HeadLayout.make(cfg.n_heads, cfg.n_kv_heads, pad)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen),
             "loss_mask": torch.ones(2, 8)}
    with torch.no_grad():
        loss0, _ = model.train_loss(params, batch)
        slot = torch.repeat_interleave(1.0 - lo.head_mask(), cfg.head_dim)[None, :]
        masked = int(lo.h_pad - lo.head_mask().sum())
        noisy = {f"layers.{i}.attn.wq": p["attn"]["wq"] + torch.randn(
            p["attn"]["wq"].shape, generator=gen).to(p["attn"]["wq"].dtype) * slot
            for i, p in enumerate(params["layers"])}
        loss1, _ = model.train_loss(params.replace_leaves(noisy), batch)
    assert masked > 0 or pad == 4
    np.testing.assert_allclose(float(loss0), float(loss1), rtol=1e-6)
