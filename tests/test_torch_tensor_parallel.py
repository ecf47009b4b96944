"""Tensor-parallel compute over "model" against the plain path and the reference.

Every model rank of a TP group runs as a thread of this process
(``tests/torch_tp_threads.py``: the group's collectives are a barrier and a
sum in rank order), each on its shards of the same seeded numpy inputs as
the rules (``distributed/sharding.py``) give them over ``{"model": TP}``.
The group's output is held against the port's plain (TP 1) path and against
the reference's function on the same inputs, within 1e-5 in float32; each
whole gradient is assembled from the ranks' shards and held against the
plain path's.  Covered: attention (unpadded and padded ``HeadLayout``,
prefill and decode on the ring), the gated and plain MLPs, the
vocab-parallel embedding and cross-entropy (padded vocabulary, z-loss), the
expert-parallel MoE, the conjugate autograd functions, the partial
gradients of ``wk`` / ``wv`` / ``bk`` / ``bv``, whole models of the
transformer families, and the MoE aux loss over batch shards (capacity per
row).  The gloo-rank cases of the mesh steps are in
``tests/test_torch_distributed_multidev.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.models import build_model, moe, transformer  # noqa: E402
from repro_torch.models.common import Params, cross_entropy_loss  # noqa: E402
from repro_torch.models.layers import gated_mlp, mlp  # noqa: E402
from repro_torch.runtime.train import _value_and_grad  # noqa: E402
from torch_tp_threads import assemble, rank_params, run_ranks, sharded_dims  # noqa: E402

TOL = 1e-5
KW = dict(smoke=True, param_dtype="float32", compute_dtype="float32")


def _draw(seed: int, shapes: dict, scale: float = 0.2) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def _np64(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)


def _close(got, want, what: str, tol: float = TOL) -> None:
    np.testing.assert_allclose(_np64(got), _np64(want),
                               rtol=tol, atol=tol, err_msg=what)


def _tp_vs_plain(size: int, leaves: dict, inputs: dict, fn):
    """``fn(params, inputs)`` -> (output, scalar loss) on the plain path and on
    ``size`` thread ranks (each on its shards of ``leaves``, which require
    grad, as do ``inputs``).  Returns (plain output, plain grads, per-rank
    outputs, assembled grads) with grads by name (``inputs`` under ``in.``)."""

    def run(params, xs):
        out, loss = fn(params, xs)
        names = list(params.leaves()) + [f"in.{k}" for k in xs]
        grads = torch.autograd.grad(loss, list(params.leaves().values()) + list(xs.values()))
        return out.detach(), dict(zip(names, grads))

    whole = Params({k: torch.from_numpy(v) for k, v in leaves.items()})
    xs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    plain = run(whole.map_leaves(lambda _, t: t.clone().requires_grad_(True)),
                {k: v.clone().requires_grad_(True) for k, v in xs.items()})

    def rank(r, group):
        return run(rank_params(whole, size, r, trainable=True),
                   {k: v.clone().requires_grad_(True) for k, v in xs.items()})

    outs = run_ranks(size, rank)
    return plain[0], plain[1], [o[0] for o in outs], assemble(
        [o[1] for o in outs], sharded_dims(whole.leaves(), size))


def _hold(plain_out, plain_grads, outs, grads, ref=None, what=""):
    for r, out in enumerate(outs):
        _close(out, plain_out, f"{what} rank {r} output")
    if ref is not None:
        _close(outs[0], ref, f"{what} against the reference")
    assert set(grads) == set(plain_grads)
    for k, g in plain_grads.items():
        _close(grads[k], g, f"{what} gradient of {k}")


# ---------------------------------------------------------------------------
# the conjugate functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_conjugate_functions_and_their_gradients(size):
    """enter: identity forward, the ranks' gradients summed; leave: the sum
    forward, the gradient passed through; gather / scatter: the whole dim
    from its shards and back, each the other's transpose."""
    x = torch.arange(12.0).reshape(3, 4)

    def rank(r, group):
        xs = [x.clone().requires_grad_(True) for _ in range(4)]
        a = tp.enter(xs[0], group)
        b = tp.leave(xs[1] * (r + 1), group)
        c = tp.gather(xs[2][:, group.part(4)], group, -1)
        d = tp.scatter(xs[3], group, -1)
        loss = (a * (r + 1)).sum() + (b * b).sum() + (c * (r + 1)).sum() + (d * d).sum()
        grads = torch.autograd.grad(loss, xs)
        return a.detach(), b.detach(), c.detach(), d.detach(), grads

    outs = run_ranks(size, rank)
    tri = size * (size + 1) / 2
    for r, (a, b, c, d, (ga, gb, gc, gd)) in enumerate(outs):
        assert torch.equal(a, x) and torch.equal(b, x * tri) and torch.equal(c, x)
        assert torch.equal(d, x[:, _Rank(size, r).part(4)])
        assert torch.equal(ga, torch.full_like(x, tri))  # the sum of every rank's 1, 2, ...
        assert torch.equal(gb, 2 * x * tri * (r + 1))  # identity backward of leave
        want_c = torch.zeros_like(x)
        want_c[:, _Rank(size, r).part(4)] = r + 1  # this rank's slice of its own gradient
        assert torch.equal(gc, want_c)
        assert torch.equal(gd, torch.cat([2 * x[:, _Rank(size, q).part(4)]
                                          for q in range(size)], dim=-1))


class _Rank(tp.Group):
    def __init__(self, size, rank):
        self.size, self.rank = size, rank


def test_single_group_runs_no_collective():
    x = torch.ones(3, requires_grad=True)
    assert tp.enter(x, tp.SINGLE) is x and tp.leave(x, tp.SINGLE) is x
    assert tp.gather(x, tp.SINGLE, 0) is x and tp.scatter(x, tp.SINGLE, 0) is x
    assert tp.model_group() is tp.SINGLE and tp.batch_group() is tp.SINGLE


# ---------------------------------------------------------------------------
# attention, the MLPs, the vocabulary, the experts
# ---------------------------------------------------------------------------


def _attention_leaves(cfg, layout, seed):
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, layout.h_pad * hd), "wk": (d, layout.n_kv * hd),
              "wv": (d, layout.n_kv * hd), "wo": (layout.h_pad * hd, d),
              "bq": (layout.h_pad * hd,), "bk": (layout.n_kv * hd,), "bv": (layout.n_kv * hd,)}
    return _draw(seed, shapes)


@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("size", [2, 4])
def test_attention_head_parallel(size, pad):
    """qwen2 smoke (12 -> 4 query heads over 2 KV heads, qkv bias): at TP 4
    unpadded each rank has one query slot over a whole ring (2 KV heads do
    not split 4 ways); padded to 4 (K_pad 4) each has one slot over its own
    ring head."""
    cfg = get_config("qwen2-1.5b", pad_heads_to=pad, **KW)
    layout = transformer._layout(cfg)
    leaves = _attention_leaves(cfg, layout, 1)
    b, s = 2, 7
    x = _draw(2, {"x": (b, s, cfg.d_model)}, 1.0)
    probe = torch.from_numpy(_draw(3, {"p": (b, s, cfg.d_model)}, 1.0)["p"])
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)

    def fn(p, xs):
        out, _ = transformer.attention_apply(p, cfg, layout, xs["x"], pos)
        return out, (out * probe).sum()

    res = _tp_vs_plain(size, leaves, x, fn)
    jcfg = jax_get_config("qwen2-1.5b", pad_heads_to=pad, **KW)
    ref, _ = jax_transformer.attention_apply(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jcfg,
        jax_transformer.HeadLayout.make(jcfg.n_heads, jcfg.n_kv_heads, pad),
        jnp.asarray(x["x"]), jnp.asarray(pos.numpy()))
    _hold(*res, ref=np.asarray(ref), what="attention")


def test_attention_slots_split_unevenly_over_kv_heads():
    """12 query heads over 4 KV heads (3 a group) at TP 3: rank 0's four slots
    read KV head 0 three times and KV head 1 once, so each slot gets its own
    copy of its head."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", **KW), n_heads=12, n_kv_heads=4,
                              head_dim=16)
    layout = transformer._layout(cfg)
    leaves = _attention_leaves(cfg, layout, 19)
    x = _draw(20, {"x": (2, 5, cfg.d_model)}, 1.0)
    probe = torch.from_numpy(_draw(21, {"p": (2, 5, cfg.d_model)}, 1.0)["p"])
    pos = torch.arange(5, dtype=torch.int32).repeat(2, 1)

    def fn(p, xs):
        out, _ = transformer.attention_apply(p, cfg, layout, xs["x"], pos)
        return out, (out * probe).sum()

    _hold(*_tp_vs_plain(3, leaves, x, fn), what="attention at TP 3")


@pytest.mark.parametrize("pad,size", [(0, 2), (0, 4), (4, 4)])
def test_attention_prefill_and_decode_on_the_ring(size, pad):
    """A prefill and two decode steps on the ring cache: a rank's ring holds its
    K_pad / TP heads where the axis divides K_pad, else every head."""
    cfg = get_config("qwen2-1.5b", pad_heads_to=pad, **KW)
    layout = transformer._layout(cfg)
    whole = Params({k: torch.from_numpy(v) for k, v in _attention_leaves(cfg, layout, 4).items()})
    x = torch.from_numpy(_draw(5, {"x": (2, 9, cfg.d_model)}, 1.0)["x"])

    def serve(params):
        cache = transformer.kv_cache(cfg, 2, 12, "cpu")
        pos = torch.arange(7, dtype=torch.int32).repeat(2, 1)
        outs = [transformer.attention_apply(params, cfg, layout, x[:, :7], pos, cache=cache)[0]]
        for t in (7, 8):
            pos = torch.full((2, 1), t, dtype=torch.int32)
            outs.append(transformer.attention_apply(params, cfg, layout, x[:, t:t + 1], pos,
                                                    cache=cache)[0])
        return outs, tuple(cache["k"].shape)

    with torch.no_grad():
        want, whole_shape = serve(whole)
        got = run_ranks(size, lambda r, g: serve(rank_params(whole, size, r)))
    heads = layout.k_pad // size if layout.k_pad % size == 0 else layout.k_pad
    for r, (outs, shape) in enumerate(got):
        assert shape == whole_shape[:2] + (heads,) + whole_shape[3:], (r, shape)
        for i, (a, b) in enumerate(zip(outs, want)):
            _close(a, b, f"rank {r} call {i}")


@pytest.mark.parametrize("size", [2, 4])
def test_partial_gradients_of_the_replicated_kv_leaves(size):
    """``wk`` / ``wv`` / ``bk`` / ``bv`` are whole on every rank but feed only
    the rank's KV heads: each rank's gradient is partial (zero outside the
    columns of the heads its slots read), and the sum over the group, taken
    before AdamW, is the whole gradient on every rank."""
    cfg = get_config("qwen2-1.5b", pad_heads_to=4, **KW)  # 4 query slots over 4 repeated heads
    layout = transformer._layout(cfg)
    leaves = _attention_leaves(cfg, layout, 6)
    whole = Params({k: torch.from_numpy(v) for k, v in leaves.items()})
    x = torch.from_numpy(_draw(7, {"x": (2, 5, cfg.d_model)}, 1.0)["x"])
    pos = torch.arange(5, dtype=torch.int32).repeat(2, 1)
    probe = torch.from_numpy(_draw(8, {"p": (2, 5, cfg.d_model)}, 1.0)["p"])
    kv = ("wk", "wv", "bk", "bv")

    def grads(params, group=None):
        if group is not None:
            group.keep_summed = True
        out, _ = transformer.attention_apply(params, cfg, layout, x, pos)
        ps = [params[k] for k in kv]
        return dict(zip(kv, torch.autograd.grad((out * probe).sum(), ps))), group

    want, _ = grads(whole.map_leaves(lambda _, t: t.clone().requires_grad_(True)))
    outs = run_ranks(size, lambda r, g: grads(rank_params(whole, size, r, trainable=True), g))
    hd, r_rep = cfg.head_dim, layout.repeat
    for r, (got, _) in enumerate(outs):
        for k in kv:
            _close(got[k], want[k], f"rank {r} {k}")
    # what each rank gave the group's sums, in the same order on every rank: a
    # leaf's partials are the one position whose sum over the ranks is its gradient
    summed = [group.summed for _, group in outs]
    for k in kv:
        pos = [i for i, t in enumerate(summed[0]) if t.shape == want[k].shape
               and torch.allclose(sum(s[i] for s in summed), want[k], rtol=TOL, atol=TOL)]
        assert len(pos) == 1, (k, pos)
        parts = [s[pos[0]] for s in summed]
        assert not all(torch.equal(p, parts[0]) for p in parts[1:]), k
        for r, part in enumerate(parts):
            heads = range(r * layout.k_pad // size, (r + 1) * layout.k_pad // size)
            outside = torch.ones(want[k].shape[-1], dtype=torch.bool)
            for t in {h // r_rep for h in heads}:
                outside[t * hd:(t + 1) * hd] = False
            assert torch.all(part[..., outside] == 0), (k, r)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_column_row_parallel(size, gated):
    d, f = 16, 24
    if gated:
        shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    else:
        shapes = {"w_in": (d, f), "b_in": (f,), "w_out": (f, d), "b_out": (d,)}
    leaves = _draw(8, shapes)
    x = _draw(9, {"x": (2, 5, d)}, 1.0)
    layer, jlayer = (gated_mlp, jax_layers.gated_mlp) if gated else (mlp, jax_layers.mlp)
    act = "silu" if gated else "gelu"

    def fn(p, xs):
        out = layer(p, xs["x"], act, tp.model_group())
        return out, (out * out).sum()

    res = _tp_vs_plain(size, leaves, x, fn)
    ref = jlayer({k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x["x"]), act)
    _hold(*res, ref=np.asarray(ref), what="gated mlp" if gated else "mlp")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_vocab_parallel_cross_entropy(size, z_loss):
    """Columns 500 to 511 are padding (masked by their global index); the
    max, exp-sum and label logit are taken over the group."""
    v, real = 512, 500
    rng = np.random.default_rng(10)
    logits = (rng.standard_normal((2, 6, v)) * 3).astype(np.float32)
    labels = rng.integers(0, real, (2, 6))
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)

    def loss_of(x, group):
        return cross_entropy_loss(x, lt, mt, real_vocab=real, z_loss=z_loss, group=group,
                                  vocab_offset=group.rank * x.shape[-1])

    whole = torch.from_numpy(logits).requires_grad_(True)
    want = loss_of(whole, tp.SINGLE)
    (g_want,) = torch.autograd.grad(want, whole)

    def rank(r, group):
        x = torch.from_numpy(logits[..., group.part(v)]).requires_grad_(True)
        loss = loss_of(x, group)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    outs = run_ranks(size, rank)
    ref = jax_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(mask), real_vocab=real, z_loss=z_loss)
    for loss, _ in outs:
        _close(loss, want, "loss")
        _close(loss, float(ref), "loss against the reference")
    _close(torch.cat([g for _, g in outs], dim=-1), g_want, "gradient")


@pytest.mark.parametrize("size", [2, 4])
def test_vocab_parallel_embedding(size):
    """The lookup on a rank's rows of ``embed`` (ids outside them give zeros),
    summed; and the tied unembedding's logits are the rank's columns."""
    cfg = get_config("qwen2-1.5b", **KW)
    leaves = _draw(11, {"embed": (cfg.padded_vocab, cfg.d_model), "final_norm": (cfg.d_model,)})
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 6)))
    probe = torch.from_numpy(_draw(13, {"p": (2, 6, cfg.d_model)}, 1.0)["p"])

    def fn(p, xs):
        x = transformer._embed(p, cfg, tokens)
        logits = transformer._whole_vocab(cfg, transformer._unembed(p, cfg, x))
        return logits, (x * probe).sum() + logits.square().mean()

    _hold(*_tp_vs_plain(size, leaves, {}, fn), what="embedding")


@pytest.mark.parametrize("size", [2, 4])
def test_expert_parallel_moe(size):
    """qwen3-moe smoke's experts (8, top 2) over the group: routing and
    dispatch whole on every rank, each rank's experts' products and rows, the
    partial outputs summed; the aux loss and every gradient as the plain
    path's, the output as the reference's."""
    cfg = get_config("qwen3-moe-235b-a22b", **KW)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    leaves = _draw(14, {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                        "w_down": (e, f, d)})
    x = _draw(15, {"x": (2, 12, d)}, 1.0)

    def fn(p, xs):
        out, aux = moe.moe_ffn(p, xs["x"], cfg.n_experts_per_tok, cfg.capacity_factor, cfg.act)
        return torch.cat([out.reshape(-1), aux.reshape(1)]), out.square().sum() + aux

    res = _tp_vs_plain(size, leaves, x, fn)
    out, aux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in leaves.items()},
                               jnp.asarray(x["x"]), cfg.n_experts_per_tok, cfg.capacity_factor,
                               cfg.act)
    _hold(*res, ref=np.concatenate([np.asarray(out).reshape(-1), [float(aux)]]), what="moe")


@pytest.mark.parametrize("size", [2, 4])
def test_moe_rank_gathers_only_its_slots(size):
    """An expert-parallel rank's dispatch gathers its ``E / TP`` experts'
    capacity blocks alone, equal to that slice of the whole dispatch, and
    its metadata stay whole."""
    cfg = get_config("qwen3-moe-235b-a22b", **KW)
    e, d, k = cfg.n_experts, cfg.d_model, cfg.n_experts_per_tok
    leaves = _draw(18, {"router": (d, e)})
    x = torch.from_numpy(_draw(19, {"x": (3, 10, d)}, 1.0)["x"])
    cap = int(np.ceil(k * 10 / e * cfg.capacity_factor))
    ids, _ = moe._route(x @ torch.from_numpy(leaves["router"]), k)
    xg, meta = moe._dispatch_rows(x, ids, e, cap)
    width = e // size * cap
    for r in range(size):
        part, part_meta = moe._dispatch_rows(x, ids, e, cap, r * width, width)
        assert part.shape == (3, width, d)
        assert torch.equal(part, xg[:, r * width:(r + 1) * width])
        for a, b in zip(part_meta, meta):
            assert torch.equal(a, b)


@pytest.mark.parametrize("size", [2, 4])
def test_moe_aux_over_batch_shards_and_capacity_per_row(size):
    """Capacity is per sequence row (``k * S / E``): each batch shard's
    dispatch metadata are the whole batch's rows.  The aux loss's two means
    are sums over the batch group over the global token count: every shard's
    aux is the whole batch's, and the shards' gradients (the aux unweighted)
    sum to the whole batch's."""
    cfg = get_config("qwen3-moe-235b-a22b", **KW)
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_experts_per_tok
    leaves = _draw(16, {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                        "w_down": (e, f, d)})
    x = torch.from_numpy(_draw(17, {"x": (2 * size, 6, d)}, 1.0)["x"])
    cap = int(np.ceil(k * 6 / e * cfg.capacity_factor))  # the reference's, from the row length
    ids, _ = moe._route(x @ torch.from_numpy(leaves["router"]), k)
    whole_meta = moe._dispatch_rows(x, ids, e, cap)[1]
    rows = x.shape[0] // size
    for r in range(size):
        part = moe._dispatch_rows(x[r * rows:(r + 1) * rows], ids[r * rows:(r + 1) * rows], e,
                                  cap)[1]
        for a, b in zip(part, whole_meta):
            assert torch.equal(a, b[r * rows:(r + 1) * rows])
    assert not bool(whole_meta[3].all())  # some assignments are dropped at this capacity

    params = Params({n: torch.from_numpy(v) for n, v in leaves.items()})

    def run(p, xs):
        out, aux = moe.moe_ffn(p, xs, k, cfg.capacity_factor, cfg.act)
        return out, aux

    whole = params.map_leaves(lambda _, t: t.clone().requires_grad_(True))
    out, aux = run(whole, x)
    want = torch.autograd.grad(aux, [whole["router"]])  # the aux loss reads the router alone

    def rank(r, group):
        p = params.map_leaves(lambda _, t: t.clone().requires_grad_(True))
        o, a = run(p, x[r * rows:(r + 1) * rows])
        return o.detach(), a.detach(), torch.autograd.grad(a, [p["router"]])

    outs = run_ranks(size, rank, role="dp")
    for r, (o, a, _) in enumerate(outs):
        _close(a, aux, f"shard {r} aux")
        _close(o, out[r * rows:(r + 1) * rows], f"shard {r} rows")
    for i, w in enumerate(want):
        _close(sum(o[2][i] for o in outs), w, f"aux gradient {i}")
    ref_aux = jax_moe.moe_ffn({n: jnp.asarray(v) for n, v in leaves.items()},
                              jnp.asarray(x.numpy()), k, cfg.capacity_factor, cfg.act)[1]
    _close(outs[0][1], float(ref_aux), "aux against the reference")


# ---------------------------------------------------------------------------
# whole models, and a rank's compute tree
# ---------------------------------------------------------------------------


def _batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family in ("vlm", "encoder"):
        out["embeds"] = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32))
    else:
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32))
    if cfg.family == "vlm":
        out["mrope_positions"] = torch.arange(s, dtype=torch.int32)[None, :, None].expand(
            b, s, 3).contiguous()
    out["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    out["loss_mask"] = torch.from_numpy((rng.random((b, s)) > 0.25).astype(np.float32))
    return out


@pytest.mark.parametrize("arch,pad,size", [
    ("qwen2-1.5b", 0, 2), ("qwen2-1.5b", 4, 4), ("qwen3-moe-235b-a22b", 0, 4),
    ("dbrx-132b", 0, 2), ("qwen2-vl-7b", 0, 2), ("hubert-xlarge", 0, 4),
    ("starcoder2-3b", 0, 4),
])
def test_model_loss_and_gradients(arch, pad, size):
    """The transformer families' ``train_loss`` (remat on) and every leaf's
    gradient, TP against the plain path; and the decoders' prefill and two
    decode steps, whole logits on every rank."""
    cfg = dataclasses.replace(get_config(arch, pad_heads_to=pad, **KW), remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2, 8, 18)
    loss, _, grads = _value_and_grad(model, params.map_leaves(
        lambda _, t: t.clone().requires_grad_(True)), batch)

    def rank(r, group):
        return _value_and_grad(model, rank_params(params, size, r, trainable=True), batch)

    outs = run_ranks(size, rank)
    got = assemble([o[2] for o in outs], sharded_dims(params.leaves(), size))
    for o in outs:
        _close(o[0], loss, "loss")
    for k, g in grads.items():
        _close(got[k], g, k)
    if cfg.family in ("vlm", "encoder"):
        return
    tokens = batch["tokens"]

    def serve(p):
        logits, cache, t = model.prefill(p, {"tokens": tokens[:, :6]}, 8)
        out = [logits]
        for i in (6, 7):
            logits, cache, t = model.decode_step(p, cache, tokens[:, i:i + 1], t)
            out.append(logits)
        return out

    with torch.no_grad():
        want = serve(params)
        got = run_ranks(size, lambda r, g: serve(rank_params(params, size, r)))
    for r, outs_r in enumerate(got):
        for i, (a, b) in enumerate(zip(outs_r, want)):
            _close(a, b, f"rank {r} logits {i}")


@pytest.mark.parametrize("size", [2, 4])
def test_rank_compute_tree_holds_its_model_shards(size):
    """A rank's tree holds 1/TP of each leaf the rules shard over "model" (and
    the rank's chunk, in the reference's element order), every other leaf whole."""
    cfg = get_config("qwen3-moe-235b-a22b", **KW)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    dims = sharded_dims(params.leaves(), size)
    assert {k.split(".")[-1] for k in dims} == {"embed", "lm_head", "wq", "wo", "w_gate",
                                                "w_up", "w_down"}
    for r in range(size):
        tree = rank_params(params, size, r).leaves()
        for k, p in params.leaves().items():
            if k in dims:
                assert tree[k].numel() * size == p.numel(), k
                n = p.shape[dims[k]] // size
                assert torch.equal(tree[k], p.narrow(dims[k], r * n, n)), k
            else:
                assert tree[k] is p or torch.equal(tree[k], p), k
