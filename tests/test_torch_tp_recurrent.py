"""Tensor parallelism over "model" for the state-space and RG-LRU families.

mamba2-2.7b (``ssm``) and recurrentgemma-2b (``hybrid``) in their smoke
sizes, float32, every model rank of a TP group a thread of this process
(``tests/torch_tp_threads.py``), each on its shards of the reference's
weights as the rules (``distributed/sharding.py``) give them over
``{"model": TP}``.  Held within 1e-5 of the port's plain (TP 1) path and
within 1e-4 of the reference: the prefill and decode logits (against the
reference's cache-free ``forward``), every rank's cache part (against the
plain cache's slice, ``torch_tp_threads.rank_cache``), the loss and every
leaf's gradient assembled from the ranks (against ``jax.value_and_grad``,
within 1e-4 of each leaf's largest reference gradient, as
``tests/test_torch_train_grads.py``).  A group of one is bitwise the plain
path.  In isolation: the split-row RMSNorm (``kernels/rmsnorm.py``: the
rank's columns normalised by the whole row's sum of squares, and its
backward's summed term) against the reference's ``rms_norm`` over the whole
row; a rank's RG-LRU gates against the whole gates' columns; and a group
that divides ``d_inner`` / ``d_rnn`` but not the heads / gate blocks, which
computes the mixer whole on every rank.  The gloo-rank mesh steps of both
families are in ``tests/test_torch_tp_mesh_recurrent.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import build_model, convert, rglru  # noqa: E402
from repro_torch.models.common import Params  # noqa: E402
from repro_torch.runtime.train import _value_and_grad  # noqa: E402
from torch_tp_threads import (  # noqa: E402
    assemble, rank_cache, rank_params, run_ranks, sharded_dims)

TOL = 1e-5  # against the port's plain path
REF_TOL = 1e-4  # against the reference
KW = dict(smoke=True, param_dtype="float32", compute_dtype="float32")
ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
# a prompt no longer than the hybrid's window (8), three decode steps past it
B, S_PRE, S_DEC = 2, 8, 3


def _np64(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float64)


def _close(got, want, what: str, tol: float = TOL) -> None:
    np.testing.assert_allclose(_np64(got), _np64(want), rtol=tol, atol=tol, err_msg=what)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the split-row RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_split_row_norm_matches_reference_over_the_whole_row(size, plus_one):
    """Each rank normalises its columns by the whole row's mean square (its
    rows' sums of squares summed over the group): the reference's
    ``rms_norm`` over the whole row, forward and backward; the backward's
    second sum, of ``g w' x`` over the rank's columns, adds up to the whole
    row's."""
    d = 24
    rng = np.random.default_rng(size)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    w = (rng.standard_normal(d) * 0.5).astype(np.float32)
    g = rng.standard_normal((3, 5, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jax_layers.rms_norm(a, b, plus_one=plus_one),
                        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    def rank(r, group):
        group.keep_summed = True
        cols = group.part(d)
        xr = torch.from_numpy(x[..., cols]).requires_grad_(True)
        wr = torch.from_numpy(w[cols]).requires_grad_(True)
        out = rmsnorm.rms_norm_split(xr, wr, group, plus_one=plus_one)
        dx, dw = torch.autograd.grad((out * torch.from_numpy(g[..., cols])).sum(), [xr, wr])
        return out.detach(), dx, dw, group.summed

    outs = run_ranks(size, rank)
    _close(torch.cat([o[0] for o in outs], -1), np.asarray(want), "forward")
    _close(torch.cat([o[1] for o in outs], -1), np.asarray(want_dx), "dx")
    _close(torch.cat([o[2] for o in outs], -1), np.asarray(want_dw), "dw")
    # what each rank gave the group's two sums: its rows' sums of squares
    # (forward), then its columns' share of sum(g w' x) (backward)
    wp = (1.0 + w) if plus_one else w
    for r, (_, _, _, summed) in enumerate(outs):
        assert len(summed) == 2
        cols = _Rank(size, r).part(d)
        _close(summed[0], (x[..., cols].astype(np.float64) ** 2).sum(-1), f"rank {r} sumsq")
    whole_term = (g * wp * x).astype(np.float64).sum(-1, keepdims=True)
    _close(sum(o[3][1] for o in outs), whole_term, "the backward's summed term")


class _Rank(tp.Group):
    def __init__(self, size, rank):
        self.size, self.rank = size, rank


@pytest.mark.parametrize("plus_one", [False, True])
def test_split_row_plain_versions_match_the_whole_row(plus_one):
    """The plain versions alone: ``row_sumsq_ref`` of each chunk, summed, is
    the whole row's; ``rms_norm_split_ref`` of each chunk by that total is
    the reference's ``rms_norm`` of the whole row (and the wrapper on the
    CPU is the plain version, exactly)."""
    d, parts = 40, 4
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    chunks = [slice(i * d // parts, (i + 1) * d // parts) for i in range(parts)]
    total = sum(rmsnorm.row_sumsq_ref(x[:, c]) for c in chunks)
    _close(total, rmsnorm.row_sumsq_ref(x), "total")
    assert torch.equal(rmsnorm.row_sumsq(x[:, chunks[1]].contiguous()),
                       rmsnorm.row_sumsq_ref(x[:, chunks[1]]))
    got = torch.cat([rmsnorm.rms_norm_split_ref(x[:, c], w[c], total, d, plus_one=plus_one)
                     for c in chunks], -1)
    want = jax_layers.rms_norm(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                               plus_one=plus_one)
    _close(got, np.asarray(want), "split plain version")
    c = chunks[2]
    assert torch.equal(
        rmsnorm.rms_norm_scaled(x[:, c].contiguous(), w[c].contiguous(), total, d,
                                plus_one=plus_one),
        rmsnorm.rms_norm_split_ref(x[:, c], w[c], total, d, plus_one=plus_one))


def test_split_row_norm_on_a_group_of_one_is_the_fused_norm():
    """A group of one (``SINGLE``, or a thread group of size 1) takes the
    fused norm, one launch on the card: bitwise ``RMSNormFunction``, forward
    and backward."""
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32))

    def run(fn):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        out = fn(x, w)
        return (out.detach(), *torch.autograd.grad(out.square().sum(), [x, w]))

    want = run(lambda x, w: rmsnorm.RMSNormFunction.apply(x, w, 1e-6, False))
    for got in (run(lambda x, w: rmsnorm.rms_norm_split(x, w, tp.SINGLE)),
                run_ranks(1, lambda r, g: run(lambda x, w: rmsnorm.rms_norm_split(x, w, g)))[0]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the RG-LRU's block-diagonal gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_rglru_rank_gates_are_the_whole_gates_columns(size):
    """A rank's ``nb / TP`` whole blocks of ``w_a`` / ``w_i`` and its channels
    of ``b_a`` / ``b_i`` / ``lam`` give, on its channels of ``x``, exactly
    those columns of the whole gates (the reference's): no collective."""
    d, nb = 64, 16
    params = rglru.init_rglru_block(torch.Generator().manual_seed(5), 16, d, 4, torch.float32,
                                    n_gate_blocks=nb)
    params["b_a"] = torch.linspace(-0.5, 0.5, d)
    params["b_i"] = torch.linspace(0.3, -0.3, d)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 5, d)).astype(np.float32))
    a, b = rglru._rglru_gates(params, x, 8.0)
    ja, jb = jax_rglru._rglru_gates({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                                    jnp.asarray(x.numpy()), 8.0)
    _close(a, np.asarray(ja), "whole a against the reference")
    _close(b, np.asarray(jb), "whole b against the reference")
    whole = Params({k: v for k, v in params.items()})
    assert sharded_dims(whole.leaves(), size)["w_a"] == 0
    for r in range(size):
        mine = rank_params(whole, size, r)
        cols = _Rank(size, r).part(d)
        assert mine["w_a"].shape == (nb // size, d // nb, d // nb)
        ra, rb = rglru._rglru_gates(mine, x[..., cols], 8.0)
        _close(ra, a[..., cols], f"rank {r} a", 1e-6)
        _close(rb, b[..., cols], f"rank {r} b", 1e-6)


def test_ssd_gradient_stays_finite_where_the_chunk_decay_overflows():
    """mamba2-2.7b's training at full width (the card's TP 2 train step): a
    128-step chunk whose log-decay spans more than float32's exp range.  The
    reference masks the chunk's upper triangle after the exp (``jnp.where``
    of an inf), so its gradient in ``dt`` is NaN (pinned); the port masks
    before it: the same forward, and the gradient of the sequential
    recurrence ``ssd_reference``."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm

    rng = np.random.default_rng(9)
    b, s, nh, hp, n = 1, 128, 4, 8, 16
    x = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = np.full((b, s, nh), 0.1, np.float32)
    a_neg = -np.array([16.0, 8.0, 1.0, 4.0], np.float32)  # 1.6 a step: cum spans 204
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    d = np.ones(nh, np.float32)
    g = rng.standard_normal((b, s, nh, hp)).astype(np.float32)

    def grads(fn):
        dtt = torch.from_numpy(dt).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = fn(xt, dtt)
        return (y.detach(), *torch.autograd.grad((y * torch.from_numpy(g)).sum(), [xt, dtt]))

    args = [torch.from_numpy(a) for a in (a_neg, bm, cm, d)]
    got = grads(lambda xt, dtt: ssm.ssd_chunked(xt, dtt, args[0], args[1], args[2], args[3],
                                                128))
    want = grads(lambda xt, dtt: ssm.ssd_reference(xt, dtt, *args))
    for a, w, what in zip(got, want, ("y", "dx", "ddt")):
        assert torch.isfinite(a).all(), what
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-4, err_msg=what)

    def ref_loss(dd):
        y, _ = jax_ssm.ssd_chunked(jnp.asarray(x), dd, jnp.asarray(a_neg), jnp.asarray(bm),
                                   jnp.asarray(cm), jnp.asarray(d), 128)
        return (y * jnp.asarray(g)).sum()

    assert not bool(jnp.isfinite(jax.grad(ref_loss)(jnp.asarray(dt))).all())


# ---------------------------------------------------------------------------
# whole models: thread ranks against the plain path and the reference
# ---------------------------------------------------------------------------


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s = S_PRE + S_DEC
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, s), dtype=np.int32),
            "loss_mask": (rng.random((B, s)) > 0.25).astype(np.float32)}


def _serve(model, params, tokens):
    """Prefill ``S_PRE`` tokens, then ``S_DEC`` teacher-forced decode steps:
    (every step's logits, the cache)."""
    with torch.no_grad():
        logits, cache, t = model.prefill(params, {"tokens": tokens[:, :S_PRE]}, S_PRE + S_DEC)
        out = [logits]
        for i in range(S_DEC):
            logits, cache, t = model.decode_step(params, cache,
                                                 tokens[:, S_PRE + i:S_PRE + i + 1], t)
            out.append(logits)
    return out, cache


def _reference(arch: str, cfg):
    """The reference's weights (key 0), carried into the port, and its
    loss, gradients and cache-free logits on ``_batch``."""
    jcfg = dataclasses.replace(jax_get_config(arch, **KW), remat=cfg.remat)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = _batch(cfg, 11)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    fwd = jax_mamba.forward if cfg.family == "ssm" else jax_hybrid.forward
    jlogits, _ = fwd(jparams, jcfg, jnp.asarray(batch["tokens"]))
    host = jax.tree.map(np.asarray, jparams)
    return (convert.params_from_jax(host, cfg, device="cpu"), batch, float(jloss),
            convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                    device="cpu").leaves(), np.asarray(jlogits))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    cfg = dataclasses.replace(get_config(arch, **KW), remat=True)
    model = build_model(cfg)
    params, batch, jloss, jgrads, jlogits = _reference(arch, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["labels"] = tb["labels"].long()
    loss, _, grads = _value_and_grad(model, params.map_leaves(
        lambda _, t: t.clone().requires_grad_(True)), tb)
    logits, cache = _serve(model, params, tb["tokens"])
    return dict(arch=arch, cfg=cfg, model=model, params=params, batch=tb, jloss=jloss,
                jgrads=jgrads, jlogits=jlogits, loss=loss, grads=grads, logits=logits,
                cache=cache)


@pytest.mark.parametrize("size", [2, 4])
def test_model_loss_and_every_gradient(family, size):
    """``train_loss`` (remat on) and every leaf's gradient assembled from
    the ranks: within 1e-5 of the plain path, within 1e-4 of the reference's
    ``jax.value_and_grad``."""
    f = family
    outs = run_ranks(size, lambda r, g: _value_and_grad(
        f["model"], rank_params(f["params"], size, r, trainable=True), f["batch"]))
    got = assemble([o[2] for o in outs], sharded_dims(f["params"].leaves(), size))
    for r, o in enumerate(outs):
        _close(o[0], f["loss"], f"rank {r} loss")
        _close(o[0], f["jloss"], f"rank {r} loss against the reference", REF_TOL)
    assert got.keys() == f["grads"].keys() == f["jgrads"].keys()
    for k, g in f["grads"].items():
        _close(got[k], g, k)
        want = _np64(f["jgrads"][k])
        err = np.abs(_np64(got[k]) - want).max()
        assert err <= REF_TOL * max(np.abs(want).max(), 1e-30), (k, err)


@pytest.mark.parametrize("size", [2, 4])
def test_model_prefill_decode_and_cache_parts(family, size):
    """The prefill and three decode steps: every rank's whole logits within
    1e-5 of the plain path's and 1e-4 of the reference's cache-free forward
    at those positions; every rank's cache part (its channels, heads, ring
    heads) within 1e-5 of the plain cache's slice."""
    f = family
    got = run_ranks(size, lambda r, g: _serve(f["model"], rank_params(f["params"], size, r),
                                              f["batch"]["tokens"]))
    positions = [S_PRE - 1] + [S_PRE + i for i in range(S_DEC)]
    for r, (logits, cache) in enumerate(got):
        for i, (a, b) in enumerate(zip(logits, f["logits"])):
            _close(a, b, f"rank {r} step {i}")
            _close(a, f["jlogits"][:, positions[i]], f"rank {r} step {i} against the reference",
                   REF_TOL)
        want = rank_cache(f["cache"], size, r)
        mine, theirs = _leaves(cache), _leaves(want)
        assert len(mine) == len(theirs)
        split = 0
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert a.shape == b.shape, (r, i, a.shape, b.shape)
            _close(a, b, f"rank {r} cache leaf {i}")
            split += a.numel() < b.numel() or a.shape != _leaves(f["cache"])[i].shape
        assert split > 0  # the rules split some cache leaf over the ranks


def test_group_of_one_is_bitwise_the_plain_path(family):
    """A thread group of one rank: logits, loss and every gradient equal."""
    f = family
    (loss, _, grads), = run_ranks(1, lambda r, g: _value_and_grad(
        f["model"], rank_params(f["params"], 1, 0, trainable=True), f["batch"]))
    assert torch.equal(loss, f["loss"])
    assert all(torch.equal(grads[k], g) for k, g in f["grads"].items())
    (logits, _), = run_ranks(1, lambda r, g: _serve(f["model"], rank_params(f["params"], 1, 0),
                                                    f["batch"]["tokens"]))
    assert all(torch.equal(a, b) for a, b in zip(logits, f["logits"]))


@pytest.mark.parametrize("size", [2, 4])
def test_rank_compute_tree_holds_its_model_shards(family, size):
    """A rank's tree holds 1/TP of each leaf the rules split over "model" (its
    chunk in the reference's element order: ``w_a`` / ``w_i`` by whole
    blocks), every other leaf whole."""
    f = family
    params = f["params"]
    dims = sharded_dims(params.leaves(), size)
    names = {k.split(".")[-1] for k in dims}
    if f["arch"] == "mamba2-2.7b":
        assert names == {"embed", "lm_head", "w_z", "w_x", "w_dt", "conv_x", "conv_x_b",
                         "A_log", "dt_bias", "D", "norm_w", "out_proj"}
    else:
        assert names == {"embed", "wq", "wo", "w_gate", "w_up", "w_down", "w_y", "w_x",
                         "conv_w", "conv_b", "w_a", "w_i", "b_a", "b_i", "lam", "w_out"}
    for r in range(size):
        tree = rank_params(params, size, r).leaves()
        for k, p in params.leaves().items():
            if k in dims:
                n = p.shape[dims[k]] // size
                assert torch.equal(tree[k], p.narrow(dims[k], r * n, n)), k
            else:
                assert tree[k] is p or torch.equal(tree[k], p), k


@pytest.mark.parametrize("arch,over,size", [
    ("recurrentgemma-2b", dict(d_model=72), 2),  # d_rnn 72: one gate block
    ("mamba2-2.7b", dict(ssm_headdim=64), 4),  # d_inner 128 over 4, its 2 heads not
])
def test_group_that_does_not_divide_the_blocks_computes_whole(arch, over, size):
    """Where the group splits ``d_rnn`` but not the gate blocks (the rules
    leave ``w_a`` / ``w_i`` whole), or ``d_inner`` but not the heads (the
    rules leave ``w_dt``, ``A_log``, ``dt_bias``, ``D`` whole), the mixer
    computes whole on every rank over the gathered channels: the plain
    path's loss, gradients and logits."""
    cfg = dataclasses.replace(get_config(arch, **KW), **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    dims = sharded_dims(params.leaves(), size)
    whole = {"w_a", "w_i"} if cfg.family == "hybrid" else {"w_dt", "A_log", "dt_bias", "D"}
    split = {"b_a", "lam", "w_x"} if cfg.family == "hybrid" else {"w_x", "norm_w", "conv_x"}
    names = {k.split(".")[-1] for k in dims}
    assert not whole & names and split <= names
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 12).items()}
    batch["labels"] = batch["labels"].long()
    loss, _, grads = _value_and_grad(model, params.map_leaves(
        lambda _, t: t.clone().requires_grad_(True)), batch)
    outs = run_ranks(size, lambda r, g: _value_and_grad(
        model, rank_params(params, size, r, trainable=True), batch))
    got = assemble([o[2] for o in outs], dims)
    for o in outs:
        _close(o[0], loss, "loss")
    for k, g in grads.items():
        _close(got[k], g, k)
    want, _ = _serve(model, params, batch["tokens"])
    for r, (logits, _) in enumerate(run_ranks(size, lambda r, g: _serve(
            model, rank_params(params, size, r), batch["tokens"]))):
        for i, (a, b) in enumerate(zip(logits, want)):
            _close(a, b, f"rank {r} step {i}")
