"""Sequence parallelism (``cfg.sequence_parallel``) on tensor-parallel thread ranks.

The reference's ``"residual"`` role (``src/repro/distributed/axes.py``):
the residual stream between the tensor-parallel regions sharded on its
sequence over ``"model"``, which changes where values live and not what
they are.  Every model rank of a TP group is a thread of this process
(``tests/torch_tp_threads.py``; ``run_ranks(..., seq=True)`` turns it on).
Held: ``Group.reduce_scatter`` and the two conjugate functions
(``leave_to_shards``: reduce-scatter forward, all-gather backward;
``enter_from_shards``: the transpose) with their gradients; whole models
(qwen2 smoke unpadded and padded, qwen3-moe smoke, qwen2-vl smoke,
hubert smoke, recurrentgemma smoke, mamba2 smoke) at TP 2 and 4: the loss,
every gradient and the served logits within 1e-5 of the same TP path
without it; a sequence the group does not divide, and decode (one row),
run plain TP.  The gloo-rank mesh step with it, against the reference's
``jit_train_step`` with ``sequence_parallel=True``, is in
``tests/test_torch_tp_mesh_recurrent.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import axes  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.train import _value_and_grad  # noqa: E402
from torch_tp_threads import assemble, rank_params, run_ranks, sharded_dims  # noqa: E402

TOL = 1e-5
KW = dict(smoke=True, param_dtype="float32", compute_dtype="float32")


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64),
                               np.asarray(want.detach(), np.float64), rtol=TOL, atol=TOL,
                               err_msg=what)


class _Rank(tp.Group):
    def __init__(self, size, rank):
        self.size, self.rank = size, rank


# ---------------------------------------------------------------------------
# the collectives and the conjugate functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("size", [2, 4])
def test_reduce_scatter_is_the_transpose_of_all_gather(size, dim):
    """Every rank's ``x`` summed in rank order, this rank's chunk of ``dim``
    (the reference's element order, ``Group.part``)."""
    x = torch.arange(48.0).reshape(4, 4, 3)

    def rank(r, group):
        return group.reduce_scatter(x * (r + 1), dim)

    outs = run_ranks(size, rank)
    total = x * (size * (size + 1) / 2)
    n = x.shape[dim]
    for r, out in enumerate(outs):
        assert torch.equal(out, total.narrow(dim, _Rank(size, r).part(n).start, n // size))
    assert torch.equal(torch.cat(outs, dim), total)


@pytest.mark.parametrize("size", [2, 4])
def test_sequence_conjugate_functions_and_their_gradients(size):
    """leave_to_shards: the sum reduce-scattered forward, the shards'
    gradients all-gathered backward; enter_from_shards: the shards
    all-gathered forward, the ranks' gradients reduce-scattered backward;
    each the other's transpose."""
    x = torch.arange(24.0).reshape(2, 4, 3)

    def rank(r, group):
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        a = tp.leave_to_shards(xs[0] * (r + 1), group, 1)
        b = tp.enter_from_shards(xs[1][:, group.part(4)], group, 1)
        loss = (a * a).sum() + (b * (r + 1)).sum()
        return a.detach(), b.detach(), torch.autograd.grad(loss, xs)

    outs = run_ranks(size, rank)
    tri = size * (size + 1) / 2
    full_a = x * tri
    for r, (a, b, (ga, gb)) in enumerate(outs):
        mine = _Rank(size, r).part(4)
        assert torch.equal(a, full_a[:, mine])
        assert torch.equal(b, x)
        # d/dx_r of sum over ranks q of |chunk_q(sum_p (p + 1) x)|^2: every
        # rank's chunk's gradient gathered, times this rank's factor
        assert torch.equal(ga, 2 * full_a * (r + 1))
        want_b = torch.zeros_like(x)
        want_b[:, mine] = tri  # every rank's (q + 1) on this rank's rows
        assert torch.equal(gb, want_b)


def test_region_helpers_pick_the_collective():
    """``region_in`` / ``region_out``: plain ``enter`` / ``leave`` where the
    rows are whole; the sequence pair for a rank-local region; ``gather`` /
    ``scatter`` for a region that computes whole on every rank."""
    x = torch.arange(16.0).reshape(1, 4, 4)

    def rank(r, group):
        return (tp.region_in(x[:, group.part(4)], group, group),
                tp.region_in(x[:, group.part(4)], tp.SINGLE, group),
                tp.region_out(x, group, group), tp.region_out(x, tp.SINGLE, group),
                tp.region_out(x, group), tp.region_in(x, group))

    for r, (a, b, c, d, e, f) in enumerate(run_ranks(2, rank)):
        mine = _Rank(2, r).part(4)
        assert torch.equal(a, x) and torch.equal(b, x)
        assert torch.equal(c, 2 * x[:, mine]) and torch.equal(d, x[:, mine])
        assert torch.equal(e, 2 * x) and torch.equal(f, x)
    assert tp.region_in(x, tp.SINGLE) is x and tp.region_out(x, tp.SINGLE) is x


def test_sequence_group_only_where_it_divides():
    """The model group under ``seq=True`` where it divides the rows; plain TP
    otherwise (``seq=False``, a row count it does not divide, decode's one)."""

    def rank(r, group):
        return [tp.sequence_group(s) is group for s in (8, 7, 1)]

    assert run_ranks(2, rank, seq=True) == [[True, False, False]] * 2
    assert run_ranks(2, rank) == [[False, False, False]] * 2
    with axes.logical_axes({"model": 1}, (), "model", seq=True):
        assert tp.sequence_group(8) is tp.SINGLE


# ---------------------------------------------------------------------------
# whole models: with and without sequence parallelism
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
    ("qwen2-1.5b", 0, 2), ("qwen2-1.5b", 0, 4), ("qwen2-1.5b", 4, 4),
    ("qwen3-moe-235b-a22b", 0, 2), ("qwen3-moe-235b-a22b", 0, 4),
    ("qwen2-vl-7b", 0, 2), ("hubert-xlarge", 0, 4),
    ("recurrentgemma-2b", 0, 2), ("recurrentgemma-2b", 0, 4),
    ("mamba2-2.7b", 0, 2), ("mamba2-2.7b", 0, 4),
])
def test_model_with_sequence_parallelism_matches_plain_tp(arch, pad, size):
    """``train_loss`` (remat on) and every leaf's gradient assembled from the
    ranks, with ``sequence_parallel=True``, within 1e-5 of the same TP
    path without it (and of the plain path); the decoders' prefill (rows
    split) and two decode steps (one row: plain TP) likewise."""
    cfg = dataclasses.replace(get_config(arch, pad_heads_to=pad, **KW), remat=True,
                              sequence_parallel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2, 16, 21)
    dims = sharded_dims(params.leaves(), size)
    loss, _, grads = _value_and_grad(model, params.map_leaves(
        lambda _, t: t.clone().requires_grad_(True)), batch)
    runs = {}
    for seq in (False, True):
        outs = run_ranks(size, lambda r, g: _value_and_grad(
            model, rank_params(params, size, r, trainable=True), batch), seq=seq)
        runs[seq] = ([o[0] for o in outs], assemble([o[2] for o in outs], dims))
    for r, got in enumerate(runs[True][0]):
        _close(got, runs[False][0][r], f"rank {r} loss")
        _close(got, loss, f"rank {r} loss against the plain path")
    for k, g in runs[False][1].items():
        _close(runs[True][1][k], g, k)
        _close(runs[True][1][k], grads[k], f"{k} against the plain path")
    if cfg.family in ("vlm", "encoder"):
        return
    tokens = batch["tokens"]

    def serve(p):
        with torch.no_grad():
            logits, cache, t = model.prefill(p, {"tokens": tokens[:, :12]}, 16)
            out = [logits]
            for i in (12, 13):
                logits, cache, t = model.decode_step(p, cache, tokens[:, i:i + 1], t)
                out.append(logits)
        return out

    plain = run_ranks(size, lambda r, g: serve(rank_params(params, size, r)))
    split = run_ranks(size, lambda r, g: serve(rank_params(params, size, r)), seq=True)
    for r, (a, b) in enumerate(zip(split, plain)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"rank {r} logits {i}")


def test_rows_the_group_does_not_divide_run_plain_tp():
    """Seven rows over two ranks: the residual stream stays whole, and the
    step is the plain TP step's, bitwise."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", **KW), sequence_parallel=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2, 7, 22)
    runs = [run_ranks(2, lambda r, g: _value_and_grad(
        model, rank_params(params, 2, r, trainable=True), batch), seq=seq)
        for seq in (False, True)]
    for a, b in zip(*runs):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
