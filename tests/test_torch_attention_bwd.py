"""The attention backward's kernel path on the CPU: its arithmetic, its route, its operator.

* :func:`flash.attention_bwd_tiled_ref` -- the backward kernels' arithmetic
  tile by tile (``lse`` from the forward, ``delta``, dK / dV by key tile over
  the kv group's query heads, dQ by query tile) -- against the closed form
  :func:`flash.attention_bwd`: causal and not, a sliding window, GQA 1, 2
  and 6, a ragged last tile, queries past the keys' start (a prefill
  continuation).  In float32 within 1e-5 of each gradient's largest (only
  the order of the sums differs); in bfloat16, where the tiled version
  rounds ``P`` and ``dS`` to bf16 as the kernels round their operands,
  within ``GRAD_RTOL`` (``tests/test_torch_train_cuda.py``'s 2**-6).
  A query row that sees no key gets no gradient there: the tiled version
  is the closed form with that row's ``dO`` set to zero.
* The forward's ``lse`` on the CPU is :func:`flash.attention_lse_ref`.
* :func:`flash.backward_route` on ``meta`` tensors: which calls take the
  kernels and which keep the plain backward.  ``AttentionFunction`` asks
  the forward for ``lse`` only where autograd will run the backward.
* ``torch.ops.repro_torch.attention_backward``: ``opcheck`` on the CPU, its
  fake implementation against the plain version's shapes and strides, and
  its FLOP formula against what :func:`flash.attention_bwd` counts.

No jax: the closed form is held to ``jax.grad`` by
``tests/test_torch_train_kernels.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import flash_attention as flash  # noqa: E402

GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}  # of each gradient's largest

# (name, B, Sq, Sk, H, KH, hd, causal, window)
CASES = [
    ("causal_gqa6_ragged", 2, 130, 130, 12, 2, 32, True, None),
    ("causal_gqa2", 1, 128, 128, 4, 2, 64, True, None),
    ("noncausal_gqa1_ragged", 2, 96, 96, 3, 3, 16, False, None),
    ("window_gqa2_ragged", 1, 150, 150, 4, 2, 32, True, 40),
    ("noncausal_window_gqa6", 1, 70, 70, 6, 1, 16, False, 24),
    ("continuation_gqa2", 2, 40, 100, 4, 2, 32, True, None),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _randn(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _inputs(case, dtype, seed=0):
    _, b, sq, sk, h, kh, hd, causal, window = case
    q = _randn((b, sq, h, hd), dtype, seed)
    k = _randn((b, sk, kh, hd), dtype, seed + 1)
    v = _randn((b, sk, kh, hd), dtype, seed + 2)
    qpos = torch.arange(sk - sq, sk, dtype=torch.int32).expand(b, sq).contiguous()
    kpos = torch.arange(sk, dtype=torch.int32).expand(b, sk).contiguous()
    return q, k, v, qpos, kpos, causal, window


def _relative(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tiled_backward_matches_closed_form(case, dtype):
    dt = DTYPES[dtype]
    q, k, v, qpos, kpos, causal, window = _inputs(case, dt)
    out = flash.attention_ref(q, k, v, qpos, kpos, causal, window)
    do = _randn(out.shape, dt, 9)
    lse = flash.attention_lse_ref(q, k, qpos, kpos, causal, window)
    want = flash.attention_bwd(do, q, k, v, out, qpos, kpos, causal, window)
    got = flash.attention_bwd_tiled_ref(do, q, k, v, out, lse, qpos, kpos, causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert _relative(a, w) <= GRAD_RTOL[dt], name


def blind_rows(qpos, kpos, causal, window) -> torch.Tensor:
    """``(B, Sq)``: the query rows that see no key."""
    return ~flash._visible(qpos, kpos, causal, window).any(dim=-1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiled_backward_gives_rows_that_see_no_key_no_gradient(dtype):
    """Invalid leading keys (``kv_positions`` -1) in one sequence leave its
    first causal queries with no key to see: the tiled version (the
    kernels' arithmetic) gives them no gradient, which is the closed form
    with their ``dO`` set to zero; the closed form itself would spread it
    over the masked keys' ``dv``."""
    dt = DTYPES[dtype]
    q, k, v, qpos, kpos, causal, window = _inputs(CASES[0], dt)
    kpos = kpos.clone()
    kpos[0, :5] = -1
    blind = blind_rows(qpos, kpos, causal, window)
    assert int(blind.sum()) == 5 and bool(blind[0, :5].all())
    out = flash.attention_ref(q, k, v, qpos, kpos, causal, window)
    do = _randn(out.shape, dt, 9)
    lse = flash.attention_lse_ref(q, k, qpos, kpos, causal, window)
    got = flash.attention_bwd_tiled_ref(do, q, k, v, out, lse, qpos, kpos, causal, window)
    quiet = torch.where(blind[..., None, None], 0.0, do.float()).to(dt)
    want = flash.attention_bwd(quiet, q, k, v, out, qpos, kpos, causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _relative(a, w) <= GRAD_RTOL[dt], name
    assert not bool(got[0][blind].any())
    # no query sees the invalid keys: the closed form's dv there is the blind
    # rows' dO spread over every key, the tiled version's is zero
    spread = flash.attention_bwd(do, q, k, v, out, qpos, kpos, causal, window)[2]
    assert bool(spread[0, :5].any()) and not bool(got[2][0, :5].any())


def test_lse_is_the_rows_logsumexp():
    """The training forward's operator gives, on the CPU, the plain output
    and each row's log-sum-exp, from which the softmax comes back; its fake
    gives the same shapes, dtypes and strides."""
    q, k, v, qpos, kpos, causal, window = _inputs(CASES[0], torch.float32)
    b, sq, h, hd = q.shape
    args = (q, k, v, qpos, kpos, causal, window, None)
    out, lse = flash.attention_with_lse(*args)
    assert torch.equal(lse, flash.attention_lse_ref(q, k, qpos, kpos, causal, window))
    assert torch.equal(out, flash.attention_ref(q, k, v, qpos, kpos, causal, window))
    meta = torch.ops.repro_torch.attention_lse(
        *[_meta(a) if isinstance(a, torch.Tensor) else a for a in args])
    for m, w in zip(meta, (out, lse)):
        assert m.shape == w.shape and m.dtype == w.dtype and m.stride() == w.stride()
    g = h // k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, -1, g, hd), k) / hd ** 0.5
    s = torch.where(flash._visible(qpos, kpos, causal, window)[:, None, None], s, flash.NEG_INF)
    p = torch.exp(s - lse.reshape(b, -1, g, sq)[..., None])
    assert torch.allclose(p, torch.softmax(s, dim=-1), atol=1e-6)
    torch.library.opcheck(torch.ops.repro_torch.attention_lse.default, args)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _meta_call(b, s, h, kh, hd, dtype, offset=0):
    """Meta q, k, v of the model layout, q ``offset`` elements into its storage."""
    n = b * s * h * hd
    q = torch.empty(n + offset, dtype=dtype, device="meta")[offset:].view(b, s, h, hd)
    k = torch.empty(b, s, kh, hd, dtype=dtype, device="meta")
    return q, k, torch.empty_like(k)


# (name, dtype, hd, offset of q, lse given, route)
ROUTES = [
    ("qwen2_bf16_hd128", torch.bfloat16, 128, 0, True, "kernels"),
    ("hubert_bf16_hd80", torch.bfloat16, 80, 0, True, "kernels"),
    ("smoke_bf16_hd16", torch.bfloat16, 16, 0, True, "kernels"),
    ("no_lse", torch.bfloat16, 128, 0, False, "plain"),
    ("float32", torch.float32, 128, 0, True, "plain"),
    ("recurrentgemma_hd256", torch.bfloat16, 256, 0, True, "plain"),
    ("hd136_over_the_registers", torch.bfloat16, 136, 0, True, "plain"),
    ("unaligned_rows", torch.bfloat16, 128, 1, True, "plain"),
]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_backward_route_on_meta(route):
    _, dtype, hd, offset, with_lse, want = route
    q, k, v = _meta_call(2, 64, 12, 2, hd, dtype, offset)
    lse = torch.empty(2, 12, 64, device="meta") if with_lse else None
    assert flash.backward_route(q, k, v, lse) == want
    # the same call on the CPU keeps the plain backward: the kernels have no CPU mode
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (q, k, v)]
    assert flash.backward_route(*cpu, torch.zeros(2, 12, 64) if with_lse else None) == "plain"


class _AttentionCalls(TorchDispatchMode):
    """Records each attention operator's call: forward (with ``lse`` or not) and backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._opname if func.namespace == "repro_torch" else None
        if name in ("attention", "attention_lse"):
            self.calls.append(("forward", name == "attention_lse"))
        elif name == "attention_backward":
            self.calls.append(("backward", True))
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "kernels"), (torch.float32, "plain")])
def test_function_asks_for_lse_only_when_training(dtype, want):
    """On ``meta`` tensors: with grad the bf16 forward writes ``lse`` and the
    backward is the kernels' operator (one call); under ``no_grad`` or with
    no input requiring grad (serving) no ``lse`` is asked for; float32 asks
    for none and its backward is the closed form's plain ops."""
    q, k, v = (t.requires_grad_(True) for t in _meta_call(2, 128, 12, 2, 128, dtype))
    pos = torch.empty(2, 128, dtype=torch.int32, device="meta")
    kernels = want == "kernels"
    with _AttentionCalls() as mode:
        out = flash.AttentionFunction.apply(q, k, v, pos, pos, True, None, None)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert mode.calls == [("forward", kernels)] + [("backward", True)] * kernels
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    for ctx in (torch.no_grad(), torch.inference_mode()):
        with _AttentionCalls() as mode, ctx:
            flash.AttentionFunction.apply(q, k, v, pos, pos, True, None, None)
        assert mode.calls == [("forward", False)]
    with _AttentionCalls() as mode:
        flash.AttentionFunction.apply(*(t.detach() for t in (q, k, v)), pos, pos, True, None,
                                      None)
    assert mode.calls == [("forward", False)]


def _backward_args(case, dtype=torch.bfloat16):
    q, k, v, qpos, kpos, causal, window = _inputs(case, dtype)
    out = flash.attention_ref(q, k, v, qpos, kpos, causal, window)
    do = _randn(out.shape, dtype, 9)
    lse = flash.attention_lse_ref(q, k, qpos, kpos, causal, window)
    return (do, q, k, v, out, lse, qpos, kpos, causal, window, None)


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_backward_operator_fake_matches_plain(case):
    """``opcheck`` on the CPU; the fake implementation (under
    ``FakeTensorMode`` and on ``meta``) gives the plain version's shapes,
    dtypes and (contiguous) strides; on the CPU the operator is the closed form."""
    args = _backward_args(case)
    op = torch.ops.repro_torch.attention_backward
    torch.library.opcheck(op.default, args)
    want = op(*args)
    plain = flash.attention_bwd(*args[:5], *args[6:])
    mode = FakeTensorMode()
    fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        got = op(*fake)
    meta = op(*[_meta(a) if isinstance(a, torch.Tensor) else a for a in args])
    for w, p, f, m in zip(want, plain, got, meta):
        assert torch.equal(w, p)
        for t in (f, m):
            assert t.shape == w.shape and t.dtype == w.dtype and t.stride() == w.stride()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_flop_formula_counts_the_closed_forms_products(case):
    """The operator's FLOP formula is what a FLOP counter sees of
    :func:`flash.attention_bwd` (five dense products of ``2 b h sq sk hd``),
    on the CPU and on ``meta``."""
    args = _backward_args(case, torch.float32)
    _, b, sq, sk, h, _, hd, _, _ = case
    with FlopCounterMode(display=False) as plain:
        flash.attention_bwd(*args[:5], *args[6:])
    with FlopCounterMode(display=False) as op:
        torch.ops.repro_torch.attention_backward(*args)
    with FlopCounterMode(display=False) as meta:
        torch.ops.repro_torch.attention_backward(
            *[_meta(a) if isinstance(a, torch.Tensor) else a for a in args])
    want = flash.attention_bwd_flops(b, sq, h, sk, hd)
    assert want == 10 * b * h * sq * sk * hd
    assert plain.get_total_flops() == op.get_total_flops() == meta.get_total_flops() == want
