"""The hand kernels' entry points as custom operators, on the CPU.

``torch.ops.repro_torch.attention`` (``kernels/flash_attention.py``) and
``rms_norm``, ``row_sumsq``, ``rms_norm_scaled`` (``kernels/rmsnorm.py``):

* ``torch.library.opcheck`` on each, on CPU tensors (schema, fake
  implementation, dispatch);
* each fake implementation gives its plain version's shape, dtype and
  strides, for inputs that take each of the attention kernels (split-KV
  decode, the bf16 wgmma prefill, the CUDA-core kernel), under
  ``FakeTensorMode`` and on ``meta`` tensors;
* the gradients through the operators (``AttentionFunction``,
  ``RMSNormFunction``, ``RMSNormSplitFunction`` on a group of two thread
  ranks) are bitwise those of the same Functions calling the plain versions
  directly, as they did before the operators, in float32.

No jax: the operators' plain versions are held to the reference by
``tests/test_torch_flash_attention.py`` and ``tests/test_torch_rmsnorm.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from torch_tp_threads import run_ranks  # noqa: E402

# (name, dtype, B, Sq, H, KH, Sk, hd) and the kernel it takes on the card
ATTENTION_CASES = [
    ("decode", torch.bfloat16, 2, 1, 8, 2, 40, 64, "splitkv"),
    ("decode_f32", torch.float32, 1, 1, 4, 4, 24, 32, "splitkv"),
    ("prefill_bf16", torch.bfloat16, 1, 32, 8, 2, 32, 64, "wgmma"),
    ("prefill_f32", torch.float32, 2, 24, 4, 2, 24, 32, "simt"),
]


def _randn(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _attention_args(case, seed=0):
    _, dtype, b, sq, h, kh, sk, hd, _ = case
    q = _randn((b, sq, h, hd), dtype, seed)
    k = _randn((b, sk, kh, hd), dtype, seed + 1)
    v = _randn((b, sk, kh, hd), dtype, seed + 2)
    qpos = torch.arange(sk - sq, sk, dtype=torch.int32).expand(b, sq).contiguous()
    kpos = torch.arange(sk, dtype=torch.int32).expand(b, sk).contiguous()
    return q, k, v, qpos, kpos


def _norm_args(dtype=torch.float32, rows=(3, 5), d=48, seed=3):
    x = _randn((*rows, d), dtype, seed)
    w = _randn((d,), dtype, seed + 1)
    return x, w


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=[c[0] for c in ATTENTION_CASES])
def test_opcheck_attention(case):
    q, k, v, qpos, kpos = _attention_args(case)
    for head_major, window in ((False, None), (True, 8)):
        args = (q, k, v, qpos, kpos, True, window, None, head_major)
        torch.library.opcheck(torch.ops.repro_torch.attention.default, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_norms(dtype):
    x, w = _norm_args(dtype)
    total = rmsnorm.row_sumsq_ref(x) * 2
    torch.library.opcheck(torch.ops.repro_torch.rms_norm.default, (x, w, 1e-6, False))
    torch.library.opcheck(torch.ops.repro_torch.rms_norm.default, (x, w, 1e-5, True))
    torch.library.opcheck(torch.ops.repro_torch.row_sumsq.default, (x,))
    torch.library.opcheck(torch.ops.repro_torch.rms_norm_scaled.default,
                          (x, w, total, 2 * x.shape[-1], 1e-6, False))


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _same_layout(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert got.stride() == want.stride()


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=[c[0] for c in ATTENTION_CASES])
@pytest.mark.parametrize("head_major", [False, True])
def test_attention_fake_matches_plain(case, head_major):
    """The fake implementation's output has the plain version's shape, dtype
    and strides, and ``attention_route`` of the fake (and meta) inputs is the
    kernel the case names."""
    args = _attention_args(case)
    op = torch.ops.repro_torch.attention
    want = op(*args, True, None, None, head_major)
    mode = FakeTensorMode()
    fake = [mode.from_tensor(t) for t in args]
    with mode:
        got = op(*fake, True, None, None, head_major)
        assert flash.attention_route(*fake[:3]) == case[-1]
    _same_layout(got, want)
    meta = [_meta(t) for t in args]
    _same_layout(op(*meta, True, None, None, head_major), want)
    assert flash.attention_route(*meta[:3]) == case[-1]
    # a row off a 16-byte boundary takes the CUDA-core kernel, as on the card
    q = torch.empty(args[0].numel() + 1, dtype=args[0].dtype, device="meta")[1:].view(
        args[0].shape)
    assert flash.attention_route(q, *meta[1:3]) == "simt"


def test_norm_fakes_match_plain():
    x, w = _norm_args(torch.bfloat16)
    total = rmsnorm.row_sumsq_ref(x)
    cases = [(torch.ops.repro_torch.rms_norm, (x, w, 1e-6, True)),
             (torch.ops.repro_torch.row_sumsq, (x,)),
             (torch.ops.repro_torch.rms_norm_scaled, (x, w, total, x.shape[-1], 1e-6, False))]
    for op, args in cases:
        want = op(*args)
        mode = FakeTensorMode()
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with mode:
            _same_layout(op(*fake), want)
        _same_layout(op(*[_meta(a) if isinstance(a, torch.Tensor) else a for a in args]), want)


class _PlainAttention(torch.autograd.Function):
    """``AttentionFunction`` as it was before the operator: the plain version called directly."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, scale):
        out = flash.attention_ref(q, k, v, qpos, kpos, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, qpos, kpos)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, qpos, kpos = ctx.saved_tensors
        return (*flash.attention_bwd(do, q, k, v, out, qpos, kpos, ctx.causal, ctx.window,
                                     ctx.scale), None, None, None, None, None)


class _PlainNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, plus_one):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.plus_one = eps, plus_one
        return rmsnorm.rms_norm_ref(x, w, eps, plus_one)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*rmsnorm.rms_norm_bwd(g, x, w, ctx.eps, ctx.plus_one), None, None)


def _grads(fn, inputs, seed):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    g = _randn(out.shape, out.dtype, seed)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads


@pytest.mark.parametrize("window", [None, 8])
def test_attention_gradients_unchanged(window):
    q, k, v, qpos, kpos = _attention_args(("", torch.float32, 2, 16, 4, 2, 16, 32, ""), seed=7)

    def op(q, k, v):
        return flash.AttentionFunction.apply(q, k, v, qpos, kpos, True, window, None)

    def plain(q, k, v):
        return _PlainAttention.apply(q, k, v, qpos, kpos, True, window, None)

    got, want = _grads(op, (q, k, v), 11), _grads(plain, (q, k, v), 11)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("plus_one", [False, True])
def test_norm_gradients_unchanged(plus_one):
    x, w = _norm_args(seed=13)
    got = _grads(lambda x, w: rmsnorm.RMSNormFunction.apply(x, w, 1e-6, plus_one), (x, w), 5)
    want = _grads(lambda x, w: _PlainNorm.apply(x, w, 1e-6, plus_one), (x, w), 5)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_split_norm_gradients_unchanged():
    """The split row on two thread ranks: ``RMSNormSplitFunction`` through
    ``row_sumsq`` / ``rms_norm_scaled`` against the same Function with their
    plain versions called directly."""
    x, w = _norm_args(d=64, seed=17)

    def run(use_plain):
        saved = (rmsnorm.row_sumsq, rmsnorm.rms_norm_scaled)
        if use_plain:
            rmsnorm.row_sumsq = rmsnorm.row_sumsq_ref
            rmsnorm.rms_norm_scaled = rmsnorm.rms_norm_split_ref
        try:
            def rank(r, group):
                cols = slice(32 * r, 32 * (r + 1))
                xr = x[..., cols].contiguous().requires_grad_(True)
                wr = w[cols].contiguous().requires_grad_(True)
                out = tp_norm(xr, wr, group)
                g = _randn(out.shape, out.dtype, 23 + r)
                return (out.detach(), *torch.autograd.grad(out, (xr, wr), g))
            return run_ranks(2, rank)
        finally:
            rmsnorm.row_sumsq, rmsnorm.rms_norm_scaled = saved

    got, want = run(False), run(True)
    for a, b in zip(got, want):
        for s, t in zip(a, b):
            assert torch.equal(s, t)


def tp_norm(x, w, group):
    assert isinstance(group, tp.Group) and group.size == 2
    return rmsnorm.rms_norm_split(x, w, group)
