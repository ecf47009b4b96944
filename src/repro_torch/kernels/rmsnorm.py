"""Fused RMSNorm: the CUDA kernel, its wrapper and its plain version.

Port of ``repro.kernels.rmsnorm`` (the Pallas ``rms_norm_fused``) and of its
oracle ``repro.kernels.ref.rms_norm_ref``.  :func:`rms_norm_fused` takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
``csrc/rmsnorm.cu`` or raises.  :data:`launches` counts kernel launches, so a
run can show that its path went through the kernel.  The Pallas kernel's
``block_rows`` / ``interpret`` have no counterpart: the CUDA kernel runs one
warp per row, 8 rows a block.

Training differentiates through :class:`RMSNormFunction`: its forward is
:func:`rms_norm_fused` (one kernel launch on the card) and its backward
:func:`rms_norm_bwd`, the closed form in plain torch.  The reference has no
backward kernel to port: its model trains through the jnp ``rms_norm``,
which XLA differentiates.

The split row (tensor parallelism: a rank holds a contiguous chunk of each
row's columns, as mamba2's gated norm over a ``d_inner`` sharded over
``"model"``): :func:`rms_norm_split` takes the row's sum of squares from
every rank of its group.  :func:`row_sumsq` (kernel ``rmsnorm_sumsq``) gives
the rank's float32 sums, the group sums them, and :func:`rms_norm_scaled`
(kernel ``rmsnorm_scaled``) normalises the rank's columns by the whole row's
mean; their plain versions are :func:`row_sumsq_ref` and
:func:`rms_norm_split_ref`.  Its backward (:class:`RMSNormSplitFunction`) is
``rms_norm_bwd``'s closed form with the row means taken over the group (one
more sum).  On a group of one it is :class:`RMSNormFunction`, one launch.
:data:`launches` counts every launch of the source; :data:`sumsq_launches`
and :data:`scaled_launches` the split row's two kernels apart.

Each of the three entries is one custom operator (``torch.ops.repro_torch.
rms_norm``, ``row_sumsq``, ``rms_norm_scaled``): on the CPU its plain
version, on a CUDA tensor one launch; its fake implementation gives the
output's shape, dtype and strides and launches nothing, so a dry run on
``meta`` or fake tensors traces the model through it.  Where nothing would
see the operator (``flash_attention.unobserved``: a plain CUDA tensor, no
dispatch mode) the wrapper launches directly, without the dispatcher's
host cost.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..spans import span
from . import _build
from .flash_attention import unobserved

__all__ = ["RMSNormFunction", "RMSNormSplitFunction", "rms_norm_bwd", "rms_norm_fused",
           "rms_norm_op", "rms_norm_ref", "rms_norm_scaled", "rms_norm_scaled_op",
           "rms_norm_split", "rms_norm_split_bwd", "rms_norm_split_ref", "row_sumsq", "row_sumsq_op",
           "row_sumsq_ref"]

# kernel launches since import (or since a caller last reset them to 0): every
# launch of csrc/rmsnorm.cu, and the split row's two kernels apart
launches = 0
sumsq_launches = 0
scaled_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2**31 - 1
_MAX_D = 56 * 1024  # the weight row, float32, in one block's shared memory


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                 plus_one: bool = False) -> torch.Tensor:
    """Row-wise ``x * rsqrt(mean(x^2) + eps) * w`` in float32, cast back to x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:  # gemma convention: scale = (1 + w)
        w = 1.0 + w
    return (y * w).to(x.dtype)


def row_sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of squares over the last axis: ``(...,)``."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def rms_norm_split_ref(x: torch.Tensor, weight: torch.Tensor, total: torch.Tensor, width: int,
                       eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """``x * rsqrt(total / width + eps) * w`` in float32, cast back to x's
    type: the columns ``x (..., d)`` of rows whose whole sum of squares is
    ``total (...,)`` over ``width`` values."""
    y = x.float() * torch.rsqrt(total.float()[..., None] / width + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor | None = None) -> None:
    for name, t in (("x", x), ("weight", weight)):
        if t is None:
            continue
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{name} must lie on the CPU or a CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() < 1:
        raise ValueError("x must have a last axis")
    if weight is not None:
        if weight.shape != x.shape[-1:]:
            raise ValueError(f"weight must be ({x.shape[-1]},), got {tuple(weight.shape)}")
        if weight.device != x.device:
            raise ValueError("x and weight must lie on one device")


def rms_norm_fused(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                   plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis of ``x (..., d)`` with ``weight (d,)``.

    float32 or bfloat16 ``x`` (the output has its type) and ``weight``, both
    contiguous, on one device.
    """
    _check(x, weight)
    if unobserved(x):
        return _launch(x, weight, float(eps), bool(plus_one))
    return rms_norm_op(x, weight, float(eps), bool(plus_one))


def row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Each row's float32 sum of squares over the last axis of a contiguous
    float32 or bfloat16 ``x (..., d)``: the kernel ``rmsnorm_sumsq`` on a
    CUDA tensor, :func:`row_sumsq_ref` on the CPU."""
    _check(x)
    if unobserved(x):
        return _launch_sumsq(x)
    return row_sumsq_op(x)


def rms_norm_scaled(x: torch.Tensor, weight: torch.Tensor, total: torch.Tensor, width: int,
                    eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """The columns ``x (..., d)`` of rows of ``width >= d`` values normalised
    by the whole row's sum of squares ``total (...,)`` (float32): the kernel
    ``rmsnorm_scaled`` on a CUDA tensor, :func:`rms_norm_split_ref` on the CPU."""
    _check(x, weight)
    if total.dtype != torch.float32 or total.shape != x.shape[:-1] or total.device != x.device:
        raise ValueError(f"total must be float32 {tuple(x.shape[:-1])} on x's device, got "
                         f"{total.dtype} {tuple(total.shape)} on {total.device}")
    if width < x.shape[-1]:
        raise ValueError(f"the whole row ({width}) is narrower than its columns ({x.shape[-1]})")
    if unobserved(x):
        return _launch(x, weight, float(eps), bool(plus_one), total.contiguous(), int(width))
    return rms_norm_scaled_op(x, weight, total.contiguous(), int(width), float(eps),
                              bool(plus_one))


@torch.library.custom_op("repro_torch::rms_norm", mutates_args=())
def rms_norm_op(x: torch.Tensor, weight: torch.Tensor, eps: float,
                plus_one: bool) -> torch.Tensor:
    """:func:`rms_norm_fused` as one operator (its arguments checked)."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps, plus_one)
    return _launch(x, weight, eps, plus_one)


@rms_norm_op.register_fake
def _rms_norm_fake(x, weight, eps, plus_one):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::row_sumsq", mutates_args=())
def row_sumsq_op(x: torch.Tensor) -> torch.Tensor:
    """:func:`row_sumsq` as one operator (its argument checked)."""
    if x.device.type == "cpu":
        return row_sumsq_ref(x)
    return _launch_sumsq(x)


@row_sumsq_op.register_fake
def _row_sumsq_fake(x):
    return x.new_empty(x.shape[:-1], dtype=torch.float32)


@torch.library.custom_op("repro_torch::rms_norm_scaled", mutates_args=())
def rms_norm_scaled_op(x: torch.Tensor, weight: torch.Tensor, total: torch.Tensor, width: int,
                       eps: float, plus_one: bool) -> torch.Tensor:
    """:func:`rms_norm_scaled` as one operator (its arguments checked)."""
    if x.device.type == "cpu":
        return rms_norm_split_ref(x, weight, total, width, eps, plus_one)
    return _launch(x, weight, eps, plus_one, total, width)


@rms_norm_scaled_op.register_fake
def _rms_norm_scaled_fake(x, weight, total, width, eps, plus_one):
    return torch.empty_like(x)


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, group, eps: float = 1e-6,
                   plus_one: bool = False) -> torch.Tensor:
    """RMSNorm of rows split over ``group`` (a ``tensor_parallel.Group``):
    ``x (..., d)`` and ``weight (d,)`` are this rank's contiguous chunk of
    every row's ``d * group.size`` columns, the mean taken over the whole row.
    Differentiable (:class:`RMSNormSplitFunction`); on a group of one it is
    :class:`RMSNormFunction`, one fused launch."""
    x, weight = x.contiguous(), weight.contiguous()
    if group.size == 1:
        return RMSNormFunction.apply(x, weight, eps, plus_one)
    return RMSNormSplitFunction.apply(x, weight, eps, plus_one, group)


def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                 plus_one: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx, dw)`` of RMSNorm for the output gradient ``g``.

    In float32, from the saved ``x`` (``r`` recomputed), cast back to each
    input's type: ``dx = r (g w' - x r^2 mean(g w' x))`` and ``dw = sum over
    rows of g x r``, with ``w' = w`` or ``1 + w``.
    """
    xf, gf = x.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    gw = gf * w
    dx = r * (gw - xf * (r * r) * (gw * xf).mean(dim=-1, keepdim=True))
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def rms_norm_split_bwd(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                       total: torch.Tensor, group, eps: float = 1e-6,
                       plus_one: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rms_norm_bwd` for a row split over ``group`` (:func:`rms_norm_split`):
    ``total`` is each whole row's sum of squares, and ``mean(g w' x)`` is taken
    over the whole row by one more sum over the group.  ``dw`` is this rank's
    chunk."""
    xf, gf = x.float(), g.float()
    width = x.shape[-1] * group.size
    r = torch.rsqrt(total[..., None] / width + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    gw = gf * w
    mean = group.all_reduce_sum((gw * xf).sum(dim=-1, keepdim=True)) / width
    dx = r * (gw - xf * (r * r) * mean)
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm that autograd sees: forward :func:`rms_norm_fused`, backward
    :func:`rms_norm_bwd` (``apply(x, weight, eps, plus_one)``)."""

    @staticmethod
    def forward(ctx, x, weight, eps, plus_one):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.plus_one = eps, plus_one
        return rms_norm_fused(x, weight, eps, plus_one)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with span("rmsnorm.backward"):
            dx, dw = rms_norm_bwd(g, x, weight, ctx.eps, ctx.plus_one)
        return dx, dw, None, None


class RMSNormSplitFunction(torch.autograd.Function):
    """RMSNorm of a row split over a group (``apply(x, weight, eps, plus_one,
    group)``): forward :func:`row_sumsq`, the group's sum, :func:`rms_norm_scaled`;
    backward :func:`rms_norm_split_bwd`.  ``dw`` is this rank's chunk."""

    @staticmethod
    def forward(ctx, x, weight, eps, plus_one, group):
        total = group.all_reduce_sum(row_sumsq(x))
        ctx.save_for_backward(x, weight, total)
        ctx.eps, ctx.plus_one, ctx.group = eps, plus_one, group
        return rms_norm_scaled(x, weight, total, x.shape[-1] * group.size, eps, plus_one)

    @staticmethod
    def backward(ctx, g):
        x, weight, total = ctx.saved_tensors
        dx, dw = rms_norm_split_bwd(g, x, weight, total, ctx.group, ctx.eps, ctx.plus_one)
        return dx, dw, None, None, None


@functools.cache
def _entry(name: str = "rmsnorm"):
    fn = getattr(_build.load("rmsnorm"), name)
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = {
        "rmsnorm": [vp] * 3 + [ll, i, f, i, i, i, i, vp],
        "rmsnorm_sumsq": [vp, vp, ll, i, i, i, vp],
        "rmsnorm_scaled": [vp] * 4 + [ll, i, ll, f, i, i, i, i, vp],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _rows(x: torch.Tensor) -> int:
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows > _MAX_ROWS:
        raise ValueError(f"rmsnorm kernel takes at most {_MAX_ROWS} rows")
    if d > _MAX_D:
        raise ValueError(f"rmsnorm kernel takes rows of at most {_MAX_D} values, got {d}")
    return rows


def _launch_sumsq(x: torch.Tensor) -> torch.Tensor:
    global launches, sumsq_launches
    total = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = _rows(x)
    if rows == 0:
        return total
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry("rmsnorm_sumsq")(x.data_ptr(), total.data_ptr(), rows, x.shape[-1],
                                      _DTYPE_CODES[x.dtype], int(x.data_ptr() % 16 == 0), stream)
    if err:
        raise RuntimeError(f"rmsnorm_sumsq kernel launch failed with CUDA error {err}")
    launches += 1
    sumsq_launches += 1
    return total


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool,
            total: torch.Tensor | None = None, width: int = 0) -> torch.Tensor:
    """The fused kernel, or with ``total`` its split-row form ``rmsnorm_scaled``."""
    global launches, scaled_launches
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = _rows(x)
    if rows == 0:
        return out
    # the kernel's 16-byte vector path needs both rows' starts on 16-byte boundaries
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    codes = (_DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], int(aligned))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if total is None:
            err = _entry()(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, eps,
                           int(plus_one), *codes, stream)
        else:
            err = _entry("rmsnorm_scaled")(x.data_ptr(), weight.data_ptr(), total.data_ptr(),
                                           out.data_ptr(), rows, d, width, eps, int(plus_one),
                                           *codes, stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    launches += 1
    if total is not None:
        scaled_launches += 1
    return out
