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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["RMSNormFunction", "rms_norm_bwd", "rms_norm_fused", "rms_norm_ref"]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

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


def rms_norm_fused(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                   plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis of ``x (..., d)`` with ``weight (d,)``.

    float32 or bfloat16 ``x`` (the output has its type) and ``weight``, both
    contiguous, on one device.
    """
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} must lie on the CPU or a CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() < 1 or weight.shape != x.shape[-1:]:
        raise ValueError(f"weight must be ({x.shape[-1] if x.dim() else '?'},), got "
                         f"{tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError("x and weight must lie on one device")
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps, plus_one)
    return _launch(x, weight, float(eps), bool(plus_one))


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
        dx, dw = rms_norm_bwd(g, x, weight, ctx.eps, ctx.plus_one)
        return dx, dw, None, None


@functools.cache
def _entry():
    fn = _build.load("rmsnorm").rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool) -> torch.Tensor:
    global launches
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    if rows > _MAX_ROWS:
        raise ValueError(f"rmsnorm kernel takes at most {_MAX_ROWS} rows")
    if d > _MAX_D:
        raise ValueError(f"rmsnorm kernel takes rows of at most {_MAX_D} values, got {d}")
    # the kernel's 16-byte vector path needs both rows' starts on 16-byte boundaries
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, eps, int(plus_one),
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype], int(aligned), stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    launches += 1
    return out
