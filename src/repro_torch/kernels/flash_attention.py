"""Flash-attention forward: the CUDA kernel, its wrappers and its plain version.

Port of ``repro.kernels.flash_attention`` (the Pallas ``flash_attention_fwd``)
and of the model's ``repro.models.layers.flash_attention`` contract.  One
hand-written kernel (``csrc/flash_attention.cu``) serves both callers:

* :func:`attention` -- the model layout ``q (B, Sq, H, hd)``, ``k, v
  (B, Sk, KH, hd)`` with explicit int32 ``q_positions (B, Sq)`` and
  ``kv_positions (B, Sk)``; a slot with ``kv_positions < 0`` is invalid (an
  unwritten cache slot).  Behind :func:`repro_torch.models.layers.flash_attention`.
* :func:`flash_attention_fwd` -- the Pallas signature ``(B, H, S, hd)`` with
  implicit ``arange`` positions.

Each wrapper takes the plain PyTorch version (:func:`attention_ref`) only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.
The kernel reads every tensor through its (batch, seq, head) strides, so
neither layout is copied.  :data:`launches` counts kernel launches.  The
Pallas ``block_q`` / ``block_k`` / ``interpret`` have no counterpart: the
kernel's tiles are fixed (``csrc/flash_attention.cu``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

__all__ = ["NEG_INF", "attention", "attention_ref", "flash_attention_fwd"]

# kernel launches since import (or since a caller last reset it to 0)
launches = 0

NEG_INF = float(torch.finfo(torch.float32).min / 2)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
_MAX_GRID_YZ = 65535


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention in float32 over the visible slots; the kernel's plain version.

    ``q (B,Sq,H,hd)``, ``k/v (B,Sk,KH,hd)``; the same masks as the kernel,
    with the reference's finite ``NEG_INF`` for a masked score.
    """
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = kv_positions[:, None, :] >= 0  # (B,1,Sk): valid slots
    if causal:
        mask = mask & (kv_positions[:, None, :] <= q_positions[:, :, None])
    if window is not None:
        mask = mask & (q_positions[:, :, None] - kv_positions[:, None, :] < window)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _check(q, k, v, q_positions, kv_positions, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share one device and dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q must lie on the CPU or a CUDA device, got {q.device}")
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B={b}, Sk, KH, hd={hd}); got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({kh})")
    for name, t, shape in (("q_positions", q_positions, (b, sq)),
                           ("kv_positions", kv_positions, (b, sk))):
        if t.shape != shape or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name} must be int32 {shape} on q's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention in the model layout with explicit positions -> ``(B, Sq, H, hd)``.

    Works for training (Sq == Sk), prefill and single-token decode against a
    cache (Sq == 1, Sk == cache length, ``kv_positions`` -1 where unwritten).
    """
    _check(q, k, v, q_positions, kv_positions, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_positions, kv_positions, causal, window, scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, q_positions, kv_positions, out, causal, window, scale)


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KH, Sk, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The Pallas entry's contract: ``(B, H, S, hd)`` layout, positions ``arange``.

    Query ``i`` sits at position ``i`` and key ``j`` at ``j``; the same kernel
    as :func:`attention`, reading the head-major tensors through their strides.
    """
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    dev = q.device
    qpos = torch.arange(sq, dtype=torch.int32, device=dev).expand(b, sq).contiguous()
    kpos = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk).contiguous()
    qm, km, vm = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    _check(qm, km, vm, qpos, kpos, window)
    if dev.type == "cpu":
        return attention_ref(qm, km, vm, qpos, kpos, causal, window, scale).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(qm, km, vm, qpos, kpos, out.transpose(1, 2), causal, window, scale)
    return out


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, q_positions, kv_positions, out, causal, window, scale) -> torch.Tensor:
    """Launch on ``(B, S, H, hd)``-indexed views (any strides, hd contiguous)."""
    global launches
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("attention over an empty key sequence")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ or max(sq, sk) > _INT_MAX:
        raise ValueError("attention kernel takes B, H <= 65535 and sequences < 2**31")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dims = (ctypes.c_longlong * 6)(b, sq, sk, h, kh, hd)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), ctypes.addressof(dims),
            ctypes.addressof(strides), float(scale), int(bool(causal)),
            0 if window is None else int(window), _DTYPE_CODES[q.dtype], stream,
        )
    if err:
        raise RuntimeError(f"flash-attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out
