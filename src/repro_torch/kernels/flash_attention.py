"""Flash-attention forward: the CUDA kernels, their wrappers and their plain versions.

Port of ``repro.kernels.flash_attention`` (the Pallas ``flash_attention_fwd``)
and of the model's ``repro.models.layers.flash_attention`` contract.  Three
hand-written kernels (``csrc/flash_attention.cu``) compute one function and
serve both callers:

* :func:`attention` -- the model layout ``q (B, Sq, H, hd)``, ``k, v
  (B, Sk, KH, hd)`` with explicit int32 ``q_positions (B, Sq)`` and
  ``kv_positions (B, Sk)``; a slot with ``kv_positions < 0`` is invalid (an
  unwritten cache slot).  Behind :func:`repro_torch.models.layers.flash_attention`.
* :func:`flash_attention_fwd` -- the Pallas signature ``(B, H, S, hd)`` with
  implicit ``arange`` positions.

:func:`route` picks the kernel of each call: the split-KV decode kernel when
the query rows of a kv group are few, the tensor-core (wgmma) kernel for a
bf16 prefill, and the CUDA-core kernel for a float32 prefill or rows that are
not 16-byte aligned.  Each wrapper takes the plain PyTorch version
(:func:`attention_ref`) only for a tensor on the CPU.  For a CUDA tensor it
launches one kernel or raises.  The kernels read every tensor through its
(batch, seq, head) strides, so neither layout is copied.  :data:`launches`
counts kernel launches, and :data:`splitkv_launches`,
:data:`wgmma_launches` and :data:`simt_launches` count them by kernel.
:func:`attention_splitkv_ref` is the split-KV kernel's arithmetic in plain
PyTorch (per-split partials and their merge), which the tests hold to the
reference.  The Pallas ``block_q`` / ``block_k`` / ``interpret`` have no
counterpart: the kernels' tiles are fixed.

Both entries go through one custom operator, ``torch.ops.repro_torch.attention``
(:func:`attention_op`), so a dispatch mode sees each kernel call as one op.
Its fake implementation gives the output's shape, dtype and strides and
launches nothing (a dry run on ``meta`` or fake tensors traces the model
through it); its FLOP formula (``torch.utils.flop_counter``) counts it
dense, as torch's own ``scaled_dot_product_attention`` formula does.  Where
nothing would see the operator (:func:`unobserved`) the wrapper launches
the same kernel directly, without the dispatcher's host cost.
:func:`attention_route` gives the kernel a call takes from its tensors
alone, ``meta`` and fake ones included.

Training differentiates through :class:`AttentionFunction`: its forward is
the operator (one kernel launch on the card).  Where autograd will need it
and the backward kernels take the call, the wgmma kernel also writes each
row's log-sum-exp ``lse (B, H, Sq)`` in float32 (:func:`attention_with_lse`,
operator ``torch.ops.repro_torch.attention_lse``); serving, prefill and
decode ask for none and launch exactly as without it.  The backward's route
(:func:`backward_route`) sends a call with that ``lse``, bf16, aligned rows
and ``hd`` a multiple of 8 up to :data:`BWD_MAX_HEAD_DIM` to the hand-written
backward (``csrc/flash_bwd.cuh``: ``delta = rowsum(dO o O)``, then a dK / dV
kernel over key tiles and a dQ kernel over query tiles, FlashAttention-2 on
wgmma with ``P`` recomputed tile by tile from ``lse``, bf16 operands and
float32 sums, no float atomics: bitwise one output for one input), counted
in :data:`bwd_launches`, one a call.  It goes through its own operator,
``torch.ops.repro_torch.attention_backward`` (:func:`attention_backward`,
fake implementation and FLOP formula beside the forward's), or launches
directly where nothing observes it.  Every other call -- the CPU, float32,
unaligned rows, a wider head -- takes :func:`attention_bwd`, the closed form
in plain torch over the saved inputs and output.  The two differ for a query
row that sees no key (every key invalid or masked; none in training, where
each query sees at least its own key): the forward averages such a row over
the masked keys (``NEG_INF``), the closed form spreads its gradient over
them, and the kernels give it none -- their gradients are the closed form's
with that row's ``dO`` set to zero.
:func:`attention_bwd_tiled_ref` is the kernels' arithmetic tile by tile in
plain torch, which the tests hold to :func:`attention_bwd`.  The reference
has no backward kernel to port: its model trains through the jnp
``flash_attention``, which XLA differentiates.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from ..spans import span
from . import _build

__all__ = ["BWD_MAX_HEAD_DIM", "H100_SM_COUNT", "NEG_INF", "AttentionFunction", "attention",
           "attention_backward", "attention_backward_op", "attention_bwd",
           "attention_bwd_flops", "attention_bwd_tiled_ref", "attention_flops",
           "attention_lse_op", "attention_lse_ref", "attention_op", "attention_ref",
           "attention_route", "attention_with_lse",
           "attention_splitkv_ref", "backward_route", "flash_attention_fwd", "route",
           "sm_count", "splitkv_plan"]

# forward kernel launches since import (or since a caller last reset it to 0):
# all of them, and by kernel; and the backward kernels' calls (three launches each)
launches = 0
splitkv_launches = 0
wgmma_launches = 0
simt_launches = 0
bwd_launches = 0

NEG_INF = float(torch.finfo(torch.float32).min / 2)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
_MAX_GRID_YZ = 65535
# the split-KV kernel takes at most this many query rows per kv head
# (Sq * H / KH): a lane keeps float32 accumulators for all of them in registers
SPLITKV_MAX_ROWS = 16
SPLITKV_MIN_KEYS = 16     # slots a split at least
SPLITKV_MAX_SPLITS = 256  # the merge keeps one weight per split and row in shared memory
WGMMA_MAX_KEYS = 64 * 32 * 64  # the wgmma kernel's tile-skip bits cover this many keys
# the backward kernels keep dK and dV of 64 keys x hd in float32 registers
BWD_MAX_HEAD_DIM = 128
# the SMs of the card the port targets, for a call on meta or fake tensors
# (no card to ask): 132 on the H100 SXM5 (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper); chip_smoke.py's phase 20 checks it against
# torch.cuda.get_device_properties(0).multi_processor_count
H100_SM_COUNT = 132


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
    mask = _visible(q_positions, kv_positions, causal, window)  # (B, Sq, Sk)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _visible(q_positions, kv_positions, causal, window) -> torch.Tensor:
    """(B, Sq, Sk): key j visible to query i."""
    mask = kv_positions[:, None, :] >= 0
    if causal:
        mask = mask & (kv_positions[:, None, :] <= q_positions[:, :, None])
    if window is not None:
        mask = mask & (q_positions[:, :, None] - kv_positions[:, None, :] < window)
    return mask


def attention_splitkv_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    n_split: int = 1,
) -> torch.Tensor:
    """The split-KV decode kernel's arithmetic in float32, for the tests.

    The slots are cut into ``ceil(Sk / chunk)`` splits of ``chunk =
    ceil(Sk / n_split)``.  Each split gives its softmax partials ``m`` (max
    score), ``l`` (sum of ``exp(s - m)``) and ``acc`` (that sum over V), the
    masked scores at ``NEG_INF``.  A split none of whose keys any query of the
    batch row can see (``kv >= 0``, ``kv <= max q`` if causal, ``min q - kv <
    window``) is skipped: ``m = NEG_INF``, ``l = 0``.  The merge weighs each
    split by ``exp(m_s - max m)`` where ``l_s > 0`` and returns ``sum w acc /
    max(sum w l, 1e-30)``.
    """
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if not 1 <= n_split <= sk:
        raise ValueError(f"n_split must be in [1, Sk={sk}], got {n_split}")
    chunk = -(-sk // n_split)
    qg = q.reshape(b, sq, kh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale  # (B, KH, g, Sq, Sk)
    s = torch.where(_visible(q_positions, kv_positions, causal, window)[:, None, None], s,
                    NEG_INF)
    q_lo = q_positions.amin(dim=1, keepdim=True)
    q_hi = q_positions.amax(dim=1, keepdim=True)
    relevant = kv_positions >= 0  # (B, Sk): visible to the block's range of queries
    if causal:
        relevant = relevant & (kv_positions <= q_hi)
    if window is not None:
        relevant = relevant & (q_lo - kv_positions < window)
    ms, ls, accs = [], [], []
    for lo in range(0, sk, chunk):
        sl = slice(lo, min(sk, lo + chunk))
        m = s[..., sl].amax(dim=-1)
        p = torch.exp(s[..., sl] - m[..., None])
        l_ = p.sum(dim=-1)
        acc = torch.einsum("bkgqs,bskd->bkgqd", p, v[:, sl].float())
        keep = relevant[:, sl].any(dim=1)[:, None, None, None]  # (B, 1, 1, 1)
        ms.append(torch.where(keep, m, NEG_INF))
        ls.append(torch.where(keep, l_, 0.0))
        accs.append(torch.where(keep[..., None], acc, 0.0))
    m, l_, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.where(l_ > 0, torch.exp(m - m.amax(dim=0)), 0.0)
    out = (w[..., None] * acc).sum(dim=0) / (w * l_).sum(dim=0).clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores over the visible keys,
    ``(B, H, Sq)`` float32: what the wgmma forward writes for the backward."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, h // kh, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = _visible(q_positions, kv_positions, causal, window)[:, None, None]
    return torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1).reshape(b, h, sq)


def attention_bwd_tiled_ref(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    tile: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in float32, tile by tile, for the tests.

    ``lse (B, H, Sq)`` is the forward's (:func:`attention_lse_ref`);
    ``delta = rowsum(dO o O)``.  dK and dV by key tile: for each of the kv
    group's query heads in order and each query tile, ``P^T = exp(scale S^T
    - lse)`` where visible (else 0), ``dP^T = V dO^T``, ``dS^T = P^T (dP^T -
    delta)``, ``dV += P^T dO``, ``dK += dS^T Q``.  dQ by query tile over the
    key tiles: ``dQ += dS K``.  ``P`` and ``dS`` are rounded to q's dtype as
    operands of the products that take them (bf16 on the kernels' path,
    nothing in float32); ``dK`` and ``dQ`` are scaled at the end.  A row that
    sees no key (none in training, where each query sees itself) gets no
    gradient here, where :func:`attention_bwd` spreads it over every key
    (:func:`backward_route`'s precondition).
    """
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Sq)
    lse = lse.float()
    vis = _visible(q_positions, kv_positions, causal, window).expand(b, sq, sk)

    def operand(x):
        return x.to(q.dtype).float()

    def tile_grads(qs, ks, hq):
        """(P, dS) of one (query tile, key tile, head), (B, tq, tk)."""
        s = torch.einsum("bqd,bkd->bqk", qf[:, qs, hq], kf[:, ks, hq // g]) * scale
        p = torch.where(vis[:, qs, ks], torch.exp(s - lse[:, hq, qs, None]), 0.0)
        dp = torch.einsum("bqd,bkd->bqk", dof[:, qs, hq], vf[:, ks, hq // g])
        return p, p * (dp - delta[:, hq, qs, None])

    def tiles(n):
        return [slice(i, min(n, i + tile)) for i in range(0, n, tile)]

    dq = torch.zeros(b, sq, h, hd)
    dk = torch.zeros(b, sk, kh, hd)
    dv = torch.zeros(b, sk, kh, hd)
    for ks in tiles(sk):
        for kvh in range(kh):
            for qs in tiles(sq):
                for hq in range(kvh * g, (kvh + 1) * g):
                    p, ds = tile_grads(qs, ks, hq)
                    dv[:, ks, kvh] += torch.einsum("bqk,bqd->bkd", operand(p), dof[:, qs, hq])
                    dk[:, ks, kvh] += torch.einsum("bqk,bqd->bkd", operand(ds), qf[:, qs, hq])
    for qs in tiles(sq):
        for hq in range(h):
            for ks in tiles(sk):
                _, ds = tile_grads(qs, ks, hq)
                dq[:, qs, hq] += torch.einsum("bqk,bkd->bqd", operand(ds), kf[:, ks, hq // g])
    return (dq.mul_(scale).to(q.dtype), dk.mul_(scale).to(k.dtype), dv.to(v.dtype))


def route(dtype: torch.dtype, sq: int, h: int, kh: int, hd: int, sk: int,
          aligned: bool) -> str:
    """The kernel a call on the card launches: ``"splitkv"``, ``"wgmma"`` or ``"simt"``.

    ``aligned``: every row of q, k, v and the output starts on a 16-byte
    boundary, which the split-KV and wgmma kernels' vector loads need.
    """
    if aligned and sq * (h // kh) <= SPLITKV_MAX_ROWS:
        return "splitkv"
    if aligned and dtype == torch.bfloat16 and hd % 8 == 0 and sk <= WGMMA_MAX_KEYS:
        return "wgmma"
    return "simt"


def splitkv_plan(b: int, kh: int, sk: int, n_sms: int) -> tuple[int, int]:
    """``(n_split, chunk)`` for the split-KV kernel: enough blocks
    (``b * kh * n_split``) to cover ``n_sms`` SMs, at least
    :data:`SPLITKV_MIN_KEYS` slots a split, every split non-empty."""
    n = max(1, min(sk // SPLITKV_MIN_KEYS, -(-n_sms // (b * kh)), SPLITKV_MAX_SPLITS))
    chunk = -(-sk // n)
    return -(-sk // chunk), chunk


def _shape_only(t: torch.Tensor) -> bool:
    """A tensor with no data: a ``meta`` tensor, or a fake one (``FakeTensorMode``)."""
    return t.device.type == "meta" or is_fake(t)


def _address(t: torch.Tensor) -> int:
    """``t``'s data pointer; for a tensor with no data its byte offset into
    its storage, a fresh allocation starting on the allocator's (512-byte)
    boundary."""
    return t.storage_offset() * t.element_size() if _shape_only(t) else t.data_ptr()


def _rows_aligned(*tensors: torch.Tensor) -> bool:
    """Each tensor's data and every (batch, seq, head) step of more than one
    index on 16-byte boundaries, and hd * itemsize a multiple of 16."""
    for t in tensors:
        size = t.element_size()
        if _address(t) % 16 or (t.shape[-1] * size) % 16:
            return False
        if any(n > 1 and (st * size) % 16 for n, st in zip(t.shape[:3], t.stride()[:3])):
            return False
    return True


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
    if q.device.type not in ("cpu", "cuda", "meta"):
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
    if unobserved(q):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return _launch(q, k, v, q_positions, kv_positions, out, causal, window, scale)
    return attention_op(q, k, v, q_positions, kv_positions, causal, window, scale, False)


def attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention` and each row's log-sum-exp ``lse (B, H, Sq)`` in
    float32 (:func:`attention_lse_ref`), for a call that takes the wgmma
    kernel (on the CPU: the plain versions), through
    ``torch.ops.repro_torch.attention_lse`` or a direct launch."""
    _check(q, k, v, q_positions, kv_positions, window)
    if unobserved(q):
        return _launch_with_lse(q, k, v, q_positions, kv_positions, causal, window, scale)
    return attention_lse_op(q, k, v, q_positions, kv_positions, causal, window, scale)


def unobserved(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` may launch without the dispatcher: a plain CUDA
    tensor (no subclass: fake, DTensor) and no Python dispatch mode on
    (``FlopCounterMode``, ``FakeTensorMode``, ``launch/step_stats.StepStats``),
    so nothing would see the operator.  Dispatching the operator cost 11 to
    61 µs of host time a call more than the direct launch at decode shapes
    (``chip_smoke.py`` phase 20, NVIDIA H100 80GB HBM3 at 700.00 W), and
    decode is host-bound."""
    return type(t) is torch.Tensor and t.is_cuda and _get_current_dispatch_mode() is None


@torch.library.custom_op("repro_torch::attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
                 kv_positions: torch.Tensor, causal: bool, window: Optional[int],
                 scale: Optional[float], head_major: bool) -> torch.Tensor:
    """The kernel call as one operator, on the model layout's (batch, seq,
    head) views: the output ``(B, Sq, H, hd)``, or ``(B, H, Sq, hd)`` with
    ``head_major``, contiguous.  On the CPU the plain version; on a CUDA
    tensor one launch (:func:`attention_route` picks the kernel)."""
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, q_positions, kv_positions, causal, window, scale)
        # the strides of a fresh allocation, as on the card (a size-1 dim's too)
        return (out.transpose(1, 2) if head_major else out).clone(
            memory_format=torch.contiguous_format)
    b, sq, h, hd = q.shape
    out = torch.empty((b, h, sq, hd) if head_major else q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, q_positions, kv_positions, out.transpose(1, 2) if head_major else out,
            causal, window, scale)
    return out


@attention_op.register_fake
def _attention_fake(q, k, v, q_positions, kv_positions, causal, window, scale, head_major):
    b, sq, h, hd = q.shape
    return q.new_empty((b, h, sq, hd) if head_major else (b, sq, h, hd))


@torch.library.custom_op("repro_torch::attention_lse", mutates_args=())
def attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor, causal: bool,
                     window: Optional[int], scale: Optional[float]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward as one operator: the output ``(B, Sq, H, hd)``
    and ``lse (B, H, Sq)`` float32, contiguous.  On the CPU the plain
    versions; on a CUDA tensor one launch of the wgmma kernel."""
    # the program never sends a CPU call here (AttentionFunction asks for lse
    # only off the CPU); this branch exists for opcheck and the CPU tests
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, q_positions, kv_positions, causal, window, scale)
        return (out.contiguous(),
                attention_lse_ref(q, k, q_positions, kv_positions, causal, window, scale))
    return _launch_with_lse(q, k, v, q_positions, kv_positions, causal, window, scale)


@attention_lse_op.register_fake
def _attention_lse_fake(q, k, v, q_positions, kv_positions, causal, window, scale):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


def _launch_with_lse(q, k, v, q_positions, kv_positions, causal, window, scale):
    b, sq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, q_positions, kv_positions, out, causal, window, scale, lse)
    return out, lse


def attention_flops(b: int, sq: int, h: int, sk: int, hd: int) -> int:
    """The FLOPs of one call counted dense (every query against every key,
    masked or not): ``Q K^T`` and ``P V``, two products of ``2 b h sq sk hd``,
    as torch's ``scaled_dot_product_attention`` formula counts them."""
    return 4 * b * h * sq * sk * hd


@register_flop_formula([torch.ops.repro_torch.attention, torch.ops.repro_torch.attention_lse])
def _attention_flop_formula(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    b, sq, h, hd = q_shape
    return attention_flops(b, sq, h, k_shape[1], hd)


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lse: Optional[torch.Tensor]) -> str:
    """The backward a call takes: ``"kernels"`` (``csrc/flash_bwd.cuh``) or
    ``"plain"`` (:func:`attention_bwd`).

    The kernels take a call whose forward wrote ``lse`` (it took the wgmma
    kernel), in bf16, with 16-byte aligned rows and ``hd`` a multiple of 8 up
    to :data:`BWD_MAX_HEAD_DIM`, on a tensor that is not on the CPU (``meta``
    and fake ones included, for the dry run).  The output is a fresh
    allocation; :func:`attention_backward` copies a ``dO`` whose rows are
    not aligned.

    Precondition for the kernels to match :func:`attention_bwd`: every query
    row sees at least one key.  A row that sees none (its keys all invalid,
    ``kv_positions < 0``, or masked) gets no gradient from the kernels, where
    the closed form spreads it over the masked keys; the route reads no
    positions (that would cost a device sync), so a padded or packed batch
    with such rows gets the kernels' gradients.
    """
    return "kernels" if lse is not None and _bwd_kernels_take(q, k, v) else "plain"


def _bwd_kernels_take(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the backward kernels take these tensors, given the forward's ``lse``."""
    hd = q.shape[-1]
    return (q.device.type != "cpu" and q.dtype == torch.bfloat16 and hd % 8 == 0
            and hd <= BWD_MAX_HEAD_DIM and _rows_aligned(q, k, v))


def attention_backward(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` by the backward kernels, for a call
    :func:`backward_route` sends to them: a direct launch where nothing
    observes it (:func:`unobserved`), else the operator."""
    if do.stride(-1) != 1 or not _rows_aligned(do):
        do = do.contiguous()
    if unobserved(q):
        return _launch_bwd(do, q, k, v, out, lse, q_positions, kv_positions, causal, window,
                           scale)
    return attention_backward_op(do, q, k, v, out, lse, q_positions, kv_positions, causal,
                                 window, scale)


@torch.library.custom_op("repro_torch::attention_backward", mutates_args=())
def attention_backward_op(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor, q_positions: torch.Tensor,
                          kv_positions: torch.Tensor, causal: bool, window: Optional[int],
                          scale: Optional[float]) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """The backward kernels' call as one operator: ``(dq, dk, dv)``,
    contiguous, in the inputs' dtypes.  On the CPU the plain version
    (:func:`attention_bwd`; ``lse`` unread); on a CUDA tensor the kernels."""
    # the program never sends a CPU call here (backward_route sends only a
    # tensor off the CPU); this branch exists for opcheck and the CPU tests
    if q.device.type == "cpu":
        return tuple(t.contiguous() for t in attention_bwd(
            do, q, k, v, out, q_positions, kv_positions, causal, window, scale))
    return _launch_bwd(do, q, k, v, out, lse, q_positions, kv_positions, causal, window, scale)


@attention_backward_op.register_fake
def _attention_backward_fake(do, q, k, v, out, lse, q_positions, kv_positions, causal, window,
                             scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def attention_bwd_flops(b: int, sq: int, h: int, sk: int, hd: int) -> int:
    """The backward's FLOPs counted dense, as :func:`attention_bwd`'s
    products count on a dispatch mode: five of ``2 b h sq sk hd`` (``P``
    again, ``dV``, ``dP``, ``dQ``, ``dK``).  The kernels form ``S`` and ``dP``
    once more in the dQ pass; that work is not counted."""
    return 10 * b * h * sq * sk * hd


@register_flop_formula(torch.ops.repro_torch.attention_backward)
def _attention_backward_flop_formula(do_shape, q_shape, k_shape, *args, out_shape=None,
                                     **kwargs) -> int:
    b, sq, h, hd = q_shape
    return attention_bwd_flops(b, sq, h, k_shape[1], hd)


def attention_bwd(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`attention` for the output gradient ``do``.

    In float32 over the saved inputs and output: ``P`` recomputed under the
    kernel's mask (``NEG_INF`` for a hidden score), ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - rowsum(dO O))`` (zero where hidden),
    ``dQ = scale dS K``, ``dK = scale dS^T Q``; ``dK`` and ``dV`` summed over
    each kv head's group of query heads, each cast to its input's type.
    """
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd).float()
    kf, vf = k.float(), v.float()
    mask = _visible(q_positions, kv_positions, causal, window)[:, None, None]  # (B,1,1,Sq,Sk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    dog = do.reshape(b, sq, kh, g, hd).float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    delta = (dog * out.reshape(b, sq, kh, g, hd).float()).sum(dim=-1)  # (B,Sq,KH,g)
    ds = torch.where(mask, p * (dp - delta.permute(0, 2, 3, 1)[..., None]), 0.0)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class AttentionFunction(torch.autograd.Function):
    """Attention that autograd sees: forward :func:`attention`, backward the
    kernels or :func:`attention_bwd` by :func:`backward_route`
    (``apply(q, k, v, q_positions, kv_positions, causal, window, scale)``).

    The forward asks the wgmma kernel for ``lse`` only where autograd will
    run the backward: grad mode on and q, k or v requiring grad, read in
    :meth:`apply` (``forward`` runs with grad mode off).
    """

    @classmethod
    def apply(cls, q, k, v, q_positions, kv_positions, causal, window, scale):
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
        return super().apply(q, k, v, q_positions, kv_positions, causal, window, scale, grad)

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window, scale, grad):
        lse = None
        if grad and _bwd_kernels_take(q, k, v) and attention_route(q, k, v) == "wgmma":
            out, lse = attention_with_lse(q, k, v, q_positions, kv_positions, causal, window,
                                          scale)
        else:
            out = attention(q, k, v, q_positions, kv_positions, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, q_positions, kv_positions, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, q_positions, kv_positions, lse = ctx.saved_tensors
        with span("attention.backward"):
            if backward_route(q, k, v, lse) == "kernels":
                dq, dk, dv = attention_backward(do, q, k, v, out, lse, q_positions,
                                                kv_positions, ctx.causal, ctx.window, ctx.scale)
            else:
                dq, dk, dv = attention_bwd(do, q, k, v, out, q_positions, kv_positions,
                                           ctx.causal, ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None


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
    if unobserved(q):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
        _launch(qm, km, vm, qpos, kpos, out.transpose(1, 2), causal, window, scale)
        return out
    return attention_op(qm, km, vm, qpos, kpos, causal, window, scale, True)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_simt.argtypes = [ptr] * 8 + [f32, i32, i32, i32, ptr]
    lib.flash_attention_splitkv.argtypes = [ptr] * 10 + [f32, i32, i32, i32, i32, i32, ptr]
    lib.flash_attention_wgmma.argtypes = [ptr] * 9 + [f32, i32, i32, ptr]
    lib.flash_attention_bwd.argtypes = [ptr] * 14 + [f32, i32, i32, ptr]
    for fn in (lib.flash_attention_simt, lib.flash_attention_splitkv, lib.flash_attention_wgmma,
               lib.flash_attention_bwd):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the card ``t`` lies on; :data:`H100_SM_COUNT` for a tensor
    with no data (``meta`` or fake: no card to ask)."""
    return H100_SM_COUNT if _shape_only(t) else _sm_count(t.device.index)


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel :func:`attention_op` launches for these (batch, seq, head)
    views: :func:`route` of their shapes and alignment (the output is a fresh
    allocation, aligned wherever ``hd * itemsize`` is a multiple of 16).
    Needs no card: a ``meta`` or fake tensor's alignment is its offset into
    its storage."""
    b, sq, h, hd = q.shape
    return route(q.dtype, sq, h, k.shape[2], hd, k.shape[1], _rows_aligned(q, k, v))


# the split-KV kernel's tickets, one int32 per (b, kv head), by (device, stream):
# zero between launches (the kernel returns each to zero), so they are kept
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def _launch(q, k, v, q_positions, kv_positions, out, causal, window, scale,
            lse=None) -> torch.Tensor:
    """Launch on ``(B, S, H, hd)``-indexed views (any strides, hd contiguous);
    the wgmma kernel fills ``lse`` where given."""
    global launches, splitkv_launches, wgmma_launches, simt_launches
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
    path = attention_route(q, k, v)
    if lse is not None and path != "wgmma":
        raise ValueError(f"only the wgmma kernel writes lse: the call takes {path}")
    dims = (ctypes.c_longlong * 6)(b, sq, sk, h, kh, hd)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr())
    common = (float(scale), int(bool(causal)), 0 if window is None else int(window))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if path == "splitkv":
            n_split, chunk = splitkv_plan(b, kh, sk, sm_count(q))
            rows = 8 if sq * (h // kh) <= 8 else SPLITKV_MAX_ROWS
            part = torch.empty(b * kh * n_split * rows * (2 + hd), dtype=torch.float32,
                               device=q.device)
            tickets = _tickets_for(q.device, stream, b * kh)
            err = lib.flash_attention_splitkv(
                *ptrs, part.data_ptr(), tickets.data_ptr(), ctypes.addressof(dims),
                ctypes.addressof(strides), *common, n_split, chunk, _DTYPE_CODES[q.dtype], stream)
        elif path == "wgmma":
            err = lib.flash_attention_wgmma(*ptrs, None if lse is None else lse.data_ptr(),
                                            ctypes.addressof(dims), ctypes.addressof(strides),
                                            *common, stream)
        else:
            err = lib.flash_attention_simt(*ptrs, ctypes.addressof(dims),
                                           ctypes.addressof(strides), *common,
                                           _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash-attention {path} kernel launch failed with CUDA error {err}")
    launches += 1
    if path == "splitkv":
        splitkv_launches += 1
    elif path == "wgmma":
        wgmma_launches += 1
    else:
        simt_launches += 1
    return out


def _launch_bwd(do, q, k, v, out, lse, q_positions, kv_positions, causal, window, scale):
    """The backward kernels on ``(B, S, H, hd)``-indexed views (any strides,
    hd contiguous, rows 16-byte aligned): ``(dq, dk, dv)``, fresh."""
    global bwd_launches
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if max(sq, sk) > WGMMA_MAX_KEYS:
        raise ValueError(f"the backward kernels take Sq, Sk <= {WGMMA_MAX_KEYS}")
    if not _rows_aligned(do, out):
        raise ValueError("the backward kernels need dO and the output's rows 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dims = (ctypes.c_longlong * 6)(b, sq, sk, h, kh, hd)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, do, dq, dk, dv) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), q_positions.data_ptr(), kv_positions.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), ctypes.addressof(dims),
            ctypes.addressof(strides), float(scale), int(bool(causal)),
            0 if window is None else int(window), stream)
    if err:
        raise RuntimeError(f"flash-attention backward kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv
