"""Counter-based Philox4x32-10 in plain PyTorch: the frontier's random stream.

The port's counterpart of the reference's ``fold_in(key(seed), rep)``
(``repro.cluster.vectorized.frontier_job_times``): every replica time of a
frontier pass is a pure function of (seed, candidate, rep, slot), so a rep's
row is the same whichever range of reps a call covers, and ``rep_chunk`` is
bit-identical under any chunking.  ``csrc/philox.cuh`` is the same stream on
the card, drawn inside the cover kernel (``kernels/cover.py::
frontier_sample_cover``); this module is its plain version, bit for bit.

The stream:

* key ``(seed mod 2**32, (seed >> 32) mod 2**32)``;
* for candidate row ``c``, absolute rep ``k`` and slot ``j``, the counter
  ``(j // P, k, c, 0)``, whose four output words serve ``P`` consecutive
  slots: ``P = 4`` (one 32-bit word a draw) for float32 draws and for
  :data:`EMPIRICAL` in either dtype, ``P = 2`` (two words a draw) for float64
  draws of a continuous law;
* a float32 uniform from word ``w``: ``((w >> 9) | 0x3f800000)`` read as a
  float, minus 1 (the construction of ``jax.random.uniform``), in [0, 1);
* a float64 uniform from words ``(a, b) = (w[2 (j % 2)], w[2 (j % 2) + 1])``:
  the 52 bits ``(a << 20) | (b >> 12)`` under the exponent of 1.0, minus 1;
* an :data:`EMPIRICAL` index from word ``w``: ``(w * n) >> 32``, which is
  biased by at most ``n / 2**32`` from uniform over the ``n`` entries.

The laws and their constants ``(a, b)`` (:meth:`ServiceTime.philox_law`), in
the order the torch samplers of ``core/service_time.py`` compute them:

* :data:`EXPONENTIAL`: ``log1p(-u) / a`` with ``a = -mu``;
* :data:`SHIFTED_EXPONENTIAL`: ``log1p(-u) / a + b`` with ``a = -mu``,
  ``b = delta``;
* :data:`PARETO`: ``(1 - u) ** a * b`` with ``a = -1 / alpha``,
  ``b = sigma``; ``1 - u`` lies in (0, 1], so the draw stays finite;
* :data:`EMPIRICAL`: ``table[index]``.

Words are held in ``int64`` tensors (torch has no full ``uint32``
arithmetic).  The 32 x 32 -> 64-bit product of a Philox round does not fit a
signed 64-bit integer, so :func:`_mulhilo` splits the constant into 16-bit
halves.
"""
from __future__ import annotations

import torch

__all__ = [
    "EMPIRICAL",
    "EXPONENTIAL",
    "PARETO",
    "SHIFTED_EXPONENTIAL",
    "draws",
    "draws_per_counter",
    "key_of",
    "philox4x32_10",
    "stream_words",
    "transform",
    "uniforms",
]

EXPONENTIAL, SHIFTED_EXPONENTIAL, PARETO, EMPIRICAL = range(4)

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) increments


def key_of(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low words of ``a * m`` for 32-bit ``a`` (int64 tensor) and ``m``."""
    p_lo = a * (m & 0xFFFF)  # < 2**48
    p_hi = a * (m >> 16)  # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # a * m = (p_hi >> 16) * 2**32 + t
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 of four counter words under two key words.

    ``ctr`` is four int64 tensors (or ints) broadcastable together, each in
    [0, 2**32); ``key`` two ints.  Returns the four output words as int64
    tensors of the broadcast shape.
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def draws_per_counter(code: int, dtype: torch.dtype) -> int:
    """Slots one counter serves: 2 for float64 draws of a continuous law, else 4."""
    return 2 if dtype == torch.float64 and code != EMPIRICAL else 4


def stream_words(seed: int, n_cand: int, rep0: int, n_reps: int, n_counters: int,
                 device=None) -> tuple[torch.Tensor, ...]:
    """The four words of counter ``q`` for candidate ``c`` and rep ``rep0 + s``,
    as four ``(n_cand, n_reps, n_counters)`` int64 tensors."""
    if rep0 < 0 or rep0 + n_reps > 2**32:
        raise ValueError("reps must lie in [0, 2**32)")
    q = torch.arange(n_counters, dtype=torch.int64, device=device)[None, None, :]
    k = torch.arange(rep0, rep0 + n_reps, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(n_cand, dtype=torch.int64, device=device)[:, None, None]
    q, k, c = torch.broadcast_tensors(q, k, c)
    return philox4x32_10((q, k, c, torch.zeros_like(q)), key_of(seed))


def uniforms(words, dtype: torch.dtype, n_slots: int) -> torch.Tensor:
    """``(..., n_slots)`` uniforms in [0, 1) from :func:`stream_words`' output."""
    if dtype == torch.float32:
        w = torch.stack(words, dim=-1).flatten(-2)[..., :n_slots]
        return ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        hi = torch.stack(words[0::2], dim=-1).flatten(-2)[..., :n_slots]
        lo = torch.stack(words[1::2], dim=-1).flatten(-2)[..., :n_slots]
        bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def transform(code: int, consts, table, u_or_words, dtype: torch.dtype) -> torch.Tensor:
    """A law's draws from its uniforms (or, for :data:`EMPIRICAL`, its words)."""
    if code == EMPIRICAL:
        tab = torch.as_tensor(table, dtype=dtype, device=u_or_words.device)
        return tab[(u_or_words * tab.shape[0]) >> 32]
    u = u_or_words
    a = torch.tensor(consts[0], dtype=dtype, device=u.device)
    if code in (EXPONENTIAL, SHIFTED_EXPONENTIAL):
        x = torch.log1p(-u) / a
        if code == SHIFTED_EXPONENTIAL:
            x = x + torch.tensor(consts[1], dtype=dtype, device=u.device)
        return x
    if code == PARETO:
        return torch.pow(1.0 - u, a) * torch.tensor(consts[1], dtype=dtype, device=u.device)
    raise ValueError(f"unknown law code {code}")


def draws(law, seed: int, n_cand: int, rep0: int, n_reps: int, n_slots: int,
          dtype: torch.dtype, device=None) -> torch.Tensor:
    """``(n_cand, n_reps, n_slots)`` draws of ``law = (code, consts, table)``
    (:meth:`ServiceTime.philox_law`), slot ``j`` of rep ``rep0 + s``."""
    code, consts, table = law
    per = draws_per_counter(code, dtype)
    words = stream_words(seed, n_cand, rep0, n_reps, -(-n_slots // per), device)
    if code == EMPIRICAL:
        return transform(code, consts, table,
                         torch.stack(words, dim=-1).flatten(-2)[..., :n_slots], dtype)
    return transform(code, consts, table, uniforms(words, dtype, n_slots), dtype)
