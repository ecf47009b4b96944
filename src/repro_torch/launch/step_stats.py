"""Per-device statistics of one step, from the ops a rank dispatches.

Port of ``repro.launch.hlo_stats``.  The reference parses the partitioned
HLO of a compiled step, the per-device program; here the per-device program
is what one rank runs eagerly, and :class:`StepStats` (a
``TorchDispatchMode``) reads it op by op as it runs, on real tensors or on
fake ones (``FakeTensorMode``, where nothing runs and no card is needed):

  * ``flops``            -- every op that ``torch.utils.flop_counter`` has a
                            formula for (matmuls, convolutions, attention);
                            ``attention_flops`` is the attention kernel's
                            share, counted dense (``kernels/flash_attention.py``)
  * ``hbm_bytes``        -- operand and output bytes of every op that runs a
                            kernel (views and allocations excluded; a
                            broadcast dim counted once): in eager mode each op
                            is its own kernel, so this is the eager program's
                            device traffic
  * ``collectives``      -- per kind: count, bytes and ring-model wire bytes
                            as the reference computes them, split by whether
                            the group's ranks span the ``"pod"`` axis
                            (``dcn_bytes``, the reference's name for across
                            pods) or not (``ici_bytes``, within one pod)
  * ``launches_by_kernel`` -- each hand kernel's calls by the kernel it
                            launches (``flash_attention.attention_route``:
                            split-KV, wgmma, CUDA cores; the fused RMSNorm;
                            the split row's two kernels; the attention
                            backward's three, one launch each a call)
  * ``peak_bytes``       -- the peak of live device bytes, each storage
                            counted once, from the tensors given to
                            :meth:`StepStats.track` and every op's outputs

Collectives are read from the c10d ops (``dist.all_reduce`` and kin) and the
functional collectives DTensor uses; a group's ranks come from
``dist.get_process_group_ranks``.  A group of one rank issues nothing in the
port (``tensor_parallel.MeshGroup``, ``sharding.gather``), so none is seen.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import flash_attention as _flash

__all__ = ["KERNELS", "StepStats", "stats_to_dict", "wire_bytes"]

# the hand kernels by the name chip_smoke.py's launch counts use
# the attention backward's kernels (``csrc/flash_bwd.cuh``): delta, dK / dV, dQ
_BWD_KERNELS = ("bwd_delta", "bwd_dkdv", "bwd_dq")
KERNELS = ("rmsnorm", "sumsq", "scaled", "splitkv", "wgmma", "simt") + _BWD_KERNELS

_c10d = torch.ops.c10d
_funcol = torch.ops._c10d_functional
# op -> its kind, by the reference's names
_COLLECTIVES = {
    _c10d.allreduce_.default: "all-reduce",
    _c10d.allreduce_coalesced_.default: "all-reduce",
    _c10d.allgather_.default: "all-gather",
    _c10d._allgather_base_.default: "all-gather",
    _c10d.allgather_into_tensor_coalesced_.default: "all-gather",
    _c10d.reduce_scatter_.default: "reduce-scatter",
    _c10d._reduce_scatter_base_.default: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced_.default: "reduce-scatter",
    _c10d.alltoall_.default: "all-to-all",
    _c10d.alltoall_base_.default: "all-to-all",
    _c10d.broadcast_.default: "collective-permute",
    _funcol.all_reduce.default: "all-reduce",
    _funcol.all_gather_into_tensor.default: "all-gather",
    _funcol.reduce_scatter_tensor.default: "reduce-scatter",
    _funcol.all_to_all_single.default: "all-to-all",
}
_FUNCTIONAL = {op for op in _COLLECTIVES if op.namespace == "_c10d_functional"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "lift_fresh", "_local_scalar_dense", "wait_tensor"}
_NORMS = {"rms_norm": "rmsnorm", "row_sumsq": "sumsq", "rms_norm_scaled": "scaled"}


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes a rank sends over the ring for one collective of ``nbytes``
    (the reference's count: all-reduce and all-gather ``nbytes`` is the whole
    output, reduce-scatter's the rank's shard) over ``n`` ranks."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * nbytes
    if kind == "reduce-scatter":
        return float(n - 1) * nbytes
    return float(nbytes)


def _view_bytes(t: torch.Tensor) -> int:
    """The bytes a kernel reads or writes for ``t``: a broadcast (stride 0) dim once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples, dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _group_of(args) -> Optional[list]:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            except RuntimeError:
                continue
        if isinstance(a, str):  # a functional collective's group name
            try:
                pg = torch._C._distributed_c10d._resolve_process_group(a)
            except (RuntimeError, ValueError):
                continue
            return dist.get_process_group_ranks(pg)
    return None


@dataclasses.dataclass
class _Totals:
    flops: float = 0.0
    attention_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    launches_by_kernel: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))
    ops: int = 0


class StepStats(TorchDispatchMode):
    """Counts what one rank dispatches while the mode is on.

    ``device_type``: the device whose tensors are the rank's (memory and
    traffic are counted for them alone).  ``pod_size``: ranks a pod (the
    ``"pod"`` axis's stride), or ``None`` on a mesh of one pod.
    """

    def __init__(self, device_type: str = "cuda", pod_size: Optional[int] = None):
        super().__init__()
        self.device_type = device_type
        self.pod_size = pod_size
        self.t = _Totals()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}  # storage key -> bytes
        self._refs: Dict[int, weakref.ref] = {}

    # -- memory --------------------------------------------------------------

    def track(self, tensors: Iterable) -> None:
        """Count ``tensors`` (any tree) as live from now until they are freed."""
        for t in _tensors(tensors):
            self._add(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _add(self, t: torch.Tensor) -> None:
        if hasattr(t, "_local_tensor"):  # a DTensor: its local tensor is the rank's
            t = t._local_tensor
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _r, k=key: self._free(k))
        self.live_bytes += self._live[key]

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    # -- the ops -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self.t
        t.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            t.flops += n
            if packet in (torch.ops.repro_torch.attention, torch.ops.repro_torch.attention_lse):
                t.attention_flops += n
        if func.namespace == "repro_torch":
            name = func._opname
            if name in ("attention", "attention_lse"):  # the forward, and training's with lse
                t.launches_by_kernel[_flash.attention_route(*args[:3])] += 1
            elif name in _NORMS:
                t.launches_by_kernel[_NORMS[name]] += 1
            elif name == "attention_backward":
                for k in _BWD_KERNELS:
                    t.launches_by_kernel[k] += 1
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            self._collective(func, kind, args, out)
        outs = _tensors(out)
        for x in outs:
            self._add(x)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if func.is_view or func._opname in _FREE:
            return
        # each distinct tensor once (an in-place op's output is its input)
        unique = {id(x): x for x in _tensors((args, kwargs)) + outs}
        t.hbm_bytes += sum(_view_bytes(x) for x in unique.values()
                           if x.device.type == self.device_type)

    def _collective(self, func, kind: str, args, out) -> None:
        ranks = _group_of(args) or []
        # the bytes the reference counts: the collective's output (all-gather:
        # the gathered whole; reduce-scatter: the rank's shard), which a c10d
        # op takes first and a functional collective returns
        nbytes = sum(_view_bytes(x) for x in _tensors(out if func in _FUNCTIONAL else args[0]))
        wire = wire_bytes(kind, nbytes, len(ranks))
        crosses = bool(self.pod_size and len({r // self.pod_size for r in ranks}) > 1)
        slot = self.t.collectives.setdefault(kind, {"count": 0.0, "bytes": 0.0,
                                                    "wire_bytes": 0.0, "ici_bytes": 0.0,
                                                    "dcn_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += nbytes
        slot["wire_bytes"] += wire
        slot["dcn_bytes" if crosses else "ici_bytes"] += wire


def stats_to_dict(st: StepStats) -> Dict:
    """The reference's ``stats_to_dict`` keys, and the port's own beside them."""
    t = st.t
    return {
        "flops": t.flops,
        "attention_flops": t.attention_flops,
        "hbm_bytes": t.hbm_bytes,
        "collective_wire_bytes": sum(c["wire_bytes"] for c in t.collectives.values()),
        "collectives": {k: dict(v) for k, v in t.collectives.items()},
        "launches_by_kernel": dict(t.launches_by_kernel),
        "peak_bytes": st.peak_bytes,
        "ops": t.ops,
    }

