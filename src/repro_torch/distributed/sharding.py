"""Sharding rules: param / batch / cache placements for any mesh.

Port of ``repro.distributed.sharding``.  Axis roles are logical:
  * ``batch``  -- tuple of mesh axes carrying the global batch
                  (("pod","data") multi-pod, ("data",) single-pod, or
                  ("shard",) under a replication plan)
  * ``fsdp``   -- axis sharding parameters/optimizer state (ZeRO-3 style)
  * ``model``  -- tensor-parallel axis (heads / d_ff / vocab / experts)

Rules are keyed by parameter leaf name (the model zoo uses consistent
names); every rule is divisibility-checked against the mesh so a
non-dividing dim degrades to replication instead of failing.  The tables
and the resolution are the reference's, copied.

The resolution needs only the mesh's axis names and sizes: every function
here takes a ``DeviceMesh`` or a mapping of axis name to size (in mesh
order), so the specs can be computed with no process group.  A spec is a
:class:`PartitionSpec` whose text is jax's (``PartitionSpec('data', None)``),
so :func:`describe` gives the reference's strings.  :func:`placements`
turns a spec into DTensor placements: a tensor dim over a tuple of axes
becomes ``Shard(d)`` on each of those mesh dims, the first axis major, which
is jax's element order.

The reference stacks layers on a leading axis and leaves stacked dims
unsharded; the port's tree is unstacked (``models/convert.py``), so its
leaves meet the rules at their own rank.  A leaf's path is its dotted path
in the port's tree (``layers.0.attn.wq``); its name is the last part that is
not a list index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "MeshAxes",
    "NamedSharding",
    "PartitionSpec",
    "batch_shardings",
    "cache_shardings",
    "describe",
    "distribute",
    "gather",
    "is_whole",
    "local_slice",
    "mesh_sizes",
    "param_shardings",
    "placements",
    "scalar_sharding",
    "with_local",
    "write_back",
]

Role = Optional[str]  # 'fsdp' | 'model' | 'batch0' | None


class PartitionSpec(tuple):
    """A spec: one entry per tensor dim, ``None``, an axis name or a tuple of
    names.  Prints as jax's ``PartitionSpec`` does, which also stores a
    one-name tuple as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    batch: Tuple[str, ...]
    fsdp: Optional[str]
    model: Optional[str]

    @staticmethod
    def infer(mesh) -> "MeshAxes":
        names = tuple(mesh_sizes(mesh))
        model = "model" if "model" in names else None
        if "replica" in names and "shard" in names:
            batch: Tuple[str, ...] = ("shard",)  # replicas recompute, shards carry data
            fsdp = "shard"
        else:
            batch = tuple(n for n in names if n in ("pod", "data"))
            fsdp = "data" if "data" in names else None
        return MeshAxes(batch=batch, fsdp=fsdp, model=model)

    @staticmethod
    def dp_over_model(mesh) -> "MeshAxes":
        """Repurpose the TP axis as extra data parallelism (small models:
        TP=16 on a 1.5B model burns links on all-reduces; pure DP=256 does not)."""
        names = tuple(mesh_sizes(mesh))
        batch = tuple(n for n in names if n in ("pod", "data", "model"))
        fsdp = "data" if "data" in names else None
        return MeshAxes(batch=batch, fsdp=fsdp, model=None)


# ---------------------------------------------------------------------------
# per-leaf role rules (by rank of the leaf)
# ---------------------------------------------------------------------------

# name -> {rank: roles}
_PARAM_RULES: Dict[str, Dict[int, Tuple[Role, ...]]] = {
    # embeddings
    "embed": {2: ("model", "fsdp")},  # (V, d): vocab col-parallel for unembed
    "lm_head": {2: ("fsdp", "model")},
    # attention
    "wq": {2: ("fsdp", "model")},
    "wk": {2: ("fsdp", None)},  # true-KV replicated over model
    "wv": {2: ("fsdp", None)},
    "wo": {2: ("model", "fsdp")},
    "bq": {1: ("model",)},
    "bk": {1: (None,)},
    "bv": {1: (None,)},
    # dense MLP (2D) and MoE experts (3D)
    "w_gate": {2: ("fsdp", "model"), 3: ("model", "fsdp", None)},
    "w_up": {2: ("fsdp", "model"), 3: ("model", "fsdp", None)},
    "w_down": {2: ("model", "fsdp"), 3: ("model", None, "fsdp")},
    "w_in": {2: ("fsdp", "model")},
    "w_out": {2: ("model", "fsdp")},
    "b_in": {1: ("model",)},
    "b_out": {1: (None,)},
    "router": {2: (None, None)},
    # mamba2 mixer
    "w_z": {2: ("fsdp", "model")},
    "w_x": {2: ("fsdp", "model")},
    "w_bc": {2: ("fsdp", None)},
    "w_dt": {2: ("fsdp", "model")},
    "conv_x": {2: (None, "model")},
    "conv_x_b": {1: ("model",)},
    "conv_bc": {2: (None, None)},
    "conv_bc_b": {1: (None,)},
    "A_log": {1: ("model",)},
    "dt_bias": {1: ("model",)},
    "D": {1: ("model",)},
    "norm_w": {1: ("model",)},  # over d_inner (head-aligned)
    "out_proj": {2: ("model", "fsdp")},
    # rg-lru
    "w_y": {2: ("fsdp", "model")},
    "conv_w": {2: (None, "model")},
    "conv_b": {1: ("model",)},
    "w_a": {3: ("model", None, None)},
    "w_i": {3: ("model", None, None)},
    "b_a": {1: ("model",)},
    "b_i": {1: ("model",)},
    "lam": {1: ("model",)},
}

_CACHE_RULES: Dict[str, Dict[int, Tuple[Role, ...]]] = {
    "k": {4: ("batch0", None, "model", None)},  # (B, W, K_pad, hd)
    "v": {4: ("batch0", None, "model", None)},
    "pos": {1: (None,)},
    # sequence-sharded true-KV mode: ring buffer shards over the TP axis
    "ks": {4: ("batch0", "model", None, None)},
    "vs": {4: ("batch0", "model", None, None)},
    "poss": {1: ("model",)},
    "conv_x": {3: ("batch0", None, "model")},
    "conv_bc": {3: ("batch0", None, None)},
    "conv": {3: ("batch0", None, "model")},  # rglru conv tail (B, 3, D)
    "h": {2: ("batch0", "model"), 4: ("batch0", "model", None, None)},
}


def _axis_size(sizes: Mapping[str, int], name) -> int:
    if name is None:
        return 1
    return math.prod(sizes[a] for a in ([name] if isinstance(name, str) else name))


def _resolve(sizes: Mapping[str, int], axes: MeshAxes, roles: Tuple[Role, ...],
             shape) -> PartitionSpec:
    spec = []
    for dim, role in zip(shape, roles):
        if role is None:
            spec.append(None)
            continue
        if role == "batch0":
            names: Any = axes.batch
        elif role == "fsdp":
            names = axes.fsdp
        elif role == "model":
            names = axes.model
        else:
            raise ValueError(role)
        if names is None or (isinstance(names, tuple) and not names):
            spec.append(None)
            continue
        size = _axis_size(sizes, names if isinstance(names, str) else tuple(names))
        if dim % size:
            spec.append(None)  # non-dividing dim degrades to replication
        else:
            spec.append(names if isinstance(names, str) else tuple(names))
    return P(*spec)


def _leaf_name(path: str) -> Optional[str]:
    for part in reversed(path.split(".")):
        if part and not part.isdigit():
            return part
    return None


def _leaf_spec(sizes, axes: MeshAxes, rules, path: str, shape) -> PartitionSpec:
    name = _leaf_name(path)
    table = rules.get(name) if name else None
    if table is None:
        return P()  # replicate (norm scales, scalars, unknown leaves)
    shape = tuple(shape)
    for rank in sorted(table, reverse=True):
        if len(shape) == rank:
            return _resolve(sizes, axes, table[rank], shape)
        if len(shape) > rank:
            # stacked leading dims stay unsharded
            lead = len(shape) - rank
            inner = _resolve(sizes, axes, table[rank], shape[lead:])
            return P(*([None] * lead), *inner)
    return P()


# ---------------------------------------------------------------------------
# shardings: a mesh (or its axis sizes) and a spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: a ``DeviceMesh``, or a mapping of axis sizes when
    only the spec is wanted."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a spec: ``Shard(d)`` on every mesh dim that
    shards tensor dim ``d``, ``Replicate()`` elsewhere.  A dim over a tuple of
    axes must name them in mesh order (the first major, as jax orders them)."""
    names = list(mesh_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        idx = [names.index(a) for a in ((part,) if isinstance(part, str) else part)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {part} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of ``Params`` (a dict by leaf path),
    mappings, lists and named tuples; the result keeps the tree's structure.
    A leaf is a tensor or a ``torch.Size``."""
    if isinstance(tree, torch.nn.Module):  # models.common.Params
        return {k: fn(prefix + k, v) for k, v in tree.leaves().items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), f"{prefix}{f}.")
                            for f in tree._fields))
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return [_map_with_path(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix.rstrip("."), tree)


def param_shardings(mesh, params, axes: Optional[MeshAxes] = None):
    """NamedSharding per parameter (or congruent optimizer moment), by leaf
    path.  ``params``: a ``Params``, or a mapping of leaf paths to tensors or
    shapes."""
    axes = axes or MeshAxes.infer(mesh)
    sizes = mesh_sizes(mesh)
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _leaf_spec(sizes, axes, _PARAM_RULES, path,
                                                          _shape(leaf))),
        params,
    )


def cache_shardings(mesh, cache, axes: Optional[MeshAxes] = None):
    """NamedSharding per cache leaf, in the cache's own structure."""
    axes = axes or MeshAxes.infer(mesh)
    sizes = mesh_sizes(mesh)
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _leaf_spec(sizes, axes, _CACHE_RULES, path,
                                                          _shape(leaf))),
        cache,
    )


def batch_shardings(mesh, batch_spec, axes: Optional[MeshAxes] = None):
    """Batch dict: dim 0 over the batch axes, rest replicated."""
    axes = axes or MeshAxes.infer(mesh)
    bt = tuple(axes.batch)
    size = _axis_size(mesh_sizes(mesh), bt) if bt else 1

    def spec(path, leaf):
        shape = _shape(leaf)
        if len(shape) >= 1 and size > 1 and shape[0] % size == 0:
            return NamedSharding(mesh, P(bt, *([None] * (len(shape) - 1))))
        return NamedSharding(mesh, P())

    return _map_with_path(spec, batch_spec)


def scalar_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def describe(shardings) -> Dict[str, str]:
    """path -> spec string (the dry-run report's form)."""
    out: Dict[str, str] = {}
    _map_with_path(lambda path, s: out.__setitem__(path, str(s.spec)), shardings)
    return out


# ---------------------------------------------------------------------------
# moving tensors between a rank's full view and its shard
# ---------------------------------------------------------------------------


def local_slice(shape, spec: Sequence, mesh, coord: Sequence[int],
                skip: Sequence[str] = ()) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at mesh coordinate
    ``coord`` holds under ``spec`` (even shards, the first axis major);
    axes in ``skip`` are treated as unsplit."""
    sizes = mesh_sizes(mesh)
    index = {n: c for n, c in zip(sizes, coord)}
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        names = [] if part is None else [
            a for a in ((part,) if isinstance(part, str) else part) if a not in skip]
        chunk, count = 0, 1
        for a in names:
            chunk, count = chunk * sizes[a] + index[a], count * sizes[a]
        if n % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {names}")
        width = n // count
        out.append(slice(chunk * width, (chunk + 1) * width))
    return tuple(out)


def distribute(full: torch.Tensor, sh: NamedSharding) -> DTensor:
    """The DTensor of ``full`` (the same on every rank) under ``sh``: each
    rank keeps its own shard, no collective.  Where the shard is the whole
    tensor (a world of one) it shares ``full``'s storage; a part is a copy
    of its own, so ``full`` is freed once the caller lets it go (a slice
    that is contiguous already would otherwise keep it whole)."""
    mesh = sh.mesh
    local = full[local_slice(full.shape, sh.spec, mesh, mesh.get_coordinate())]
    local = local.contiguous() if local.numel() == full.numel() else \
        local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, sh.placements, run_check=False)


def with_local(x: DTensor, local: torch.Tensor) -> DTensor:
    """A DTensor over ``local`` with ``x``'s mesh, placements, global shape
    and stride (``local`` has the shape, stride and dtype of ``x``'s local
    tensor).  It reuses ``x``'s spec through DTensor's constructor, where
    ``DTensor.from_local`` builds and checks a new spec (80 µs against 6 µs
    a call on the CPU: a train step makes three DTensors a parameter)."""
    return DTensor(local, x._spec, requires_grad=False)


def is_whole(x, keep: Sequence[str] = ()) -> bool:
    """Whether ``x``'s local tensor is the whole tensor but over the axes in
    ``keep``: a plain tensor, or a DTensor sharded over those and over mesh
    axes of size 1 only (``gather(x, keep)`` copies nothing)."""
    if not isinstance(x, DTensor):
        return True
    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    return all(mesh.size(i) == 1 or names[i] in keep
               for i, p in enumerate(x.placements) if p.is_shard())


def gather(x, keep: Sequence[str] = ()) -> torch.Tensor:
    """``x``'s local tensor gathered over every mesh axis that shards it but
    those in ``keep``; a plain tensor comes back as it is.  An axis of size 1
    gathers nothing, so on a world of one this is the local tensor itself."""
    if not isinstance(x, DTensor):
        return x
    mesh, local = x.device_mesh, x.to_local()
    names = mesh.mesh_dim_names
    for i in reversed(range(mesh.ndim)):  # the minor axis first
        p = x.placements[i]
        if not p.is_shard() or names[i] in keep or mesh.size(i) == 1:
            continue
        parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
        torch.distributed.all_gather(parts, local.contiguous(), group=mesh.get_group(i))
        local = torch.cat(parts, dim=p.dim)
    return local


def spec_of(x: DTensor) -> PartitionSpec:
    """The spec of a DTensor's placements (each dim's mesh axes in mesh order)."""
    names = x.device_mesh.mesh_dim_names
    parts: list = [[] for _ in range(x.ndim)]
    for i, p in enumerate(x.placements):
        if p.is_shard():
            parts[p.dim].append(names[i])
    return P(*(None if not a else a[0] if len(a) == 1 else tuple(a) for a in parts))


def write_back(x: DTensor, full: torch.Tensor, keep: Sequence[str] = ()) -> None:
    """Copy this rank's shard of ``full`` (``gather(x, keep)``'s view, since
    written) into ``x``'s local tensor; nothing to do where they are one."""
    local = x.to_local()
    if full.data_ptr() == local.data_ptr() and full.shape == local.shape:
        return
    mesh = x.device_mesh
    local.copy_(full[local_slice(full.shape, spec_of(x), mesh, mesh.get_coordinate(),
                                 skip=keep)])
