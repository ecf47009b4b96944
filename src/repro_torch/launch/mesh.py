"""Device-mesh construction on ``torch.distributed`` (port of ``repro.launch.mesh``).

Functions only: importing this module touches no process group.  A mesh is
a ``DeviceMesh`` over an initialised process group whose world size is the
product of the shape; rank ``r`` sits at ``unravel_index(r, shape)``, the
first axis major, as ``jax.make_mesh`` lays out its devices.  The device
type is ``"cuda"`` (NCCL on the card) unless the caller asks for ``"cpu"``
(gloo, as the tests run).  The reference's ``AxisType`` shim is jax's and has
no counterpart.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "make_production_mesh", "make_replicated_mesh"]


def _device_type(device_type) -> str:
    if device_type in (None, "cuda"):
        return "cuda"
    if device_type == "cpu":
        return "cpu"
    raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")


def make_mesh(shape, axes, device_type=None) -> DeviceMesh:
    """A mesh of ``shape`` with the axis names ``axes`` over the whole world."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None) -> DeviceMesh:
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_replicated_mesh(replication: int, n_shards: int, model_parallel: int,
                         device_type=None) -> DeviceMesh:
    """RDP mesh ("replica","shard","model") for a replication plan (B, r)."""
    return make_mesh((replication, n_shards, model_parallel), ("replica", "shard", "model"),
                     device_type)
