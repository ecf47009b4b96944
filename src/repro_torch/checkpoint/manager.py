"""Checkpointing: atomic, integrity-checked, keep-K, async, resumable.

Port of ``repro.checkpoint.manager``, with its on-disk layout:

    <dir>/step_00000420/
        manifest.json     {"step", "leaves": [{key, file, shape, dtype, crc32}]}
        leaf_00000.npy .. leaf_NNNNN.npy

Writes go to a tmp dir and are atomically renamed, so a crash mid-save never
corrupts the latest checkpoint; restore verifies CRCs and falls back to the
newest *valid* step.  A state is a tree of named tuples (``TrainState``,
``OptState``), mappings, lists, :class:`~repro_torch.models.common.Params`,
tensors, numpy arrays and Python numbers; a leaf's key is its dotted path
in the port's tree (``params.layers.0.attn.wq``, ``opt_state.m.embed``).
Tensors are copied to the host before a save returns (``save_async``
included) and come back on the device and in the dtype of the ``like``
tree's leaf, with its ``requires_grad``.  numpy has no bfloat16, so a
bfloat16 leaf is refused rather than saved as something else.

A mesh state (DTensor leaves, ``runtime/train.py::jit_train_step``) is saved
whole: every rank gathers each leaf (``full_tensor()``, a collective, so
every rank calls ``save``) and rank 0 alone writes.  It restores onto any
mesh: a DTensor leaf of ``like`` (from ``jit_init_state`` on the new mesh)
gives the mesh and placements the loaded leaf is distributed to.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import pathlib
import shutil
import zlib
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed import sharding
from ..models.common import Params

__all__ = ["CheckpointManager"]

PREFIX = "step_"


def _flatten(tree: Any, prefix: str = "") -> list:
    """``[(key, leaf)]`` in tree order; a leaf is a tensor, an array or a number."""
    if isinstance(tree, Params):
        tree = tree.leaves()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.rstrip("."), tree)]
    out = []
    for name, value in items:
        out.extend(_flatten(value, f"{prefix}{name}."))
    return out


def _unflatten(like: Any, leaves: dict, prefix: str = "") -> Any:
    """A tree shaped as ``like`` with each leaf taken from ``leaves`` by key."""
    if isinstance(like, Params):
        new = {k: _restore_leaf(t, leaves[f"{prefix}{k}"]) for k, t in like.leaves().items()}
        return like.replace_leaves(new)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves, f"{prefix}{f}.")
                            for f in like._fields))
    if isinstance(like, Mapping):
        return {k: _unflatten(v, leaves, f"{prefix}{k}.") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}.") for i, v in enumerate(like))
    return _restore_leaf(like, leaves[prefix.rstrip(".")])


def _restore_leaf(like: Any, arr: np.ndarray) -> Any:
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape}, expected {tuple(like.shape)}")
        t = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        if isinstance(like, DTensor):
            t = sharding.distribute(t, sharding.NamedSharding(like.device_mesh,
                                                              sharding.spec_of(like)))
        if isinstance(like, torch.nn.Parameter):
            return torch.nn.Parameter(t, requires_grad=like.requires_grad)
        return t.requires_grad_(like.requires_grad)
    if isinstance(like, np.ndarray):
        return arr
    return type(like)(arr.item()) if isinstance(like, (int, float)) else arr


def _to_host(key: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key} is bfloat16, which numpy cannot hold; "
                             "save float32 master weights")
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()  # a collective: every rank saves
        return leaf.detach().to("cpu", copy=True).numpy()  # a copy, also of a CPU tensor
    return np.array(leaf)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or a lone process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any) -> pathlib.Path:
        host = [(k, _to_host(k, v)) for k, v in _flatten(state)]
        if not _writes():
            return self.dir / f"{PREFIX}{step:08d}"
        return self._write(step, host)

    def save_async(self, step: int, state: Any) -> None:
        """Device->host copy happens now; disk I/O overlaps the next steps."""
        self.wait()
        host = [(k, _to_host(k, v)) for k, v in _flatten(state)]
        if _writes():
            self._pending = self._pool.submit(self._write, step, host)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host: list) -> pathlib.Path:
        final = self.dir / f"{PREFIX}{step:08d}"
        tmp = self.dir / f"tmp_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (key, leaf) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, leaf)
            manifest["leaves"].append(
                {
                    "key": key,
                    "file": fname,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                    "crc32": zlib.crc32(np.ascontiguousarray(leaf).tobytes()),
                }
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._prune()
        return final

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"{PREFIX}{s:08d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for p in self.dir.glob(f"{PREFIX}*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name[len(PREFIX):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify(self, step: int) -> bool:
        d = self.dir / f"{PREFIX}{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            for leaf in manifest["leaves"]:
                arr = np.load(d / leaf["file"])
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != leaf["crc32"]:
                    return False
            return True
        except (OSError, EOFError, ValueError, KeyError):
            return False

    def restore(self, like: Any, step: Optional[int] = None) -> tuple:
        """Returns (state, step).  ``like`` is a tree of the state's structure
        (its leaves give each restored leaf's device, dtype and
        ``requires_grad``); falls back to the newest valid step."""
        candidates = [step] if step is not None else sorted(self.all_steps(), reverse=True)
        for s in candidates:
            if not self._verify(s):
                continue
            d = self.dir / f"{PREFIX}{s:08d}"
            manifest = json.loads((d / "manifest.json").read_text())
            by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
            leaves = {}
            for key, _ in _flatten(like):
                if key not in by_key:
                    raise KeyError(f"checkpoint missing leaf {key}")
                leaves[key] = np.load(d / by_key[key]["file"])
            return _unflatten(like, leaves), s
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")
