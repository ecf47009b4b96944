"""The dry run's lever variants of three cells, and the paper's technique cell.

Port of ``repro.launch.perf_cells``.  Each variant re-runs a cell of the dry
run (``launch/dryrun.py``) with one lever applied and writes a tagged record
next to the baseline, so the before / after table is read from records
alone:

  cell A (most collective-bound): qwen3-moe-235b train_4k
      _sp, _sp_mb2      sequence parallelism, microbatches 1 / 2
      _sp_saveouts      _sp with ``remat_policy="block_outs"``
  cell B (serving / memory):        qwen2-1.5b decode_32k
      _carry, _carry_nomat  ``cache_in_carry`` (a no-op in the port: its
                            cache is written in place always), without remat
      _kvseq                the sequence-sharded true-KV ring
  cell C (the paper's cell):        qwen2-1.5b train_4k
      _dpom, _dpom_mb4, _dpom_mb1   the model axis as data parallelism
      _saveouts, _dpom_saveouts     ``remat_policy="block_outs"``
  and ``_kvseq`` / ``_carry`` on the other decoders' decode_32k.

The technique cell: qwen2-1.5b train_4k on the RDP mesh (replica 2, shard 8,
model 16; ``launch/mesh.py::make_replicated_mesh``), batch over ``"shard"``
alone, so each microbatch is computed by both replica groups: the diversity
cost of r = 2 shows as per-device FLOPs against the (16, 16) baseline.

Usage: PYTHONPATH=src python -m repro_torch.launch.perf_cells [--only TAG] [--technique]
"""
from __future__ import annotations

import argparse

from .dryrun import ARTIFACTS, fake_world, run_cell
from .mesh import make_replicated_mesh

__all__ = ["VARIANTS", "main", "run_technique_cell"]

VARIANTS = [
    # (arch, shape, tag, overrides)
    ("qwen3-moe-235b-a22b", "train_4k", "_sp",
     {"sequence_parallel": True, "microbatches": 1}),
    ("qwen2-1.5b", "decode_32k", "_carry", {"cache_in_carry": True}),
    ("qwen2-1.5b", "train_4k", "_dpom",
     {"mesh_axes": "dp_over_model", "microbatches": 2}),
    ("qwen2-1.5b", "train_4k", "_dpom_mb4",
     {"mesh_axes": "dp_over_model", "microbatches": 4}),
    ("qwen3-moe-235b-a22b", "train_4k", "_sp_mb2",
     {"sequence_parallel": True, "microbatches": 2}),
    ("qwen2-1.5b", "decode_32k", "_carry_nomat",
     {"cache_in_carry": True, "remat": False}),
    # the backward's recompute runs no sum over the model group
    ("qwen3-moe-235b-a22b", "train_4k", "_sp_saveouts",
     {"sequence_parallel": True, "microbatches": 1, "remat_policy": "block_outs"}),
    ("qwen2-1.5b", "train_4k", "_saveouts",
     {"remat_policy": "block_outs", "microbatches": 4}),
    ("qwen2-1.5b", "train_4k", "_dpom_mb1",
     {"mesh_axes": "dp_over_model", "microbatches": 1}),
    ("qwen2-1.5b", "train_4k", "_dpom_saveouts",
     {"mesh_axes": "dp_over_model", "microbatches": 1, "remat_policy": "block_outs"}),
    # the true-KV ring sharded by sequence over the model axis
    ("qwen2-1.5b", "decode_32k", "_kvseq",
     {"cache_in_carry": True, "decode_kv_seq_sharded": True}),
    ("yi-9b", "decode_32k", "_kvseq",
     {"cache_in_carry": True, "decode_kv_seq_sharded": True}),
    ("starcoder2-3b", "decode_32k", "_kvseq",
     {"cache_in_carry": True, "decode_kv_seq_sharded": True}),
    ("dbrx-132b", "decode_32k", "_kvseq",
     {"cache_in_carry": True, "decode_kv_seq_sharded": True}),
    ("gemma-7b", "decode_32k", "_carry", {"cache_in_carry": True}),
]


def run_technique_cell(force: bool = False, out_dir=ARTIFACTS):
    """The paper's own operating point on the mesh: r = 2 replication.

    Mesh (replica 2, shard 8, model 16) = 256 ranks; the batch shards over
    ``"shard"`` only, so each microbatch is computed by 2 replica groups:
    about twice the per-device FLOPs of the (16, 16) baseline, which buys
    first-of-r straggler latency and shard-loss tolerance (quantified by
    ``core.simulator``).
    """
    fake_world(256)
    mesh = make_replicated_mesh(replication=2, n_shards=8, model_parallel=16,
                                device_type="cpu")
    return run_cell(
        "qwen2-1.5b", "train_4k", multi_pod=False, out_dir=out_dir,
        skip_existing=not force, overrides={"microbatches": 4}, tag="_rdp_r2",
        mesh_override=mesh,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None, help="run one tag only")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--technique", action="store_true", help="run the RDP r=2 cell")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    if args.technique:
        rec = run_technique_cell(force=args.force, out_dir=args.out)
        return 0 if rec["ok"] else 1
    n_fail = 0
    for arch, shape, tag, overrides in VARIANTS:
        if args.only and args.only != tag:
            continue
        rec = run_cell(
            arch, shape, multi_pod=False, out_dir=args.out,
            skip_existing=not args.force, overrides=overrides, tag=tag,
        )
        n_fail += not rec["ok"]
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
