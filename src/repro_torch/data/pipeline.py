"""Deterministic synthetic data pipeline with *replicated shard assignment*.

A numpy copy of ``repro.data.pipeline`` (host data; the port never imports
the JAX package): the same batches bit for bit, the startup coverage guard
on the port's ``core.batching``.  The trainer copies each batch to its
device.

The paper's optimal policy (balanced, non-overlapping batches; Thms 1-2)
becomes the shard-assignment rule of the input pipeline: the global batch is
cut into ``B`` contiguous shards; worker group ``w`` reads shard ``w % B``
(so each shard is produced by exactly ``r = N/B`` replica groups -- Lemma 3's
balanced vector).  At startup the assignment is validated with the coverage
guard (Lemma 1's failure mode -- an uncovered shard -- is a hard error).

Data is generated counter-deterministically (Philox keyed on
(seed, step, shard)): any worker can reproduce any shard at any step with no
coordination, which is what makes replicated shards and elastic reassignment
free of data movement.

The token stream follows a fixed random bigram chain (90% transition, 10%
noise), so models measurably learn (loss drops well below uniform entropy)
in a few hundred CPU steps -- used by the end-to-end example.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core import batching

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_shards: int = 1  # B: distinct data shards (paper's batches)
    replication: int = 1  # r: worker groups per shard
    seed: int = 0
    bigram_p: float = 0.9


class SyntheticLM:
    def __init__(self, cfg: PipelineConfig):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("n_shards must divide global_batch (balanced shards)")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._perm = rng.permutation(cfg.vocab_size)
        # startup coverage guard: the worker->shard membership must cover
        # every shard (paper Lemma 1 turned into an invariant)
        n_workers = cfg.n_shards * cfg.replication
        m = batching.non_overlapping(
            n_tasks=cfg.n_shards * max(cfg.replication, 1),
            n_batches=cfg.n_shards,
            n_workers=n_workers,
        )
        diag = batching.validate_scheme(m)
        if not diag["balanced"]:
            raise ValueError(f"shard assignment is not balanced: {diag}")

    # -- generation ----------------------------------------------------------

    def _gen(self, rng: np.random.Generator, rows: int) -> np.ndarray:
        c = self.cfg
        toks = np.empty((rows, c.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, c.vocab_size, size=rows)
        noise = rng.random((rows, c.seq_len)) >= c.bigram_p
        rand_next = rng.integers(0, c.vocab_size, size=(rows, c.seq_len))
        for t in range(c.seq_len):
            nxt = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], nxt)
        return toks

    def _rng_for(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.Philox(key=self.cfg.seed, counter=[0, 0, step, shard])
        )

    def shard_batch(self, step: int, shard: int) -> Batch:
        """The rows of shard ``shard`` at ``step`` (reproducible anywhere)."""
        c = self.cfg
        rows = c.global_batch // c.n_shards
        toks = self._gen(self._rng_for(step, shard), rows)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((rows, c.seq_len), np.float32),
        }

    def global_batch(self, step: int) -> Batch:
        parts = [self.shard_batch(step, s) for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def worker_batch(self, step: int, worker: int) -> Batch:
        """Paper policy: worker w serves shard w % B (balanced round-robin)."""
        return self.shard_batch(step, worker % self.cfg.n_shards)

    def shard_of_worker(self, worker: int) -> int:
        return worker % self.cfg.n_shards

    def bigram_ceiling_loss(self) -> float:
        """Entropy of the generating chain = best achievable CE (nats)."""
        c = self.cfg
        p, v = c.bigram_p, c.vocab_size
        p_next = p + (1 - p) / v
        p_other = (1 - p) / v
        h = -p_next * np.log(p_next)
        if p_other > 0:
            h -= (v - 1) * p_other * np.log(p_other)
        return float(h)
