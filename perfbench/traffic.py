"""The one generator of every traffic mix: it reads a mix's data file and the seed.

A mix is a JSON file ``traffic/<name>.json`` of parameters; its ``kind``
names what it generates:

* ``closed_loop_plans``: one client that asks for a plan, waits for it and
  asks again.  Each cycle of requests visits every job class of the
  configuration once, in an order drawn from the seed for that cycle; each
  request has a plan seed of its own.
* ``lm_batches``: a global batch of ``batch`` rows of ``seq`` tokens a
  step, packed as ``repro_torch/data/pipeline.py`` packs them (``tokens`` the
  first ``seq`` of ``seq + 1`` ids, ``labels`` the last ``seq``, a
  ``loss_mask`` of ones), drawn on the device from one generator keyed on
  (seed, step), so that every row of every step differs and any step can be
  made again.  Ids are uniform over the vocabulary.

Every stream of numbers is keyed on the run's ``--seed`` through
:func:`derive`, so a seed gives the same inputs on every machine.
"""
from __future__ import annotations

import json
import pathlib
import zlib

import numpy as np

KINDS = ("closed_loop_plans", "lm_batches")


def derive(seed: int, *tags) -> int:
    """A 63-bit key of ``seed`` and ``tags`` (ints or strings), the same everywhere."""
    words = [int(seed) & (2**64 - 1)]
    words += [zlib.crc32(t.encode()) if isinstance(t, str) else int(t) for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) | (int(state[1]) << 32)) & (2**63 - 1)


def load(path: pathlib.Path) -> dict:
    mix = json.loads(pathlib.Path(path).read_text())
    if mix.get("kind") not in KINDS:
        raise ValueError(f"{path}: kind must be one of {KINDS}, not {mix.get('kind')!r}")
    return mix


def plan_requests(mix: dict, n_classes: int, seed: int, start: int = 0):
    """Yield ``(class index, plan seed)`` for requests ``start, start + 1, ...``."""
    i = start
    while True:
        cycle, pos = divmod(i, n_classes)
        order = np.random.default_rng(derive(seed, "order", cycle)).permutation(n_classes)
        yield int(order[pos]), derive(seed, "plan", i)
        i += 1


def lm_batch(mix: dict, vocab_size: int, seed: int, step: int, device):
    """The global batch of ``step`` on ``device``: ``tokens``, ``labels``
    (int32, ``(batch, seq)``) and ``loss_mask`` (float32 ones)."""
    import torch

    batch, seq = int(mix["batch"]), int(mix["seq"])
    gen = torch.Generator(device=device).manual_seed(derive(seed, "rows", step))
    ids = torch.randint(0, vocab_size, (batch, seq + 1), generator=gen, device=device,
                        dtype=torch.int64).to(torch.int32)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous(),
            "loss_mask": torch.ones((batch, seq), dtype=torch.float32, device=device)}
