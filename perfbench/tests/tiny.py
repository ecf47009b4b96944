"""Tiny cells of each entry point for the CPU tests: the cells' own files, cut in size.

The planner: the cell's own 20 workers and 400 reps, under its own limits.  Training:
qwen2-1.5b's layout at two layers of width 64 over a vocabulary of 512, a
batch of 4 x 32, under limits of its own (:data:`LIMITS`): at this size the
program's gaps from the reference read, over seeds 5 to 9 and 2**31 + 77,
loss 1.3e-5 to 8.9e-5, first gradient 3.5e-4 to 3.2e-3, change 8.0e-3 to
2.1e-2; the float8 control reads loss 1.1e-3 to 2.3e-3 and first gradient
3.1e-2 to 6.4e-2 (seeds 11 to 13), half the batch loss 5.6e-3 to 2.7e-2.
"""
import torch

from perfbench import harness

CELLS = {"plan": "plan.google-n20", "train": "train.qwen2-1.5b.seq4k"}
SIZES = {
    "plan": ({}, {"trace_plans": 5, "check_plans": 4}),
    "train": ({"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
               "d_ff": 128, "vocab_size": 512},
              {"batch": 4, "seq": 32, "block_tokens": 64, "trace_steps": 2}),
}


LIMITS = {"train": {"loss_gap": 4e-4, "grad_gap": 1.2e-2, "change_gap": 6e-2}}


def cell(entry: str) -> harness.Cell:
    full = harness.load_cell(CELLS[entry])
    conf, mix = SIZES[entry]
    return harness.Cell(f"{entry}.tiny", 1, {**full.config, **conf}, {**full.traffic, **mix},
                        LIMITS.get(entry, full.limits), full.end_to_end, full.per_layer)


def run(c: harness.Cell, seed: int, traced: bool, seconds: float = 0.5) -> dict:
    """One run of ``c`` on the CPU, through everything but the look for a card."""
    return harness.run_cell(c, seed, seconds, traced, torch.device("cpu"), harness.process_start())

