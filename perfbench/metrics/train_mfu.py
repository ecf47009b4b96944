"""``train_mfu``: the traced steps' model FLOPs (closed form, no recompute) over
their wall time, as a share of the card's 989.4 TFLOP/s in bf16."""
from perfbench import work


def read(trace, facts):
    if not trace.units or trace.window_s <= 0:
        return None
    return 100.0 * facts["flops_per_step"] * trace.units / trace.window_s / work.BF16_FLOP_PER_S
