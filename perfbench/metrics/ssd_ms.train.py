"""``ssd_ms.train``: device ms per traced step of the kernels launched in the spans
``ssd.forward`` (every layer's chunked SSD scan, forward and recompute) and
``ssd.backward`` (its backward); None where the program has neither span."""
from perfbench import spans

SPANS = ("ssd.forward", "ssd.backward")


def read(trace, facts):
    parts = [spans.per_unit_ms(trace, name, "device_ns") for name in SPANS]
    return None if None in parts else sum(parts)
