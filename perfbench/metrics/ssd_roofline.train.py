"""``ssd_roofline.train``: the SSD scans' share of their roofline over a step.

The least time of a step's scans, every layer, forward, recompute and
backward (:func:`perfbench.mamba2.ssd_bound_s`), over the device time a step
launched inside the spans ``ssd.forward`` and ``ssd.backward``.
"""
from perfbench import mamba2, spans, work


def read(trace, facts):
    parts = [spans.per_unit_ms(trace, name, "device_ns") for name in ("ssd.forward",
                                                                      "ssd.backward")]
    if None in parts:
        return None
    bound, _ = mamba2.ssd_bound_s(facts["arch"], facts["batch"], facts["seq"])
    return work.share_pct(bound, sum(parts) / 1e3)
