"""``adamw_ms.train``: device ms per traced step of the kernels launched in the span
``train.optimizer`` (AdamW's passes and the new parameters; :mod:`perfbench.spans`)."""
from perfbench import spans


def read(trace, facts):
    return spans.per_unit_ms(trace, "train.optimizer", "device_ns")
