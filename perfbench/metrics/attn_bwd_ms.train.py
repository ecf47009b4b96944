"""``attn_bwd_ms.train``: device ms per traced step of the kernels launched in the
spans ``attention.backward`` (every layer's attention backward, plain torch in float32)."""
from perfbench import spans


def read(trace, facts):
    return spans.per_unit_ms(trace, "attention.backward", "device_ns")
