"""``upload_ms.plan``: host ms per traced plan in the span ``cover.upload``: kernel B's
arguments (scales, geometry, constants, the class's table) built and copied to the card."""
from perfbench import spans


def read(trace, facts):
    return spans.per_unit_ms(trace, "cover.upload", "host_ns")
