"""``host_ms.train``: host ms per step, the traced steps' wall time the card was not busy."""


def read(trace, facts):
    return trace.host_ms_per_unit()
