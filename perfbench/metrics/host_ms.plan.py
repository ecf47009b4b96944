"""``host_ms.plan``: host ms per plan, the traced window's wall time the card was not busy."""


def read(trace, facts):
    return trace.host_ms_per_unit()
