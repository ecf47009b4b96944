"""``idle_share.train``: % of the traced steps' wall time with nothing on the card."""


def read(trace, facts):
    return trace.idle_pct()
