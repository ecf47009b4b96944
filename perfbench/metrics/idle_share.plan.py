"""``idle_share.plan``: % of the traced plans' wall time with nothing on the card."""


def read(trace, facts):
    return trace.idle_pct()
