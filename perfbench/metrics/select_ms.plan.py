"""``select_ms.plan``: host ms per traced plan in the planner's span ``plan.select``
(the frontier's statistics, the choice of B and the plan built; :mod:`perfbench.spans`)."""
from perfbench import spans


def read(trace, facts):
    return spans.per_unit_ms(trace, "plan.select", "host_ns")
