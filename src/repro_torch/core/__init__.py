"""The paper's primary contribution: efficient replication planning (port of ``repro.core``).

Public surface ported so far:
  * service_time -- Exp / SExp / Pareto / Empirical models (torch samplers)
  * analysis     -- closed-form E[T], CoV[T] and regime boundaries
  * simulator    -- Monte-Carlo job-time oracle on the cover kernel
  * planner      -- RedundancyPlanner -> (B, r)
  * traces       -- Google-trace-like workload generator (§VII)

``batching``, ``assignment`` and ``coupon`` come with a later slice.
"""
from . import analysis, simulator, traces
from .planner import RedundancyPlan, RedundancyPlanner, fit_service_time, plan_sweep

# re-exported after core's own submodules are bound: cluster's modules import
# those submodules directly, so this back-edge stays cycle-safe either way
# the packages are first imported
from ..cluster.scenario import SLO, Scenario
from .service_time import (
    Empirical,
    Exponential,
    Pareto,
    ServiceTime,
    ShiftedExponential,
    from_spec,
    min_of,
)

__all__ = [
    "analysis",
    "simulator",
    "traces",
    "RedundancyPlan",
    "RedundancyPlanner",
    "SLO",
    "Scenario",
    "fit_service_time",
    "plan_sweep",
    "Empirical",
    "Exponential",
    "Pareto",
    "ServiceTime",
    "ShiftedExponential",
    "from_spec",
    "min_of",
]
