"""The port's replicated-data-parallel host logic against the reference's (``rdp``).

Ports of the four RDP tests of ``tests/test_substrates.py``, each also held
to the reference: the assignment matrix equal, ``surviving_coverage`` equal
for every single failure and a lost replica group, and the elastic
controller's transitions (membership change, drift) to equal plans.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import service_time as jax_st  # noqa: E402
from repro.core.planner import RedundancyPlanner as JaxPlanner  # noqa: E402
from repro.distributed import rdp as jax_rdp  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.planner import RedundancyPlanner  # noqa: E402
from repro_torch.core.service_time import Exponential, Pareto, ShiftedExponential  # noqa: E402
from repro_torch.distributed import rdp  # noqa: E402


def _same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in g:
        if isinstance(w[k], str):
            assert g[k] == w[k], k
        else:
            np.testing.assert_allclose(np.asarray(g[k], dtype=float),
                                       np.asarray(w[k], dtype=float), rtol=1e-12, err_msg=k)


def test_surviving_coverage():
    plan = RedundancyPlanner(8).plan(Exponential(mu=1.0), "blend")
    jplan = JaxPlanner(8).plan(jax_st.Exponential(mu=1.0), "blend")
    _same_plan(plan, jplan)
    healthy = [True] * plan.n_workers
    assert rdp.surviving_coverage(plan, healthy)["covered"]
    # kill one full replica group of shard 0 (workers w with w % B == 0)
    for w in range(plan.n_workers):
        if w % plan.n_batches == 0:
            healthy[w] = False
    cov = rdp.surviving_coverage(plan, healthy)
    assert not cov["covered"] and 0 in cov["lost_shards"]
    assert cov == jax_rdp.surviving_coverage(jplan, healthy)
    for dead in range(plan.n_workers):
        flags = [w != dead for w in range(plan.n_workers)]
        assert rdp.surviving_coverage(plan, flags) == jax_rdp.surviving_coverage(jplan, flags)
    with pytest.raises(ValueError):
        rdp.surviving_coverage(plan, [True])


def test_elastic_replans_on_failure():
    ctl = rdp.ElasticController(ShiftedExponential(0.05, 5.0))
    jctl = jax_rdp.ElasticController(jax_st.ShiftedExponential(0.05, 5.0))
    plan = ctl.initial_plan(16)
    _same_plan(plan, jctl.initial_plan(16))
    assert plan.n_workers == 16
    tr = ctl.on_membership_change(plan, n_healthy=12)
    assert tr is not None
    assert tr.new_plan.n_workers == 12
    assert tr.new_plan.n_batches * tr.new_plan.replication == 12
    assert ctl.on_membership_change(plan, n_healthy=16) is None
    jtr = jctl.on_membership_change(jctl.initial_plan(16), n_healthy=12)
    _same_plan(tr.new_plan, jtr.new_plan)
    assert tr.reason == jtr.reason and tr.mesh_change == jtr.mesh_change


def test_elastic_replans_on_drift():
    """Straggler onset (heavy tail appears) should raise redundancy."""
    ctl = rdp.ElasticController(ShiftedExponential(1.0, 10.0))  # low randomness
    jctl = jax_rdp.ElasticController(jax_st.ShiftedExponential(1.0, 10.0))
    plan = ctl.initial_plan(100)
    rng = np.random.default_rng(0)
    heavy = 1.0 * rng.uniform(size=4000) ** (-1 / 1.2)  # heavy-tail step times
    tr = ctl.on_observed_step_times(plan, heavy)
    assert tr is not None and tr.reason == "drift"
    assert tr.new_plan.n_batches < plan.n_batches  # more replication
    jtr = jctl.on_observed_step_times(jctl.initial_plan(100), heavy)
    assert (tr.new_plan.n_batches, tr.new_plan.replication) == \
        (jtr.new_plan.n_batches, jtr.new_plan.replication)
    assert tr.mesh_change == jtr.mesh_change


def test_assignment_matrix_is_balanced():
    plan = RedundancyPlanner(12).plan(Pareto(1.0, 2.0), "mean")
    m = rdp.assignment_matrix(plan)
    diag = batching.validate_scheme(m)
    assert diag["balanced"]
    jplan = JaxPlanner(12).plan(jax_st.Pareto(1.0, 2.0), "mean")
    np.testing.assert_array_equal(m, np.asarray(jax_rdp.assignment_matrix(jplan)))
