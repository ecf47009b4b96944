"""``kernel_b_roofline.plan``: kernel B's share of its roofline over the traced plans.

The least time of a plan's frontier pass is the larger of its lane
instructions (a frozen count per draw, :mod:`perfbench.work`) over the
card's instruction rate and its bytes (the class's observations read once,
the cover times written once) over the memory rate; the share is the sum of
those bounds over the traced plans against the measured time of the
``sample_cover_*`` kernels.
"""
from perfbench import work

KERNEL = "sample_cover_"


def read(trace, facts):
    seconds, launches = trace.kernel_s(KERNEL)
    if not launches:
        return None
    cands = facts["candidates"]
    bound = sum(work.frontier_bound_s(facts["n_workers"], cands, facts["n_reps"], n)[0]
                for n in facts["tables"][: trace.units])
    return work.share_pct(bound, seconds)
