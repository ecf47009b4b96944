"""``rmsnorm_roofline.train``: the RMSNorm forward kernel's share of its bytes bound.

Each launch normalises the step's ``batch * seq`` rows of ``d_model``; its
least time (:func:`perfbench.work.rmsnorm_fwd_bound_s`) times the launches,
over their measured time.
"""
from perfbench import work

KERNEL = "rmsnorm_kernel"


def read(trace, facts):
    seconds, launches = trace.kernel_s(KERNEL)
    if not launches:
        return None
    bound, _ = work.rmsnorm_fwd_bound_s(facts["arch"], facts["batch"], facts["seq"])
    return work.share_pct(bound * launches, seconds)
