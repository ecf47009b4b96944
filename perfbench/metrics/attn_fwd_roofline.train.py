"""``attn_fwd_roofline.train``: the attention forward kernels' share of their roofline.

Each launch is one layer's causal attention over the step's batch (the
forward and its recompute); its least time (:func:`perfbench.work.attention_fwd_bound_s`)
times the launches, over their measured time.
"""
from perfbench import work

KERNELS = ("wgmma_kernel", "simt_kernel", "splitkv_kernel")


def read(trace, facts):
    seconds, launches = trace.kernel_s(*KERNELS)
    if not launches:
        return None
    bound, _ = work.attention_fwd_bound_s(facts["arch"], facts["batch"], facts["seq"])
    return work.share_pct(bound * launches, seconds)
