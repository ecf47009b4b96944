"""``kernel_b_ms.plan``: device ms of kernel B (the ``sample_cover_*`` kernels) per plan traced."""

KERNEL = "sample_cover_"


def read(trace, facts):
    seconds, launches = trace.kernel_s(KERNEL)
    if not launches or not trace.units:
        return None
    return seconds * 1e3 / trace.units
