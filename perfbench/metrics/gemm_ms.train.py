"""``gemm_ms.train``: device ms per step in the projections' matrix products (cuBLAS).

cuBLAS's kernels by name (``gemm``, ``nvjet``, ``xmma``, ``cutlass``): the
projections, the MLP and the unembedding, forward, recomputed and backward,
in bfloat16.  The float32 products (``f32f32``, ``sgemm`` in the name) are
left out: the step runs them only in attention's plain-torch backward.
"""
PARTS = ("gemm", "nvjet", "xmma", "cutlass")
FLOAT32 = ("f32f32", "sgemm")


def read(trace, facts):
    if not trace.units:
        return None
    total, n = 0, 0
    for name, a, b in trace.device:
        low = name.lower()
        if any(p in low for p in PARTS) and not any(p in low for p in FLOAT32):
            total += b - a
            n += 1
    return total / 1e6 / trace.units if n else None
