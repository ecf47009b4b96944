"""PyTorch/CUDA port of ``repro``: the paper's planning loop on an NVIDIA card.

The JAX package ``repro`` stays the reference; this package mirrors its
paths (``repro_torch/core/planner.py`` ports ``repro/core/planner.py``, and
so on) and never imports it or jax.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; on a CUDA tensor the masked earliest-cover
reduction runs as the hand-written kernel of :mod:`repro_torch.kernels.cover`.

Ported so far (the static planning loop): ``core.service_time``,
``core.analysis``, ``core.traces``, ``core.simulator``, ``core.planner``
(``plan`` / ``plan_empirical`` / ``plan_auto`` / ``plan_cluster`` /
``plan_sweep``), ``cluster.scenario`` / ``scheduler`` / ``workers`` and the
static path of ``cluster.vectorized``.  ``ROADMAP.md`` queues the rest.
"""
