"""PyTorch/CUDA port of ``repro``: the paper's planning loop, serving and training on an NVIDIA card.

The JAX package ``repro`` stays the reference; this package mirrors its
paths (``repro_torch/core/planner.py`` ports ``repro/core/planner.py``, and
so on) and never imports it or jax.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; on a CUDA tensor the masked earliest-cover
reduction, RMSNorm and flash attention run as hand-written kernels
(:mod:`repro_torch.kernels`).

Ported so far: the static planning loop (``core.service_time``,
``core.analysis``, ``core.traces``, ``core.simulator``, ``core.planner``
(``plan`` / ``plan_empirical`` / ``plan_auto`` / ``plan_cluster`` /
``plan_sweep``), ``cluster.scenario`` / ``scheduler`` / ``workers`` and the
static path of ``cluster.vectorized``); the dynamic lanes
(``cluster.epoch_scan``, ``cluster.stream``, ``cluster.control``); the event
engine (``cluster.events``, ``cluster.master``) and the live master-worker
runtime on it (``cluster.runtime``); the serving model zoo: ``configs``,
``models`` (every family), ``runtime.serve`` and ``launch.serve``; and the
training path: every family's ``train_loss``, ``optim``, ``data``,
``checkpoint``, ``distributed.rdp``'s host part, ``runtime.train`` and
``launch.train``.  ``ROADMAP.md`` queues the rest (the mesh code on
``torch.distributed``).
"""
