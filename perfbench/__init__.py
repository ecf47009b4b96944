"""The benchmark of record of the PyTorch and CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the CUDA card and prints its
result as the last line of standard output.  Everything a cell is made of is
found by name: its configuration (``configs/``), its traffic mix
(``traffic/``, data read by :mod:`perfbench.traffic`), the driver of its
entry point (``drivers/``), the plain reference that decides ``correct``
(``reference/``), the limits of its comparison (``checks/``) and one reader
per per-layer metric (``metrics/``).  Nothing here imports ``jax`` or the
JAX package ``repro``.
"""
