"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``, built at first use)."""
