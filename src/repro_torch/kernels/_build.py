"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``lib<name>-<hash>.so`` under :data:`BUILD_DIR`, then loaded
with :mod:`ctypes`.  Run from a checkout (or an editable install of one),
``BUILD_DIR`` is ``build/repro_torch_kernels/`` at the root of the checkout;
an installed copy of the package builds beside its own sources instead
(``kernels/build/``), which needs a writable install.  The hash covers the
source and the flags, so an edited source is never served a stale library,
and a build lands under its final name by an atomic rename.
:func:`build_all` starts one ``nvcc`` per source at once.  Nothing here
runs at import: this module is imported on machines without ``nvcc``, where
only the plain PyTorch versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "build_all", "library_path", "load"]

_HERE = pathlib.Path(__file__).resolve().parent  # .../repro_torch/kernels
CSRC = _HERE / "csrc"
_IN_CHECKOUT = _HERE.parents[1].name == "src"  # <checkout>/src/repro_torch/kernels
BUILD_DIR = (_HERE.parents[2] if _IN_CHECKOUT else _HERE) / "build" / "repro_torch_kernels"
# every kernel source of the port, built together by build_all
SOURCES = ("cover", "rmsnorm", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / spills per kernel, kept in the build log
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile each ``csrc/<name>.cu`` not built yet, one ``nvcc`` per source,
    all started together; return each source's compiler log.

    Raises with the logs of every source whose ``nvcc`` failed.
    """
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text() for name in names}


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; return the compiler log.

    Raises with the log if ``nvcc`` fails.
    """
    return build_all([name])[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
