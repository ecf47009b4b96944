"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``lib<name>-<hash>.so`` under :data:`BUILD_DIR`, then loaded
with :mod:`ctypes`.  Run from a checkout (or an editable install of one),
``BUILD_DIR`` is ``build/repro_torch_kernels/`` at the root of the checkout;
an installed copy of the package builds beside its own sources instead
(``kernels/build/``), which needs a writable install.  The hash covers the
source and its flags, so an edited source is never served a stale library,
and a build lands under its final name by an atomic rename.  Each source has
its own flags (:func:`nvcc_flags`), and the hash covers them and every
``csrc/*.cuh`` the source includes, so an edited header is never served a
stale library either.
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
import re
import shutil
import subprocess

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "SOURCE_FLAGS", "build", "build_all",
           "includes", "library_path", "load", "nvcc_flags"]

_HERE = pathlib.Path(__file__).resolve().parent  # .../repro_torch/kernels
CSRC = _HERE / "csrc"
_IN_CHECKOUT = _HERE.parents[1].name == "src"  # <checkout>/src/repro_torch/kernels
BUILD_DIR = (_HERE.parents[2] if _IN_CHECKOUT else _HERE) / "build" / "repro_torch_kernels"
# every kernel source of the port, built together by build_all
SOURCES = ("cover", "rmsnorm", "flash_attention")
# flags of every source
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / spills per kernel, kept in the build log
)
# and each source's own: the cover kernel is held bitwise to its plain
# version, so no multiply-add is contracted into an FMA (RMSNorm keeps the
# same rule); the attention kernels write their FMAs out and contract freely
SOURCE_FLAGS = {
    "cover": ("--fmad=false",),
    "rmsnorm": ("--fmad=false",),
    "flash_attention": (),
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return nvcc


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def includes(path: pathlib.Path) -> list[pathlib.Path]:
    """The files under ``csrc/`` that ``path`` includes with quotes, directly
    or through one another, in the order first met."""
    found: list[pathlib.Path] = []
    todo = [path]
    while todo:
        for rel in _INCLUDE.findall(todo.pop().read_text()):
            dep = CSRC / rel
            if dep.exists() and dep not in found:
                found.append(dep)
                todo.append(dep)
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in includes(src):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
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
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
