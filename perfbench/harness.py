"""One run of one cell: its pieces found by name, the window measured, the output checked.

``BENCHMARK.json`` names a cell's configuration and traffic mix; the mix
names its entry point.  From those names this module loads:

* ``configs/<config>.json`` (through the workload's ``file``), the sizes;
* ``traffic/<traffic>.json``, the mix (read by :mod:`perfbench.traffic`);
* ``drivers/<entry>.py``, whose ``run`` builds the system under test from
  the port, runs the window and hands back an :class:`Outcome`;
* ``checks/<workload>.json``, the limit of each number compared;
* ``metrics/<metric>.py`` for each per-layer metric of the cell, whose
  ``read(trace, facts)`` returns the metric or None where it finds nothing.

A driver's ``run(cell, seed, seconds, traced, device, process_start)`` keeps
to one order: set-up (inputs and weights from the seed, every shape of the
cell warmed up), the window, ``memory_peak_bytes`` read, the program's state
freed, and only then the plain reference over a sample drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
# top-level module names that no run may hold: JAX, and the JAX package this
# port was made from (its name is a prefix of the port's, so names are
# compared whole, up to the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what the harness sets in the program's process, printed in every result line
ALLOC_CONF = "max_split_size_mb:256"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.  ``e2e`` holds the end-to-end metrics by
    name (``setup_s`` among them); ``compared`` the numbers the reference's
    comparison gives, by name; ``facts`` what the readers need beside the
    trace (shapes, units traced); ``extra`` goes into the result line
    unread by anything (counters, the card's power limit)."""

    attempted: int
    failed: int
    e2e: dict
    compared: dict
    memory_peak_bytes: int
    trace: object = None
    facts: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)


def process_start() -> float:
    """The wall-clock time this process started, from ``/proc`` (the time
    this module was imported where ``/proc`` is missing)."""
    try:
        ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in
                     pathlib.Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime "))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def environment(root: pathlib.Path = ROOT) -> None:
    """Set the run's environment before torch is imported.

    Every kernel cache goes to a fixed directory inside the checkout: the
    port builds its CUDA sources into ``build/repro_torch_kernels/`` there
    by itself; Triton, PyTorch's extensions and the driver's JIT cache go
    beside it.  PyTorch's caching allocator splits no cached block larger
    than 256 MB (``max_split_size_mb``): the training cells' step peaks
    within 15 GB of the card, and with the default the 4 x 4096 step runs
    out of memory in its first backward, 13.72 GiB cached but unallocated.
    The port's launcher sets no allocator option, so this one is the
    harness's; :func:`settings` names it in every result line."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")


def settings() -> dict:
    """The options the harness set in the program's process."""
    return {"PYTORCH_CUDA_ALLOC_CONF": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}


def load_module(path: pathlib.Path, name: str):
    """A module from its file, under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every piece read."""
    from perfbench import traffic

    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic.load(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((root / "perfbench" / "checks" / f"{name}.json").read_text())["limits"]

    def applies(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def _device_record(device, chips: int, outcome: Outcome) -> dict:
    import torch

    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    else:
        rec = {"platform": device.type, "kind": device.type, "count": chips}
    rec["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    if outcome.trace is not None:
        rec["busy_s"] = outcome.trace.busy_s
        rec["window_s"] = outcome.trace.window_s
    return rec


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             started: float) -> dict:
    """Run ``cell`` once and return its result line (a dict)."""
    driver = load_module(HERE / "drivers" / f"{cell.traffic['entry']}.py",
                         f"perfbench_driver_{cell.traffic['entry']}")
    out = driver.run(cell, seed, seconds, traced, device, started)
    missing = set(out.compared) ^ set(cell.limits)
    if missing:
        raise KeyError(f"compared numbers and limits differ in {sorted(missing)}")
    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    elif out.trace is not None:
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.trace, out.facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(math.isfinite(v) and v <= cell.limits[k] for k, v in out.compared.items())
    # JSON has no NaN or infinity: a number that is not finite prints as the largest float
    checks = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": cell.limits[k]}
              for k, v in out.compared.items()}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": _device_record(device, cell.chips, out)}
    if out.trace is not None:
        result["breakdown"] = {"device_ops": out.trace.device_ops(),
                               "idle_gaps": out.trace.idle_gaps()}
    result.update(out.extra)
    result["settings"] = settings()
    result["checks"] = checks  # last: each number compared beside its limit
    return result


def main(argv=None) -> int:
    import argparse

    started = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, str(ROOT / "src"))
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); {have} found",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      started)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
