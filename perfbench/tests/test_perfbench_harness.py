"""The harness on the CPU: pieces found by name, the result line's shape, the import check.

Run from the root of a checkout: ``python -m pytest perfbench/tests -q``.
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, traffic  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(workload):
    cell = harness.load_cell(workload)
    entry = cell.traffic["entry"]
    for path in (harness.HERE / "drivers" / f"{entry}.py",
                 harness.HERE / "reference" / f"{entry}.py"):
        assert path.is_file(), path
    for m in cell.per_layer:
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py", "r")
        assert callable(reader.read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer and cell.limits


def test_benchmark_json_keeps_to_its_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("entry", ["plan", "train"])
def test_result_line_of_a_tiny_cpu_cell(entry, traced):
    cell = tiny.cell(entry)
    line = json.dumps(tiny.run(cell, seed=2**31 + 77, traced=traced))
    result = json.loads(line)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from perfbench import harness\nfrom perfbench.tests import tiny\n"
            "tiny.run(tiny.cell('plan'), 5, False); tiny.run(tiny.cell('train'), 5, False)\n"
            "print(harness.forbidden_modules())").format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jax_free", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name in ("repro", "repro.core.planner", "jaxlib", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == sorted(["repro", "repro.core.planner", "jaxlib",
                                                  "jax.numpy", "flax"])


def _run_py(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "plan.google-n20",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    out = _run_py(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_with_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_plan_requests_visit_every_class_each_cycle_and_repeat_by_seed():
    a = traffic.plan_requests({}, 10, 2**31 + 3)
    first = [next(a) for _ in range(30)]
    for k in range(3):
        assert sorted(c for c, _ in first[10 * k: 10 * k + 10]) == list(range(10))
    b = traffic.plan_requests({}, 10, 2**31 + 3)
    assert [next(b) for _ in range(30)] == first
    assert len({s for _, s in first}) == 30


def test_lm_batches_differ_by_step_and_repeat_by_seed():
    mix = {"batch": 4, "seq": 16}
    one = traffic.lm_batch(mix, 512, 9, 0, "cpu")
    again = traffic.lm_batch(mix, 512, 9, 0, "cpu")
    other = traffic.lm_batch(mix, 512, 9, 1, "cpu")
    assert all((one[k] == again[k]).all() for k in one)
    assert not (one["tokens"] == other["tokens"]).all()
    assert (one["tokens"][:, 1:] == one["labels"][:, :-1]).all()
    assert len({tuple(r.tolist()) for r in one["tokens"]}) == 4
