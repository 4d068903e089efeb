"""The harness finds its files by name and runs each cell's code path on
the CPU at a tiny size, printing a contract-shaped result."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

HERE = os.path.join(ROOT, "h100_bench")
sys.path.insert(0, HERE)
import run as run_py  # noqa: E402

from h100_bench import harness  # noqa: E402

CELLS = [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def test_every_file_is_found_by_name(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert sorted(names) == sorted(CELLS)
    for name in names:
        cell = harness.load_cell(name)
        assert cell.config["name"] == next(
            w["config"] for w in bench["workloads"] if w["name"] == name)
        assert cell.traffic["mode"] in ("cached", "hybrid", "streaming")
        assert cell.end_to_end and cell.per_layer
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_a_result(name, trace, tiny, cache):
    cell = tiny(name)
    run = harness.measure(cell, 2**31 + 11, 0.5, bool(trace), device="cpu",
                         cache=cache)
    line = run_py.result(run, bool(trace), "cpu", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())
    expected = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in expected}
    assert set(line["metrics"]) <= names
    # host-clock and program-span metrics read on the CPU too; device
    # metrics find nothing to read there and stay out of the line
    if trace:
        assert {"load_s", "pass2_s", "h2d_s"} <= set(line["metrics"])
        assert "glue_s" not in line["metrics"]
        assert line["device"]["window_s"] > 0
    else:
        assert {"setup_s", "peak_host_gb"} <= set(line["metrics"])
        assert "device_s" not in line["metrics"]
    assert all(e["wall_s"] > 0 for e in line["estimates"])
    json.dumps(line)


def test_device_busy_is_the_union_of_the_activities():
    from h100_bench import devtrace
    busy, gaps = devtrace._union([(5, 9), (0, 2), (1, 3), (8, 12)], 0, 15)
    assert busy == 3 + 7
    assert sorted(gaps) == [(2, 3, 5), (3, 12, 15)]


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


_NO_JAX = """
import json, sys
sys.path.insert(0, {root!r})
from h100_bench import harness
cell = harness.load_cell({cell!r})
cell.config.update({tiny!r})
run = harness.measure(cell, 5, 0.2, {trace}, device="cpu", cache={cache!r})
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": run.correct, "forbidden": run.forbidden,
                   "loaded": loaded}}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_nothing_imports_jax_or_the_jax_package(trace, cache):
    code = _NO_JAX.format(root=ROOT, cell=CELLS[0], tiny=TINY, trace=trace,
                          cache=cache)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["forbidden"] == []
    assert "pyrhe_tpu_torch" in out["loaded"]
    for top in harness.FORBIDDEN:
        assert top not in out["loaded"]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrhe_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_the_card(name, trace, card, tiny, cache):
    run = harness.measure(tiny(name), 7, 0.5, trace, device=card,
                         cache=cache)
    assert run.correct, run.checks
    assert run.device_busy_s > 0
    if trace:
        assert run.trace.busy_s == run.device_busy_s
        assert run.trace.kernels_s > 0
