"""The readers of the engine's own host counters (prefetch_wait_s,
engine_init_s): each is the mean of its Engine.phase_times key over a
run's estimates, None where no estimate has the key, and a traced tiny
run of either cell carries both."""
import importlib.util
import os
import sys

import pytest

from conftest import ROOT

HERE = os.path.join(ROOT, "h100_bench")
sys.path.insert(0, HERE)
import run as run_py  # noqa: E402

from h100_bench import harness  # noqa: E402

NEW = ["prefetch_wait_s", "engine_init_s"]
CELLS = ["rhe_k50.streaming", "genie.cached"]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name, os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fake_run(*phase_times):
    run = harness.Run(cell=None, seed=0)
    run.estimates = [{"phase_times": pt} for pt in phase_times]
    return run


@pytest.mark.parametrize("name", NEW)
def test_reader_is_the_mean_over_the_estimates(name):
    run = fake_run({name: 1.0, "pass2_s": 9.0}, {name: 2.5}, {"h2d_s": 4.0})
    assert reader(name)(run) == pytest.approx(1.75)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_the_key(name):
    assert reader(name)(fake_run({"pass1_s": 1.0, "h2d_s": 0.1})) is None
    assert reader(name)(fake_run()) is None


def test_the_entries_name_both_cells(bench):
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert set(m["workloads"]) == set(CELLS)
        assert m["moves"] == "setup_s"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_tiny_run_carries_the_engine_metrics(name, tiny, cache):
    run = harness.measure(tiny(name), 2**31 + 23, 0.5, True, device="cpu",
                          cache=cache)
    line = run_py.result(run, True, "cpu", 1)
    assert line["correct"] is True
    got = line["metrics"]
    assert set(NEW) <= set(got)
    assert all(got[n]["value"] > 0 for n in NEW)
    passes = sum(run.mean_phase(k) for k in ("pass1_s", "pass2_s"))
    assert got["prefetch_wait_s"]["value"] <= passes


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_tiny_run_on_the_card_carries_them(name, card, tiny,
                                                    cache):
    run = harness.measure(tiny(name), 2**31 + 29, 0.5, True, device=card,
                          cache=cache)
    line = run_py.result(run, True, "card", 1)
    assert line["correct"] is True
    got = line["metrics"]
    assert all(got[n]["value"] > 0 for n in NEW)
    labels = [g[0] for g in line["breakdown"]["idle_gaps"]]
    assert all(":" in g for g in labels if g.startswith("h100_bench.pass"))
