"""Fixtures of the benchmark's CPU tests: tiny cells and one shared cohort
cache. Tests marked `cuda` need a card and skip without one (the fixture
`card` decides, never an import)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# a tiny cut of every configuration: J = 10 blocks of 100 SNPs, N = 2,000
TINY = dict(num_indiv=2000, num_snp=1000, num_jack=10)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (on the card: "
        "python -m pytest h100_bench/tests)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("h100_bench_cache"))


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name, **over):
    """A cell of BENCHMARK.json, or "<config>.<traffic>" of the files,
    cut to the tiny size."""
    from h100_bench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"] for w in json.load(f)["workloads"]}
    if name in cells:
        cell = harness.load_cell(name)
    else:
        config, traffic = name.rsplit(".", 1)
        cell = harness.cell_of(name, config, traffic)
    cell.config.update(TINY, **over)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
