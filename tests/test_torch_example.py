"""The port's example workflow on the CPU: pyrhe_tpu_torch.make_example
against example/make_example.py byte for byte and without jax, the shipped
example configs that no other test drives through the port's CLI against
their goldens and the reference implementation's outputs, and the
two-trait phenotype file through the CLI in float64 against each trait
run alone."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyrhe_tpu_torch import make_example
from pyrhe_tpu_torch.cli import cli_entry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = os.path.join(ROOT, "example", "outputs")
FILES = ("test.bed", "test.bim", "test.fam", "test.cov", "test.env",
         "test.pheno", "single.annot", "multi.annot", "test.pheno.multi")

# One estimate line of a report, in the order printed: Sigma^2_g/gxe/nxe/e,
# h2_g/gxe/nxe, Total h2 (and _g, _gxe), Enrichment g, each with its SE
# (RHE and RHE-DOM write "h2_g[i] : value : SE").
ESTIMATE = re.compile(r"^(Sigma\^2_\w+(?:\[\d+\])?|h2_\w+\[\d+\]|Total h2\w*|"
                      r"Enrichment g\[\d+\]) : ([-\d.e]+) +(?:SE ?)?: ?"
                      r"([\d.e-]+)$", re.M)


@pytest.fixture(scope="module")
def example_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_example")
    make_example.main(str(d))
    return d


def estimates(text):
    """[(name, value, SE)] of every estimate line of a report, in order
    (RHE prints h2 and Total h2 twice: non-overlapping, then overlapping
    bins)."""
    return [(n, float(v), float(se)) for n, v, se in ESTIMATE.findall(text)]


def read(path):
    with open(path) as f:
        return f.read()


def run_config(example_dir, model, name, tag="", *flags, **overrides):
    """example/configs/<model>/<name>.txt through the port's CLI in this
    process on the CPU, from the example dir, its output redirected there
    and any other key of the config replaced by overrides. Returns the
    report's text."""
    out = example_dir / f"out_{model}_{name}{tag}.txt"
    text = read(os.path.join(ROOT, "example", "configs", model,
                             f"{name}.txt"))
    lines = [f"output = {out}" if line.startswith("output =") else line
             for line in text.splitlines()]
    for key, value in overrides.items():
        lines = [f"{key} = {value}" if line.startswith(f"{key} =") else line
                 for line in lines]
    cfg = example_dir / f"cfg_{model}_{name}{tag}.txt"
    cfg.write_text("\n".join(lines) + "\n")
    cwd = os.getcwd()
    os.chdir(example_dir)
    try:
        cli_entry(["--config", str(cfg), "--device", "cpu", "--suppress",
                   *flags])
    finally:
        os.chdir(cwd)
    return read(out)


def assert_report_matches(got, golden, rtol=3e-4):
    """The same estimate lines in the same order; each within SE overlap
    (the reference's is_within_range) and, when rtol is given,
    rtol·max(1, |golden|)."""
    assert [g[0] for g in got] == [g[0] for g in golden]
    for (name, v, se), (_, gv, gse) in zip(got, golden):
        assert abs(v - gv) <= se + gse, (name, v, se, gv, gse)
        if rtol is not None:
            assert abs(v - gv) <= rtol * max(1.0, abs(gv)), (name, v, gv)


def test_make_example_matches_jax_generator(example_dir, tmp_path):
    """All nine files byte-identical to a copy of example/make_example.py
    run in another directory."""
    shutil.copy(os.path.join(ROOT, "example", "make_example.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, str(tmp_path / "make_example.py")],
                   check=True, env=env, capture_output=True)
    for name in FILES:
        assert (example_dir / name).read_bytes() == \
            (tmp_path / name).read_bytes(), name


def test_make_example_runs_without_jax_or_torch(tmp_path):
    """`python -m pyrhe_tpu_torch.make_example` with jax, pyrhe_tpu and
    torch made unimportable writes all nine files."""
    code = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'pyrhe_tpu', 'torch'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.argv = ['make_example', '--out', {str(tmp_path)!r}]\n"
        "runpy.run_module('pyrhe_tpu_torch.make_example', "
        "run_name='__main__')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pyrhe_tpu', 'torch')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": ROOT})
    assert sorted(os.listdir(tmp_path)) == sorted(FILES)


# The shipped configs no other test file runs through the port's CLI
# (test_torch_engine: rhe no_streaming_bin_1, rhe_dom *_bin_8;
# test_torch_genie: genie *_bin_8).
@pytest.mark.parametrize("model,name", [
    ("rhe", "no_streaming_bin_8"), ("rhe", "streaming_bin_1"),
    ("rhe", "streaming_bin_8"), ("rhe_dom", "no_streaming_bin_1"),
    ("rhe_dom", "streaming_bin_1"), ("genie", "no_streaming_bin_1"),
    ("genie", "streaming_bin_1"),
])
def test_port_cli_config_reproduces_goldens(example_dir, model, name):
    """Every estimate within SE overlap and 3e-4·max(1, |golden|) of our
    golden, and within SE overlap of the reference implementation's
    output (its StreamingGENIE deadlocks: GENIE is held to its cached
    run, as streaming == cached is the port's contract)."""
    got = estimates(run_config(example_dir, model, name))
    assert got
    assert_report_matches(got, estimates(read(os.path.join(
        OUTPUTS, model, f"{name}.txt"))))
    ref = f"no_{name.removeprefix('no_')}" if model == "genie" else name
    assert_report_matches(got, estimates(read(os.path.join(
        OUTPUTS, "reference", model, f"{ref}.txt"))), rtol=None)


def test_port_cli_two_traits_match_each_trait_alone(example_dir):
    """test.pheno.multi through the CLI in float64 reports two traits;
    each trait's estimates and SEs within rtol 1e-8 of a run on that
    trait's column alone (every trait rides the same probes, so only q
    differs; test_torch_exports' multi-trait test)."""
    cfg = ("rhe", "no_streaming_bin_1")
    text = run_config(example_dir, *cfg, "_multi", "--dtype", "float64",
                      phenotype="test.pheno.multi")
    assert "Number of traits: 2" in text
    sections = text.split("OUTPUT FOR TRAIT ")[1:]
    assert [s.split(":")[0] for s in sections] == ["0", "1"]
    rows = [line.split() for line in read(
        example_dir / "test.pheno.multi").splitlines()]
    for t, section in enumerate(sections):
        with open(example_dir / f"trait{t}.pheno", "w") as f:
            f.writelines(f"{r[0]} {r[1]} {r[2 + t]}\n" for r in rows)
        solo = estimates(run_config(example_dir, *cfg, f"_trait{t}",
                                    "--dtype", "float64",
                                    phenotype=f"trait{t}.pheno"))
        got = estimates(section)
        assert [g[0] for g in got] == [s[0] for s in solo]
        np.testing.assert_allclose([g[1:] for g in got],
                                   [s[1:] for s in solo], rtol=1e-8,
                                   atol=1e-12)
