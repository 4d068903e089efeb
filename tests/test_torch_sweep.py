"""PyTorch port, phenotype sweep (pyrhe_tpu_torch.sweep_phenotypes) on the
CPU: tests/test_sweep.py's three tests on the port, the port's sweep in
float64 against the JAX sweep (scripts/sweep_phenotypes.py) on the same
files, the module run as a script, the card refusal, and that no group's
model outlives its group."""
import json
import os
import shutil
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from pyrhe_tpu_torch.core.engine import Engine
from pyrhe_tpu_torch.io import synth
from pyrhe_tpu_torch.sweep_phenotypes import (build_parser, group_pheno_files,
                                              merge_pheno_files, run_sweep)

from parse_output import parse_output_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import sweep_phenotypes as jax_sweep  # noqa: E402

torch.set_num_threads(2)

# the port's models default to float32; float64 holds them to the JAX
# sweep, which runs float64 on the CPU under the tests' x64 config
CPU64 = ("--device", "cpu", "--dtype", "float64")
FIELDS = ("sigma_ests_total", "sig_errs", "h2_total", "h2_errs")


def make_pheno_files(small_dataset, d):
    """tests/test_sweep.py's files: a/b complete phenotypes (mergeable),
    c with NA rows (own group); b drawn by the port's synth."""
    a = os.path.join(d, "a.pheno")
    shutil.copy(small_dataset["pheno_path"], a)
    synth.simulate_pheno_file(os.path.join(d, "b"),
                              small_dataset["prefix"], [0.5],
                              small_dataset["annot1"], seed=21)
    with open(a) as f:
        lines = f.read().splitlines()
    c = os.path.join(d, "c.pheno")
    with open(c, "w") as f:
        for i, ln in enumerate(lines):
            if i in (5, 10):
                cols = ln.split()
                ln = " ".join(cols[:2] + ["NA"] * (len(cols) - 2))
            f.write(ln + "\n")
    return [a, os.path.join(d, "b.pheno"), c]


def sweep_argv(small_dataset, d, out, *extra):
    return ["-g", small_dataset["prefix"],
            "-annot", small_dataset["annot1_path"],
            "--pheno_glob", os.path.join(d, "*.pheno"),
            "-o", str(out), "-k", "4", "-jn", "4", *extra]


@pytest.fixture
def phenos(small_dataset, tmp_path):
    d = str(tmp_path / "phenos")
    os.makedirs(d)
    make_pheno_files(small_dataset, d)
    return d


def test_sweep_reports_carry_engine_messages(small_dataset, phenos, tmp_path,
                                             monkeypatch):
    """test_sweep.test_sweep_reports_carry_engine_messages on the port:
    what the engine logs during the lazy shared precompute lands in the
    first file's report of its group, and only there."""
    orig = Engine.precompute

    def noisy(self):
        self.log._log("ENGINE-NOTE-MARKER")
        return orig(self)

    monkeypatch.setattr(Engine, "precompute", noisy)
    run_sweep(build_parser().parse_args(sweep_argv(
        small_dataset, phenos, tmp_path / "out", "--device", "cpu")))
    texts = {n: (tmp_path / "out" / f"{n}.txt").read_text()
             for n in ("a", "b", "c")}
    assert "ENGINE-NOTE-MARKER" in texts["a"]
    assert "ENGINE-NOTE-MARKER" in texts["c"]
    assert "ENGINE-NOTE-MARKER" not in texts["b"]


def test_grouping_by_missing_set(small_dataset, tmp_path):
    files = make_pheno_files(small_dataset, str(tmp_path))
    groups = group_pheno_files(sorted(files))
    assert sorted(len(g) for g in groups) == [1, 2]
    merged = next(g for g in groups if len(g) == 2)
    assert {os.path.basename(p) for p in merged} == {"a.pheno", "b.pheno"}
    assert groups == jax_sweep.group_pheno_files(sorted(files))


def test_sweep_merges_and_matches_individual_runs(small_dataset, phenos,
                                                  tmp_path, monkeypatch):
    """test_sweep.test_sweep_merges_and_matches_individual_runs on the port
    in float64: one genome pass per group, merged == --no_merge at rtol
    1e-10, and every report parses to the summary's sigma^2."""
    passes = []
    orig = Engine.precompute
    monkeypatch.setattr(Engine, "precompute",
                        lambda self: (passes.append(1), orig(self))[1])

    def sweep(outdir, extra=()):
        return run_sweep(build_parser().parse_args(sweep_argv(
            small_dataset, phenos, tmp_path / outdir, *CPU64, *extra)))

    merged = sweep("merged")
    assert len(passes) == 2, \
        "a+b share one genome pass; c (different missing set) gets its own"
    assert set(merged) == {"a", "b", "c"}

    passes.clear()
    solo = sweep("solo", ["--no_merge"])
    assert len(passes) == 3
    for key in merged:
        for field in ("sigma_ests_total", "h2_total", "sig_errs"):
            np.testing.assert_allclose(
                merged[key][field], solo[key][field], rtol=1e-10,
                atol=1e-12, err_msg=f"{key}/{field}")

    for name in ("a", "b", "c"):
        res = parse_output_file(str(tmp_path / "merged" / f"{name}.txt"))
        assert res["sigma2_g"], name
        np.testing.assert_allclose(
            res["sigma2_g"][0]["value"],
            merged[name]["sigma_ests_total"][0], rtol=1e-9)


@pytest.mark.parametrize("annot", ["annot1_path", "annot8_path"])
def test_sweep_float32_merged_equals_solo_bitwise(small_dataset, phenos,
                                                  tmp_path, annot):
    """In float32 a merged trait's results are the bits of its file run
    alone: the column sums and yXXy entries of the stage-1 glue reduce
    each column on its own, whatever the pass's width (ops/moments)."""
    def sweep(out, *extra):
        argv = sweep_argv(small_dataset, phenos, tmp_path / out, "-c",
                          small_dataset["cov_path"], "--device", "cpu",
                          *extra)
        argv[argv.index("-annot") + 1] = small_dataset[annot]
        return run_sweep(build_parser().parse_args(argv))

    merged, solo = sweep("merged"), sweep("solo", "--no_merge")
    assert set(merged) == set(solo) == {"a", "b", "c"}
    for key in merged:
        for field, value in merged[key].items():
            if field != "runtime":
                assert value == solo[key][field], f"{key}/{field}"


@pytest.mark.parametrize("extra", [(), ("--streaming",)])
def test_sweep_matches_jax_sweep(small_dataset, phenos, tmp_path, extra):
    """The port's sweep (float64, CPU) against the JAX sweep on the same
    files, with covariates: the same groups, merged file and summary keys,
    sigma^2 / SE / h2 (and their SEs) at rtol 1e-8."""
    def argv(out):
        return sweep_argv(small_dataset, phenos, tmp_path / out, "-c",
                          small_dataset["cov_path"], *extra)

    port = run_sweep(build_parser().parse_args([*argv("port"), *CPU64]))
    ref = jax_sweep.run_sweep(jax_sweep.build_parser().parse_args(
        argv("jax")))
    assert list(port) == list(ref) == ["a", "b", "c"]
    assert ((tmp_path / "port" / "_merged_group0.pheno").read_bytes()
            == (tmp_path / "jax" / "_merged_group0.pheno").read_bytes())
    for key in ref:
        assert set(port[key]) == set(ref[key])
        for field in FIELDS:
            np.testing.assert_allclose(
                port[key][field], ref[key][field], rtol=1e-8,
                atol=1e-10, err_msg=f"{key}/{field}")


def test_sweep_runs_as_a_module(small_dataset, phenos, tmp_path):
    """`python -m pyrhe_tpu_torch.sweep_phenotypes` on the CPU in a process
    of its own, with no -o: the output goes to $RESULT_DIR/sweep_out
    (constant.py), one report per file and a summary of every trait."""
    argv = sweep_argv(small_dataset, phenos, "unused", "--device", "cpu")
    argv = argv[:argv.index("-o")] + argv[argv.index("-o") + 2:]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               RESULT_DIR=str(tmp_path / "results"))
    r = subprocess.run(
        [sys.executable, "-m", "pyrhe_tpu_torch.sweep_phenotypes", *argv],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert r.returncode == 0, r.stderr
    assert "3 phenotype files -> 2 genome pass(es)" in r.stdout
    assert "group 1/2: 2 file(s), 2 trait(s)" in r.stdout
    out = tmp_path / "results" / "sweep_out"
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == {"a", "b", "c"}
    for name in summary:
        got = parse_output_file(str(out / f"{name}.txt"))
        assert got["sigma2_e"]["value"] == summary[name][
            "sigma_ests_total"][-1]


def test_sweep_device_auto_raises_without_card(small_dataset, phenos,
                                               tmp_path, monkeypatch):
    """--device defaults to the card and raises without one, before any
    file is read or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(sweep_argv(small_dataset, phenos,
                                                tmp_path / "out"))
    assert args.device == "auto"
    with pytest.raises(RuntimeError, match="is_available"):
        run_sweep(args)
    assert not (tmp_path / "out").exists()


def test_sweep_frees_each_group_model(small_dataset, phenos, tmp_path,
                                      monkeypatch):
    """No group's engine is alive when the next group's is built (on the
    card its stats cache would add to the next group's peak), none
    survives the sweep, and the summary holds plain JSON values only."""
    refs, alive = [], []
    orig = Engine.__init__

    def init(self, *a, **k):
        alive.append(sum(r() is not None for r in refs))
        refs.append(weakref.ref(self))
        orig(self, *a, **k)

    monkeypatch.setattr(Engine, "__init__", init)
    summary = run_sweep(build_parser().parse_args(sweep_argv(
        small_dataset, phenos, tmp_path / "out", "--device", "cpu",
        "--no_merge")))
    assert alive == [0, 0, 0]
    assert all(r() is None for r in refs)
    assert json.loads(json.dumps(summary)) == summary


def test_merge_refuses_reordered_rows(tmp_path):
    """Merging is row-positional: a file listing the same individuals in
    another order is refused."""
    rows = [("0", "1", "0.5"), ("1", "1", "-0.2"), ("2", "1", "1.1")]
    for name, order in (("x", rows), ("y", rows[::-1])):
        with open(tmp_path / f"{name}.pheno", "w") as f:
            f.write("FID IID pheno\n")
            f.writelines(" ".join(r) + "\n" for r in order)
    paths = [str(tmp_path / "x.pheno"), str(tmp_path / "y.pheno")]
    with pytest.raises(ValueError, match="differently ordered"):
        merge_pheno_files(paths, str(tmp_path / "m.pheno"))
    assert merge_pheno_files(paths[:1] * 2, str(tmp_path / "m.pheno")) \
        == [1, 1]
    assert (tmp_path / "m.pheno").read_text().splitlines()[:2] == [
        "FID IID x_pheno x_pheno", "0 1 0.5 0.5"]
