"""PyTorch port, RHE and RHE-DOM end to end on the CPU: the port's engine
against the JAX package's Engine on its kernel path (Pallas in interpret
mode, float32), cached == streaming bitwise, the split2 envelope, and the
port's CLI on the example dataset against the committed golden outputs and
the reference implementation's run."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyrhe_tpu.core.data import load_dataset as jax_load_dataset
from pyrhe_tpu.core.engine import Engine as JaxEngine
from pyrhe_tpu.core.engine import ModelSpec as JaxModelSpec
from pyrhe_tpu.core.engine import RunConfig as JaxRunConfig

from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig

from parse_output import parse_output_file
from test_golden_example import REFERENCE_RUN

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def files(ds, annot, cov):
    return dict(annot_file=ds["annot1_path" if annot == 1 else
                               "annot8_path"],
                pheno_file=ds["pheno_path"],
                cov_file=ds["cov_path"] if cov else None,
                num_random_vec=4, seed=7)


def run_port(ds, annot=1, cov=False, impute="binary", streaming=False,
             model="rhe", split=False):
    """The port's engine on the CPU; split=True forces the card's split2
    operands (bf16 hi/lo halves) through the plain versions."""
    data = load_dataset(ds["prefix"], **files(ds, annot, cov))
    eng = Engine(data, ModelSpec.build(model),
                 RunConfig(num_random_vec=4, num_jack=4, seed=7,
                           geno_impute_method=impute, device="cpu",
                           streaming=streaming))
    eng.split = split
    eng.run_precompute_and_assemble()
    return eng


def run_jax(ds, annot=1, cov=False, impute="binary", model="rhe"):
    data = jax_load_dataset(ds["prefix"], **files(ds, annot, cov))
    ref = JaxEngine(data, JaxModelSpec.build(model),
                    JaxRunConfig(num_random_vec=4, num_jack=4, seed=7,
                                 geno_impute_method=impute, dtype="float32",
                                 use_pallas=True))
    ref.run_precompute_and_assemble()
    return ref


def assert_engines_close(eng, ref):
    assert eng.n_pad == ref.n_pad
    np.testing.assert_array_equal(eng.M_mat, ref.M_mat)
    # tolerances of tests/test_pallas_engine.py
    np.testing.assert_allclose(eng.T_all, ref.T_all, rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(eng.q_all, ref.q_all, rtol=5e-4, atol=5e-3)
    _, st = eng.estimate(0)
    _, st_ref = ref.estimate(0)
    np.testing.assert_allclose(st, st_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("which,annot,cov,impute", [
    ("small", 1, False, "binary"),
    ("small", 8, True, "binary"),
    ("small", 1, True, "mean"),
    ("small", 8, False, "mean"),
    ("filtered", 1, True, "binary"),
])
def test_port_matches_jax_pallas_engine(small_dataset, filtered_dataset,
                                        which, annot, cov, impute):
    ds = small_dataset if which == "small" else filtered_dataset
    assert_engines_close(run_port(ds, annot, cov, impute),
                         run_jax(ds, annot, cov, impute))


@pytest.mark.parametrize("which,annot,cov", [
    ("small", 1, False), ("small", 8, True),
    ("filtered", 1, True), ("filtered", 8, False),
])
def test_port_rhe_dom_matches_jax_pallas_engine(small_dataset,
                                                filtered_dataset, which,
                                                annot, cov):
    ds = small_dataset if which == "small" else filtered_dataset
    eng = run_port(ds, annot, cov, model="rhe_dom")
    assert eng.E == 2 * eng.K
    assert_engines_close(eng, run_jax(ds, annot, cov, model="rhe_dom"))


@pytest.mark.parametrize("which,annot,cov", [
    ("small", 8, True), ("filtered", 1, False),
])
def test_port_streaming_equals_cached(small_dataset, filtered_dataset,
                                      which, annot, cov):
    ds = small_dataset if which == "small" else filtered_dataset
    check_streaming_equals_cached(ds, annot, cov, "rhe", False)


@pytest.mark.parametrize("which,annot,cov,split", [
    ("small", 8, True, False), ("filtered", 1, False, False),
    ("small", 8, False, True),
])
def test_port_rhe_dom_streaming_equals_cached(small_dataset,
                                              filtered_dataset, which,
                                              annot, cov, split):
    """Streaming pass 1 runs the dominance totals through ytg_acc2_matmul,
    cached pass 1 through two ytg_matmul calls: bitwise equal, unsplit and
    split2."""
    ds = small_dataset if which == "small" else filtered_dataset
    check_streaming_equals_cached(ds, annot, cov, "rhe_dom", split)


def check_streaming_equals_cached(ds, annot, cov, model, split):
    cached = run_port(ds, annot, cov, model=model, split=split)
    streaming = run_port(ds, annot, cov, streaming=True, model=model,
                         split=split)
    assert streaming.cfg.streaming and not cached.cfg.streaming
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)


def check_split2_within_envelope(ds, annot, cov, model):
    """The model with the card's split2 operands (bf16 hi/lo halves through
    the plain versions) against the unsplit f32 run, inside the split2
    envelope of tests/test_engine_vs_oracle.py (rtol 3e-4). Prints the gap
    (pytest -s shows it)."""
    ref = run_port(ds, annot, cov, model=model)
    eng = run_port(ds, annot, cov, model=model, split=True)
    _, st_ref = ref.estimate(0)
    _, st = eng.estimate(0)
    gap = np.abs(st - st_ref).max()
    print(f"split2 gap {model} annot={annot} cov={cov}: max |sigma2| "
          f"change {gap:.3e}, {gap / np.abs(st_ref).max():.3e} of max "
          "|sigma2|")
    np.testing.assert_allclose(st, st_ref, rtol=3e-4,
                               atol=3e-4 * np.abs(st_ref).max())


@pytest.mark.parametrize("annot,cov", [(8, True), (1, False)])
def test_port_rhe_dom_split2_within_envelope(small_dataset, annot, cov):
    """RHE-DOM, whose dominance encoding alpha·g − g² is the cancellation
    split2 could lose most on."""
    check_split2_within_envelope(small_dataset, annot, cov, "rhe_dom")


@pytest.mark.parametrize("annot,cov", [(8, True), (1, False)])
def test_port_rhe_split2_within_envelope(small_dataset, annot, cov):
    """RHE on the same data: the baseline RHE-DOM's gap is read against."""
    check_split2_within_envelope(small_dataset, annot, cov, "rhe")


@pytest.fixture(scope="module")
def example_dir(tmp_path_factory):
    """The example dataset (example/make_example.py's seeds), made by the
    port's own generator."""
    from pyrhe_tpu_torch.io import synth
    d = tmp_path_factory.mktemp("torch_example")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        synth.make_dataset("test", 5000, 10000, seed=42, missing_rate=0.005)
        a1 = synth.make_annot("single.annot", 10000, 1, seed=42)
        synth.make_annot("multi.annot", 10000, 8, seed=43)
        cov = synth.make_cov_file("test.cov", 5000, num_cov=5, seed=42)
        env = synth.make_env_file("test.env", 5000, num_env=1, seed=42)
        synth.simulate_pheno_file("test", "test", [0.2], a1, seed=44,
                                  cov=cov, env=env, sigma_gxe=0.05)
    finally:
        os.chdir(cwd)
    shutil.copytree(os.path.join(ROOT, "example", "configs"), d / "configs")
    return d


def run_port_cli(example_dir, model, name):
    """The port's CLI on the CPU with example/configs/<model>/<name>.txt,
    its output redirected into the example dir; returns the parsed
    report."""
    out = example_dir / f"out_{model}_{name}.txt"
    cfg = example_dir / "configs" / model / f"{name}.txt"
    cfg.write_text(cfg.read_text().replace(
        f"output = outputs/{model}/{name}.txt", f"output = {out}"))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.cli", "--config",
                    str(cfg), "--device", "cpu", "--suppress"],
                   check=True, cwd=example_dir, env=env)
    return parse_output_file(str(out))


def assert_matches_golden(got, golden, rtol=3e-4):
    """SE overlap (the reference's is_within_range) plus a relative bound
    of rtol·max(1, |golden|) on every reported estimate."""
    for key in ("sigma2_g", "h2_g", "enrichment_g"):
        assert len(got[key]) == len(golden[key]) >= 1, key
        for a, b in zip(got[key], golden[key]):
            assert abs(a["value"] - b["value"]) <= a["se"] + b["se"] + 1e-12
            if rtol is not None:
                assert abs(a["value"] - b["value"]) <= rtol * max(
                    1.0, abs(b["value"]))
    for key in ("sigma2_e", "total_h2"):
        a, b = got[key], golden[key]
        assert abs(a["value"] - b["value"]) <= a["se"] + b["se"]
        if rtol is not None:
            assert abs(a["value"] - b["value"]) <= rtol * max(
                1.0, abs(b["value"]))


def test_port_cli_reproduces_golden_and_reference_run(example_dir):
    got = run_port_cli(example_dir, "rhe", "no_streaming_bin_1")
    assert_matches_golden(got, parse_output_file(os.path.join(
        ROOT, "example", "outputs", "rhe", "no_streaming_bin_1.txt")))
    for ours, (ref_val, ref_se) in (
            (got["sigma2_g"][0], REFERENCE_RUN["sigma2_g0"]),
            (got["sigma2_e"], REFERENCE_RUN["sigma2_e"]),
            (got["h2_g"][0], REFERENCE_RUN["h2_g0"])):
        assert abs(ours["value"] - ref_val) <= 1e-3
        assert abs(ours["se"] - ref_se) <= 1e-3


@pytest.mark.parametrize("name", ["no_streaming_bin_8", "streaming_bin_8"])
def test_port_cli_rhe_dom_reproduces_goldens(example_dir, name):
    """--model rhe_dom (cached and --streaming) on the example dataset with
    8 bins: 16 σ² rows within SE overlap and 3e-4·max(1, |golden|) of our
    golden, and within SE overlap of the reference implementation's run."""
    got = run_port_cli(example_dir, "rhe_dom", name)
    assert len(got["sigma2_g"]) == 16
    outputs = os.path.join(ROOT, "example", "outputs")
    assert_matches_golden(got, parse_output_file(
        os.path.join(outputs, "rhe_dom", f"{name}.txt")))
    assert_matches_golden(got, parse_output_file(
        os.path.join(outputs, "reference", "rhe_dom", f"{name}.txt")),
        rtol=None)
