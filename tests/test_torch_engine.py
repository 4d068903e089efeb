"""PyTorch port, the slice end to end on the CPU: the port's engine against
the JAX package's Engine on its kernel path (Pallas in interpret mode,
float32), cached == streaming bitwise, and the port's CLI on the example
dataset against the committed golden output and the reference
implementation's run."""
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


def run_port(ds, annot=1, cov=False, impute="binary", streaming=False):
    data = load_dataset(ds["prefix"], **files(ds, annot, cov))
    eng = Engine(data, ModelSpec.build("rhe"),
                 RunConfig(num_random_vec=4, num_jack=4, seed=7,
                           geno_impute_method=impute, device="cpu",
                           streaming=streaming))
    eng.run_precompute_and_assemble()
    return eng


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
    data = jax_load_dataset(ds["prefix"], **files(ds, annot, cov))
    ref = JaxEngine(data, JaxModelSpec.build("rhe"),
                    JaxRunConfig(num_random_vec=4, num_jack=4, seed=7,
                                 geno_impute_method=impute, dtype="float32",
                                 use_pallas=True))
    ref.run_precompute_and_assemble()
    eng = run_port(ds, annot, cov, impute)
    assert eng.n_pad == ref.n_pad
    np.testing.assert_array_equal(eng.M_mat, ref.M_mat)
    # tolerances of tests/test_pallas_engine.py
    np.testing.assert_allclose(eng.T_all, ref.T_all, rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(eng.q_all, ref.q_all, rtol=5e-4, atol=5e-3)
    _, st = eng.estimate(0)
    _, st_ref = ref.estimate(0)
    np.testing.assert_allclose(st, st_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("which,annot,cov", [
    ("small", 8, True), ("filtered", 1, False),
])
def test_port_streaming_equals_cached(small_dataset, filtered_dataset,
                                      which, annot, cov):
    ds = small_dataset if which == "small" else filtered_dataset
    cached = run_port(ds, annot, cov)
    streaming = run_port(ds, annot, cov, streaming=True)
    assert streaming.cfg.streaming and not cached.cfg.streaming
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)


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
        cov = synth.make_cov_file("test.cov", 5000, num_cov=5, seed=42)
        env = synth.make_env_file("test.env", 5000, num_env=1, seed=42)
        synth.simulate_pheno_file("test", "test", [0.2], a1, seed=44,
                                  cov=cov, env=env, sigma_gxe=0.05)
    finally:
        os.chdir(cwd)
    shutil.copytree(os.path.join(ROOT, "example", "configs"), d / "configs")
    return d


def test_port_cli_reproduces_golden_and_reference_run(example_dir):
    out = example_dir / "out.txt"
    cfg = example_dir / "configs" / "rhe" / "no_streaming_bin_1.txt"
    cfg.write_text(cfg.read_text().replace(
        "output = outputs/rhe/no_streaming_bin_1.txt", f"output = {out}"))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.cli", "--config",
                    str(cfg), "--device", "cpu", "--suppress"],
                   check=True, cwd=example_dir, env=env)
    got = parse_output_file(str(out))
    golden = parse_output_file(os.path.join(
        ROOT, "example", "outputs", "rhe", "no_streaming_bin_1.txt"))
    for key in ("sigma2_g", "h2_g", "enrichment_g"):
        assert len(got[key]) == len(golden[key]) >= 1, key
        for a, b in zip(got[key], golden[key]):
            assert abs(a["value"] - b["value"]) <= a["se"] + b["se"] + 1e-12
            assert abs(a["value"] - b["value"]) <= 3e-4 * max(
                1.0, abs(b["value"]))
    for key in ("sigma2_e", "total_h2"):
        a, b = got[key], golden[key]
        assert abs(a["value"] - b["value"]) <= a["se"] + b["se"]
        assert abs(a["value"] - b["value"]) <= 3e-4 * max(1.0,
                                                          abs(b["value"]))
    for ours, (ref_val, ref_se) in (
            (got["sigma2_g"][0], REFERENCE_RUN["sigma2_g0"]),
            (got["sigma2_e"], REFERENCE_RUN["sigma2_e"]),
            (got["h2_g"][0], REFERENCE_RUN["h2_g0"])):
        assert abs(ours["value"] - ref_val) <= 1e-3
        assert abs(ours["se"] - ref_se) <= 1e-3
