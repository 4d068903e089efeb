"""PyTorch port, data utilities on the CPU: tests/test_utils.py's
add_cov_pheno and constant tests on the port, and the port's
simulate_pheno, utils.generate_annot and utils.add_cov_pheno writing the
same files as the JAX package's, byte for byte, for the same arguments
and seeds."""
import filecmp
import importlib
import os
import sys

import numpy as np
import pytest

import simulate_pheno as jax_simulate_pheno
from pyrhe_tpu.utils import add_cov_pheno as jax_add_cov
from pyrhe_tpu.utils import generate_annot as jax_generate_annot

from pyrhe_tpu_torch import simulate_pheno
from pyrhe_tpu_torch.utils import add_cov_pheno, generate_annot


def test_add_cov_effect(tmp_path):
    """test_utils.test_add_cov_effect on the port."""
    rng = np.random.default_rng(0)
    n = 50
    pheno = tmp_path / "t.pheno"
    with open(pheno, "w") as f:
        f.write("FID IID pheno\n")
        y = rng.normal(size=n)
        for i in range(n):
            f.write(f"{i} {i} {y[i]:.6f}\n")
    cov = tmp_path / "t.cov"
    with open(cov, "w") as f:
        f.write("FID IID age sex\n")
        c = rng.normal(size=(n, 2))
        for i in range(n):
            f.write(f"{i} {i} {c[i,0]:.6f} {c[i,1]:.6f}\n")

    out = add_cov_pheno.add_cov_effect(str(pheno), str(cov), effect=2.0)
    got = np.loadtxt(out, skiprows=1, usecols=2)
    cs = (c - c.mean(0)) / c.std(0, ddof=1)   # read_cov std is pandas ddof=1
    np.testing.assert_allclose(got, y + 2.0 * cs.sum(axis=1), atol=2e-5)


@pytest.mark.parametrize("env_value", [None, "/from/env"])
def test_constant_reads_dotenv(tmp_path, monkeypatch, env_value):
    """test_utils.test_constant_reads_dotenv on the port; a real
    environment variable wins over the .env value."""
    (tmp_path / ".env").write_text("RESULT_DIR=/x/results\n# c\nBAD\n")
    monkeypatch.chdir(tmp_path)
    if env_value is None:
        monkeypatch.delenv("RESULT_DIR", raising=False)
    else:
        monkeypatch.setenv("RESULT_DIR", env_value)
    monkeypatch.delenv("DATA_DIR", raising=False)

    import pyrhe_tpu_torch.constant as const
    importlib.reload(const)
    assert const.RESULT_DIR == (env_value or "/x/results")
    assert const.DATA_DIR == "."


def same_tree(a, b):
    """Every file of directory a is in b with the same bytes, and b has no
    other file."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return names


def run_both(monkeypatch, jax_main, port_main, argv_of):
    """The JAX script's main() (reads sys.argv) and the port's main(argv)
    on the same arguments; argv_of(side) gives each side's arguments."""
    monkeypatch.setattr(sys, "argv", ["prog", *argv_of("jax")])
    jax_main()
    port_main(argv_of("port"))


@pytest.mark.parametrize("case", ["annot", "generated_annot_cov"])
def test_simulate_pheno_matches_jax(small_dataset, tmp_path, monkeypatch,
                                    case):
    """The port's simulate_pheno and the root simulate_pheno.py write the
    same replicate files (and the same generated annotation)."""
    ds = small_dataset
    extra = (["-annot", ds["annot8_path"], "--sigma", *["0.05"] * 8,
              "--replicates", "2", "--seed", "4"]
             if case == "annot" else
             ["-b", "2", "--sigma", "0.2", "0.1", "-c", ds["cov_path"],
              "--beta_cov", "0.1", "--replicates", "1", "--seed", "9"])
    for side in ("jax", "port"):     # both write generated_annot into it
        (tmp_path / side).mkdir()    # before they create it
    run_both(monkeypatch, jax_simulate_pheno.main, simulate_pheno.main,
             lambda side: ["-g", ds["prefix"], "-o", str(tmp_path / side),
                           *extra])
    names = same_tree(tmp_path / "jax", tmp_path / "port")
    assert "0.phen" in names
    assert ("generated_annot" in names) == (case != "annot")


@pytest.mark.parametrize("bins,seed", [(8, 3), (2, 0)])
def test_generate_annot_matches_jax(small_dataset, tmp_path, monkeypatch,
                                    bins, seed):
    run_both(monkeypatch, jax_generate_annot.main, generate_annot.main,
             lambda side: ["-g", small_dataset["prefix"], "-b", str(bins),
                           "-o", str(tmp_path / f"{side}.annot"), "--seed",
                           str(seed)])
    got = (tmp_path / "port.annot").read_bytes()
    assert got == (tmp_path / "jax.annot").read_bytes()
    annot = np.loadtxt(tmp_path / "port.annot", ndmin=2)
    assert annot.shape == (800, bins) and np.all(annot.sum(axis=1) == 1)


def test_add_cov_pheno_matches_jax(small_dataset, tmp_path, monkeypatch):
    """The port's utils.add_cov_pheno and the JAX one write the same
    _with_cov files for .phen and .pheno inputs, with and without a
    header, one or two traits."""
    n = 600
    y = np.random.default_rng(17).normal(size=(n, 3))
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        with open(d / "0.phen", "w") as f:
            f.write("FID IID pheno\n")
            f.writelines(f"{i} 1 {y[i, 0]:.6g}\n" for i in range(n))
        with open(d / "two.pheno", "w") as f:
            f.write("FID IID p0 p1\n")
            f.writelines(f"{i} 1 {y[i, 1]:.6g} {y[i, 2]:.4f}\n"
                         for i in range(n))
        with open(d / "bare.phen", "w") as f:
            f.writelines(f"{i} 1 {y[i, 2]:.6g}\n" for i in range(n))
    run_both(monkeypatch, jax_add_cov.main, add_cov_pheno.main,
             lambda side: ["--pheno_dir", str(tmp_path / side), "--cov",
                           small_dataset["cov_path"], "--effect", "0.7"])
    names = same_tree(tmp_path / "jax", tmp_path / "port")
    assert {"0_with_cov.phen", "two_with_cov.pheno",
            "bare_with_cov.phen"} <= set(names)
