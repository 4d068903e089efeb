"""PyTorch port, exports and run options on the CPU: get_XtXz against numpy
and against the JAX package's, simulate_pheno against the JAX one and its
h2 recovery, multi-trait runs against solo runs, the liability report,
--profile_dir, and the CLI flags that select the ported modes and caches
(tests/test_features.py and tests/test_cli.py mirrored)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import load_geno_nan

from pyrhe_tpu.io import synth as jax_synth
from pyrhe_tpu.models import RHE as JaxRHE

from pyrhe_tpu_torch import RHE
from pyrhe_tpu_torch.cli import cli_entry
from pyrhe_tpu_torch.core import solver as S

from parse_output import parse_output_file

torch.set_num_threads(2)

N, M = 600, 800
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_kw(ds, **kw):
    """test_features.make_model's settings."""
    return dict(geno_file=ds["prefix"], annot_file=ds["annot1_path"],
                pheno_file=ds["pheno_path"], num_jack=kw.pop("num_jack", 4),
                num_random_vec=kw.pop("num_random_vec", 4),
                seed=kw.pop("seed", 7), dtype=kw.pop("dtype", "float64"),
                **kw)


def make_model(ds, **kw):
    return RHE(device="cpu", **model_kw(ds, **kw))


def raw_genotypes(eng):
    """(N, M) imputed dosages of the kept individuals, from the port's raw
    blocks in file order."""
    return np.concatenate([eng.unpermute(g.T)
                           for g in eng._iter_raw_blocks(torch.float64)],
                          axis=1)


# ------------------------------------------------------------- get_XtXz
def test_get_XtXz_matches_numpy(small_dataset, tmp_path):
    """test_features.test_get_XtXz_matches_numpy on the port (float64):
    results against numpy at rtol 1e-8, the .txt.bin and .jack_0.txt.bin
    round trip; the dosages are the reference's (its raw blocks)."""
    rhe = make_model(small_dataset)
    out = str(tmp_path / "xtxz")
    results = rhe.get_XtXz(out, jackknife_blocks=True)

    eng = rhe.engine
    G = raw_genotypes(eng)
    ref_eng = JaxRHE(**model_kw(small_dataset)).engine
    G_ref = np.concatenate([np.asarray(g, np.float64).T
                            for g in ref_eng._iter_raw_blocks()], axis=1)
    np.testing.assert_array_equal(G, G_ref)
    geno = load_geno_nan(small_dataset["prefix"], N, M)
    obs = ~np.isnan(geno)
    np.testing.assert_array_equal(G[obs], geno[obs])

    B = eng.B
    Xz = np.zeros((N, B))
    Zs = {}
    for j in range(eng.J):
        s, e = eng._block_range(j)
        Zs[j] = np.random.default_rng([7, j]).normal(size=(e - s, B))
        Xz += G[:, s:e] @ Zs[j]
    expect = G.T @ Xz
    np.testing.assert_allclose(results, expect, rtol=1e-8, atol=1e-8)

    loaded = np.fromfile(out + ".txt.bin").reshape(M, B)
    np.testing.assert_allclose(loaded, results)
    jk0 = np.fromfile(out + ".jack_0.txt.bin").reshape(-1, B)
    s, e = eng._block_range(0)
    Xz_loo = Xz - G[:, s:e] @ Zs[0]
    expect_jk0 = np.delete(G.T @ Xz_loo, np.s_[s:e], axis=0)
    np.testing.assert_allclose(jk0, expect_jk0, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("dtype,rtol", [
    ("float64", 1e-10), ("float32", 1e-5), ("bfloat16", 1e-5)])
def test_get_XtXz_matches_jax_filtered(filtered_dataset, tmp_path, dtype,
                                       rtol):
    """Dropped individuals (NA phenotypes) ride the staged words as
    columns the raw blocks zero: the port's export equals the JAX
    package's on filtered_dataset, every file, at each dtype's mm_mode
    (exact, split2, bf16 products on the same operands; f32 summation
    order apart)."""
    ds = filtered_dataset
    rhe = make_model(ds, dtype=dtype)
    ref = JaxRHE(**model_kw(ds, dtype=dtype))
    assert rhe.num_indv == ref.num_indv == N - ds["n_missing"]
    got = rhe.get_XtXz(str(tmp_path / "port"))
    want = ref.get_XtXz(str(tmp_path / "jax"))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    for j in range(rhe.engine.J):
        a = np.fromfile(str(tmp_path / f"port.jack_{j}.txt.bin"))
        b = np.fromfile(str(tmp_path / f"jax.jack_{j}.txt.bin"))
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())


# -------------------------------------------------------- simulate_pheno
def test_simulate_pheno_matches_jax(small_dataset):
    """y and betas equal to the JAX package's at rtol 1e-10 (float64, same
    seed: the same RandomState draws over the same dosages), and the
    rebuilt engine's estimates too."""
    kw = dict(num_jack=8, num_random_vec=8, seed=3,
              cov_file=small_dataset["cov_path"])
    rhe = make_model(small_dataset, **kw)
    ref = JaxRHE(**model_kw(small_dataset, **kw))
    y, betas = rhe.simulate_pheno([0.5])
    y_ref, betas_ref = ref.simulate_pheno([0.5])
    np.testing.assert_array_equal(betas, betas_ref)
    np.testing.assert_allclose(y, y_ref, rtol=1e-10,
                               atol=1e-10 * np.abs(y_ref).max())
    np.testing.assert_allclose(rhe.data.pheno, ref.data.pheno, rtol=1e-10,
                               atol=1e-10 * np.abs(y_ref).max())
    np.testing.assert_allclose(rhe.estimate(0)[1], ref.estimate(0)[1],
                               rtol=1e-8, atol=1e-10)


def test_simulate_pheno_recovers_h2(small_dataset):
    """test_features.test_simulate_pheno_recovers_h2 on the port."""
    rhe = make_model(small_dataset, num_jack=8, num_random_vec=16, seed=3)
    y, betas = rhe.simulate_pheno([0.5])
    assert y.shape == (N,)
    assert abs(rhe.data.pheno.mean()) < 1e-9
    assert not rhe._computed and rhe.engine.T_traits == 1
    sigma_jack, sigma_total = rhe.estimate(0)
    h2 = S.h2_nonoverlapping(np.vstack([sigma_jack, sigma_total[None]]))
    se = S.jackknife_se(h2[:-1], 8)
    G = raw_genotypes(rhe.engine)
    gvar = ((G - G.mean(0)) @ betas).var()
    truth = gvar / (gvar + (1 - 0.5))
    assert abs(h2[-1, -1] - truth) < 4 * max(se[-1], 0.05)


def test_simulate_pheno_checks_bins(small_dataset):
    with pytest.raises(ValueError, match="number of bins"):
        make_model(small_dataset).simulate_pheno([0.3, 0.2])


# ----------------------------------------------------------- multi-trait
@pytest.fixture(scope="module")
def two_traits(small_dataset, tmp_path_factory):
    """A 2-trait phenotype file and trait 1 alone (test_features'
    multi-trait test)."""
    d = tmp_path_factory.mktemp("traits")
    pheno2 = str(d / "multi")
    jax_synth.simulate_pheno_file(pheno2, small_dataset["prefix"], [0.3],
                                  small_dataset["annot1"], seed=9,
                                  num_traits=2)
    single = str(d / "single.pheno")
    with open(pheno2 + ".pheno") as f, open(single, "w") as g:
        hdr = f.readline().split()
        g.write(f"{hdr[0]} {hdr[1]} {hdr[3]}\n")
        for line in f:
            p = line.split()
            g.write(f"{p[0]} {p[1]} {p[3]}\n")
    return pheno2 + ".pheno", single


@pytest.mark.filterwarnings("error::RuntimeWarning")
def test_multi_trait_matches_independent_single_trait(small_dataset,
                                                      two_traits):
    """Trait 1 of a 2-trait float64 run equals the solo run on that
    column at the JAX test's rtol 1e-10: every trait rides the same
    probe matrix, so only q differs per trait."""
    multi_path, single_path = two_traits
    cov = small_dataset["cov_path"]
    multi = make_model(dict(small_dataset, pheno_path=multi_path),
                       cov_file=cov)
    assert multi.num_traits == 2
    sj_m, st_m = multi.estimate(1)
    solo = make_model(dict(small_dataset, pheno_path=single_path),
                      cov_file=cov)
    sj_s, st_s = solo.estimate(0)
    np.testing.assert_allclose(st_m, st_s, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sj_m, sj_s, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(S.jackknife_se(sj_m, sj_m.shape[0]),
                               S.jackknife_se(sj_s, sj_s.shape[0]),
                               rtol=1e-8, atol=1e-12)


# ------------------------------------------------------------------ CLI
def cli_args(ds, out, *extra):
    return ["-g", ds["prefix"], "-p", ds["pheno_path"], "-annot",
            ds["annot1_path"], "-k", "4", "-jn", "4", "-s", "7", "--device",
            "cpu", "--suppress", "-o", str(out), *extra]


def test_cli_multi_trait(small_dataset, two_traits, tmp_path):
    """test_cli.test_cli_multi_trait on the port's CLI."""
    out = tmp_path / "multi.txt"
    cli_entry(cli_args(dict(small_dataset, pheno_path=two_traits[0]), out))
    content = out.read_text()
    assert "OUTPUT FOR TRAIT 0" in content
    assert "OUTPUT FOR TRAIT 1" in content
    assert content.count("Variance components:") == 2


def test_cli_liability_binary_pheno(small_dataset, tmp_path):
    """test_cli.test_cli_liability_binary_pheno on the port's CLI, in a
    process of its own."""
    bphen = str(tmp_path / "bin.pheno")
    jax_synth.simulate_pheno_file(str(tmp_path / "bin"),
                                  small_dataset["prefix"], [0.4],
                                  small_dataset["annot1"], seed=5,
                                  binary=True)
    out = str(tmp_path / "out.txt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "pyrhe_tpu_torch.cli",
         *cli_args(dict(small_dataset, pheno_path=bphen), out,
                   "--samp_prev", "0.3", "--pop_prev", "0.1")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    content = open(out).read()
    assert "Liability Scale h2 for binary phenotype:" in content
    m = re.search(r"Total Liability-scale h2 : ([-\d.e]+), SE: ([-\d.e]+), "
                  r"p-value: ([-\d.e]+)", content)
    assert m, content
    assert np.isfinite(float(m.group(1)))


def test_cli_profile_dir_writes_a_trace(small_dataset, tmp_path):
    out = tmp_path / "o.txt"
    prof = tmp_path / "prof"
    cli_entry(cli_args(small_dataset, out, "--profile_dir", str(prof)))
    trace = prof / "trace.json"
    assert trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()
    assert f"Profiler trace written to {prof}" in out.read_text()


def sigmas(report):
    got = parse_output_file(str(report))
    return [g["value"] for g in got["sigma2_g"]] + [got["sigma2_e"]["value"]]


@pytest.mark.parametrize("argv,same", [
    (["--dtype", "float64"], False),
    (["--dtype", "bfloat16"], False),
    (["--cache_blocks", "0"], True),
    (["--cache_blocks", "2"], True),
    (["--streaming", "--host_cache_gb", "2"], True),
])
def test_cli_mode_and_cache_flags(small_dataset, tmp_path, argv, same):
    """The dtype and cache flags through the CLI: the caches report the
    default run's sigma^2 exactly, the dtypes within their
    envelopes of it (3e-2 bf16, 2e-3 float64 against f32)."""
    cli_entry(cli_args(small_dataset, tmp_path / "base.txt"))
    cli_entry(cli_args(small_dataset, tmp_path / "o.txt", *argv))
    base, got = sigmas(tmp_path / "base.txt"), sigmas(tmp_path / "o.txt")
    if same:
        assert got == base
    else:
        np.testing.assert_allclose(got, base, rtol=3e-2,
                                   atol=3e-2 * max(map(abs, base)))
