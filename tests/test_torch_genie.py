"""PyTorch port, GENIE (G, G+GxE, G+GxE+NxE) and the SUMRHE trace export on
the CPU: the analytic NxE stats and the GENIE engine against the JAX
package's (Pallas in interpret mode, float32), cached == streaming bitwise,
the split2 envelope, the GENIE model's report against the JAX model's, a
known-truth multi-env recovery, and the port's CLI on the example dataset
against the committed GENIE goldens and the trace files the reference
implementation wrote."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyrhe_tpu.core.data import load_dataset as jax_load_dataset
from pyrhe_tpu.core.engine import Engine as JaxEngine
from pyrhe_tpu.core.engine import ModelSpec as JaxModelSpec
from pyrhe_tpu.core.engine import RunConfig as JaxRunConfig
from pyrhe_tpu.ops.moments import nxe_stats as jax_nxe_stats

from pyrhe_tpu_torch.core import solver as S
from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig
from pyrhe_tpu_torch.io import synth
from pyrhe_tpu_torch.ops.moments import nxe_stats

from parse_output import parse_output_file
from test_golden_example import TRACE_GOLD, _read_tr
from test_torch_engine import (ROOT, assert_engines_close,  # noqa: F401
                               example_dir)   # the module-scoped fixture

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def env2_path(small_dataset, tmp_path_factory):
    """A two-column environment file for small_dataset's 600 individuals."""
    p = str(tmp_path_factory.mktemp("env2") / "two.env")
    synth.make_env_file(p, 600, num_env=2, seed=13)
    return p


def dataset_kw(ds, env_path, annot, cov):
    return dict(annot_file=ds["annot1_path" if annot == 1 else
                               "annot8_path"],
                pheno_file=ds["pheno_path"],
                cov_file=ds["cov_path"] if cov else None,
                env_file=env_path, num_random_vec=4, seed=7)


def run_port(ds, env_path, genie_model, annot=1, cov=True, streaming=False,
             split=False, get_trace=False):
    """The port's GENIE engine on the CPU; split=True forces the card's
    split2 operands (bf16 hi/lo halves) through the plain versions."""
    data = load_dataset(ds["prefix"], **dataset_kw(ds, env_path, annot, cov))
    eng = Engine(data, ModelSpec.build("genie", genie_model, data.num_env),
                 RunConfig(num_random_vec=4, num_jack=4, seed=7,
                           device="cpu", streaming=streaming,
                           get_trace=get_trace))
    eng.mode = "split2" if split else "f32"
    eng.run_precompute_and_assemble()
    return eng


def run_jax(ds, env_path, genie_model, annot=1, cov=True, get_trace=False):
    data = jax_load_dataset(ds["prefix"],
                            **dataset_kw(ds, env_path, annot, cov))
    ref = JaxEngine(data, JaxModelSpec.build("genie", genie_model,
                                             data.num_env),
                    JaxRunConfig(num_random_vec=4, num_jack=4, seed=7,
                                 dtype="float32", use_pallas=True,
                                 get_trace=get_trace))
    ref.run_precompute_and_assemble()
    return ref


def env_file(ds, env2_path, num_env):
    """small_dataset's one-column env file, or the two-column one."""
    return ds["env_path"] if num_env == 1 else env2_path


@pytest.mark.parametrize("num_env", [1, 2])
@pytest.mark.parametrize("cov", [False, True])
def test_nxe_stats_matches_jax(num_env, cov):
    rng = np.random.default_rng(num_env + 2 * cov)
    n, B, T = 4096, 5, 2
    env = (rng.random((n, num_env)) < 0.5).astype(np.float32)
    env[rng.random(n) < 0.3] = rng.normal(size=num_env)  # non-binary rows
    Z = rng.normal(size=(n, B)).astype(np.float32)
    Uzb = rng.normal(size=(n, B)).astype(np.float32)
    Y = rng.normal(size=(n, T)).astype(np.float32)
    b2 = 2 * B if cov else B
    XXP, yXXy = nxe_stats(*map(torch.from_numpy, (env, Z, Uzb, Y)), b2, B)
    ref_X, ref_y = jax_nxe_stats(env, Z, Uzb, Y, b2, B)
    assert XXP.shape == (num_env, b2, n) and yXXy.shape == (num_env, T)
    np.testing.assert_allclose(XXP.numpy(),
                               np.asarray(ref_X).transpose(0, 2, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(yXXy.numpy(), np.asarray(ref_y), rtol=1e-6)


@pytest.mark.parametrize("genie_model,num_env,filtered,annot,cov", [
    ("G", 1, False, 8, True),
    ("G+GxE", 1, False, 1, False),
    ("G+GxE+NxE", 1, False, 8, True),
    ("G+GxE+NxE", 1, True, 1, True),
    ("G+GxE+NxE", 2, False, 8, False),
    ("G+GxE+NxE", 2, True, 1, True),
])
def test_genie_engine_matches_jax_pallas_engine(
        small_dataset, filtered_dataset, env2_path, genie_model, num_env,
        filtered, annot, cov):
    ds = filtered_dataset if filtered else small_dataset
    env = env_file(ds, env2_path, num_env)
    eng = run_port(ds, env, genie_model, annot, cov)
    ref = run_jax(ds, env, genie_model, annot, cov)
    n_comp = 1 + (num_env if genie_model != "G" else 0)
    assert eng.E == n_comp * eng.K + (
        num_env if genie_model == "G+GxE+NxE" else 0) == ref.E
    np.testing.assert_array_equal(eng.stoch_mask.numpy(),
                                  np.asarray(ref.stoch_mask))
    assert_engines_close(eng, ref)
    # the border column: stochastic (GxE, NxE) rows and the exact ones
    np.testing.assert_allclose(eng.T_all[:, :, eng.E], ref.T_all[:, :, ref.E],
                               rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize("num_env", [1, 2])
@pytest.mark.parametrize("split", [False, True])
def test_genie_streaming_equals_cached(small_dataset, env2_path, num_env,
                                       split):
    """Streaming pass 1 adds each GxE component through ytg_acc_matmul with
    its env column as the scale operand; cached pass 1 scales the f32
    stats outside the kernel: bitwise equal, unsplit and split2."""
    ds, env = small_dataset, env_file(small_dataset, env2_path, num_env)
    cached = run_port(ds, env, "G+GxE+NxE", annot=8, split=split)
    streaming = run_port(ds, env, "G+GxE+NxE", annot=8, streaming=True,
                         split=split)
    assert streaming.cfg.streaming and not cached.cfg.streaming
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)


@pytest.mark.parametrize("num_env", [1, 2])
def test_genie_split2_within_envelope(small_dataset, env2_path, num_env):
    """G+GxE+NxE with the card's split2 operands against the unsplit f32
    run, inside the split2 envelope of tests/test_engine_vs_oracle.py
    (rtol 3e-4). Prints the gap (pytest -s shows it)."""
    ds, env = small_dataset, env_file(small_dataset, env2_path, num_env)
    _, st_ref = run_port(ds, env, "G+GxE+NxE", annot=8).estimate(0)
    _, st = run_port(ds, env, "G+GxE+NxE", annot=8, split=True).estimate(0)
    gap = np.abs(st - st_ref).max()
    print(f"split2 gap genie num_env={num_env}: max |sigma2| change "
          f"{gap:.3e}, {gap / np.abs(st_ref).max():.3e} of max |sigma2|")
    np.testing.assert_allclose(st, st_ref, rtol=3e-4,
                               atol=3e-4 * np.abs(st_ref).max())


@pytest.mark.parametrize("genie_model,num_env", [
    ("G+GxE+NxE", 1), ("G+GxE", 2),
])
def test_genie_model_matches_jax_model(small_dataset, env2_path,
                                       genie_model, num_env):
    """GENIE(...)(trait=0) against the JAX package's GENIE on the CPU
    (float32): sigma, SEs, h2 with the totals, enrichment."""
    from pyrhe_tpu.models import GENIE as JaxGENIE
    from pyrhe_tpu.utils.logger import Logger as JaxLogger

    from pyrhe_tpu_torch import GENIE, Logger

    ds, env = small_dataset, env_file(small_dataset, env2_path, num_env)
    kw = dict(geno_file=ds["prefix"], annot_file=ds["annot8_path"],
              pheno_file=ds["pheno_path"], cov_file=ds["cov_path"],
              env_file=env, genie_model=genie_model, num_jack=4,
              num_random_vec=4, seed=7, device="cpu", dtype="float32")
    got = GENIE(log=Logger(suppress=True, debug_mode=False), **kw)(trait=0)
    ref = JaxGENIE(log=JaxLogger(suppress=True, debug_mode=False),
                   **kw)(trait=0)
    assert set(got) == set(ref)
    K = 8
    assert len(got["h2_total"]) == K * (1 + num_env) + (
        num_env if genie_model == "G+GxE+NxE" else 0) + 3
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max(), err_msg=key)


def test_genie_multi_env_simulation_recovery(tmp_path):
    """Known-truth recovery (tests/test_engine_vs_oracle.py, float32 here):
    distinct sigma_gxe and sigma_nxe per env, every component within 2
    jackknife SE of the truth and in its env's slot."""
    Nr, Mr = 3000, 2000
    truth_g, truth_gxe, truth_nxe = 0.25, (0.20, 0.05), (0.10, 0.20)
    prefix = str(tmp_path / "rec")
    synth.make_dataset(prefix, Nr, Mr, seed=21, missing_rate=0.0)
    annot = synth.make_annot(str(tmp_path / "rec.annot"), Mr, 1, seed=21)
    env = synth.make_env_file(str(tmp_path / "rec.env"), Nr, num_env=2,
                              seed=21)
    synth.simulate_pheno_file(prefix, prefix, [truth_g], annot, seed=22,
                              env=env, sigma_gxe=truth_gxe,
                              sigma_nxe=truth_nxe)
    data = load_dataset(prefix, annot_file=str(tmp_path / "rec.annot"),
                        pheno_file=prefix + ".pheno",
                        env_file=prefix + ".env", num_random_vec=16, seed=5)
    eng = Engine(data, ModelSpec.build("genie", "G+GxE+NxE", data.num_env),
                 RunConfig(num_random_vec=16, num_jack=8, seed=5,
                           device="cpu"))
    eng.run_precompute_and_assemble()
    sigma_jack, sigma_total = eng.estimate(0)
    se = S.jackknife_se(sigma_jack, 8)
    resid = 1.0 - truth_g - sum(truth_gxe) - sum(truth_nxe)
    truth = np.array([truth_g, *truth_gxe, *truth_nxe, resid])
    assert sigma_total.shape == truth.shape
    np.testing.assert_array_less(np.abs(sigma_total - truth), 2 * se)
    assert sigma_total[1] > sigma_total[2]     # gxe: env0 0.20 > env1 0.05
    assert sigma_total[4] > sigma_total[3]     # nxe: env1 0.20 > env0 0.10


def run_cli(example_dir, model, name, trace=False):
    """The port's CLI on the CPU with example/configs/<model>/<name>.txt
    (trace switched on when asked), its report and trace files written
    under the example dir. Returns (parsed report, trace dir)."""
    tag = f"{model}_{name}" + ("_trace" if trace else "")
    out = example_dir / f"out_{tag}.txt"
    tdir = example_dir / f"trace_{tag}"
    tdir.mkdir(exist_ok=True)
    src = os.path.join(ROOT, "example", "configs", model, f"{name}.txt")
    text = open(src).read().replace(f"output = outputs/{model}/{name}.txt",
                                    f"output = {out}")
    if trace:
        text = text.replace("trace = no", "trace = yes")
    cfg = example_dir / f"cfg_{tag}.txt"
    cfg.write_text(text)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.cli", "--config",
                    str(cfg), "--trace_dir", str(tdir), "--device", "cpu",
                    "--suppress"], check=True, cwd=example_dir, env=env)
    return parse_output_file(str(out)), tdir


ESTIMATE = re.compile(r"^(Sigma\^2_\w+(?:\[\d+\])?|h2_\w+\[\d+\]|Total h2\w*|"
                      r"Enrichment g\[\d+\]) : ([-\d.e]+) +SE ?: ?([\d.e-]+)$",
                      re.M)


def report_estimates(path):
    """{name: (value, SE)} of every estimate line of a GENIE report:
    Sigma^2_g/gxe/nxe/e, h2_g/gxe/nxe, Total h2(_g, _gxe), Enrichment g."""
    with open(path) as f:
        found = ESTIMATE.findall(f.read())
    out = {name: (float(v), float(se)) for name, v, se in found}
    assert len(out) == len(found), "an estimate line repeats"
    return out


def assert_report_matches(got, golden, rtol=3e-4):
    """The same estimates; each within SE overlap (the reference's
    is_within_range) and, when rtol is given, rtol·max(1, |golden|)."""
    assert sorted(got) == sorted(golden)
    for name, (v, se) in got.items():
        gv, gse = golden[name]
        assert abs(v - gv) <= se + gse + 1e-12, (name, v, se, gv, gse)
        if rtol is not None:
            assert abs(v - gv) <= rtol * max(1.0, abs(gv)), (name, v, gv)


@pytest.mark.parametrize("name", ["no_streaming_bin_8", "streaming_bin_8"])
def test_port_cli_genie_reproduces_goldens(example_dir, name):
    """--model genie G+GxE+NxE (cached and --streaming) on the example
    dataset with 8 bins: every sigma^2 (g, gxe, nxe, e), h2, total and
    enrichment within SE overlap and 3e-4·max(1, |golden|) of our golden,
    and within SE overlap of the reference implementation's cached run."""
    got, _ = run_cli(example_dir, "genie", name)
    assert (len(got["sigma2_g"]), len(got["sigma2_gxe"]),
            len(got["sigma2_nxe"])) == (8, 8, 1)
    ours = report_estimates(example_dir / f"out_genie_{name}.txt")
    assert len(ours) == 18 + 17 + 3 + 8
    outputs = os.path.join(ROOT, "example", "outputs")
    assert_report_matches(ours, report_estimates(
        os.path.join(outputs, "genie", f"{name}.txt")))
    assert_report_matches(ours, report_estimates(os.path.join(
        outputs, "reference", "genie", "no_streaming_bin_8.txt")), rtol=None)


@pytest.mark.parametrize("model", ["rhe", "genie"])
def test_port_cli_trace_matches_reference(example_dir, model):
    """--trace on no_streaming_bin_1 against the files the reference
    implementation wrote (tests/test_golden_example.py tolerances): .MN
    byte for byte, .tr header and jackknife SNP counts exact, LD sums
    within rtol 2e-3, atol 0.5."""
    name = "no_streaming_bin_1"
    _, tdir = run_cli(example_dir, model, name, trace=True)
    ref_dir = os.path.join(TRACE_GOLD, model, name)
    assert (tdir / "run_test.pheno.MN").read_text() == open(
        os.path.join(ref_dir, "run_test.pheno.MN")).read()
    ref_h, ref_v, ref_n = _read_tr(os.path.join(ref_dir, "run_test.pheno.tr"))
    got_h, got_v, got_n = _read_tr(str(tdir / "run_test.pheno.tr"))
    assert got_h == ref_h
    assert got_n == ref_n
    assert len(got_v) == len(ref_v)
    np.testing.assert_allclose(np.array(got_v), np.array(ref_v), rtol=2e-3,
                               atol=0.5)
    # GENIE: the full component block beside the SUMRHE file (K = 1:
    # g, gxe, nxe)
    assert (tdir / "run_test.pheno.all.tr").exists() == (model == "genie")


def test_port_trace_streaming_equals_cached(example_dir):
    """GENIE's .MN, .tr and .all.tr from --streaming are byte-identical to
    the cached run's."""
    _, t_ns = run_cli(example_dir, "genie", "no_streaming_bin_1", trace=True)
    _, t_st = run_cli(example_dir, "genie", "streaming_bin_1", trace=True)
    for ext in ("MN", "tr", "all.tr"):
        assert (t_st / f"run_test.pheno.{ext}").read_bytes() == \
            (t_ns / f"run_test.pheno.{ext}").read_bytes(), ext


@pytest.mark.parametrize("num_env", [1, 2])
def test_genie_all_tr_matches_jax_trace_sums(small_dataset, env2_path,
                                             tmp_path, num_env):
    """The GENIE model's .all.tr (every component: g, gxe, nxe) against the
    JAX engine's trace_sums on the same inputs, rtol 2e-3; the SUMRHE .tr
    is its leading K x K block."""
    from pyrhe_tpu_torch import GENIE, Logger

    ds, env = small_dataset, env_file(small_dataset, env2_path, num_env)
    model = GENIE(geno_file=ds["prefix"], annot_file=ds["annot8_path"],
                  pheno_file=ds["pheno_path"], cov_file=ds["cov_path"],
                  env_file=env, genie_model="G+GxE+NxE", num_jack=4,
                  num_random_vec=4, seed=7, device="cpu", get_trace=True,
                  trace_dir=str(tmp_path),
                  log=Logger(suppress=True, debug_mode=False))
    model(trait=0)
    ref = run_jax(ds, env, "G+GxE+NxE", annot=8, get_trace=True)
    E, K = ref.E, 8
    _, vals, nsnps = _read_tr(str(tmp_path / "run_test.pheno.all.tr"))
    got = np.array(vals).reshape(5, E, E)
    np.testing.assert_array_equal(np.array(nsnps).reshape(5, E),
                                  ref.M_mat)
    np.testing.assert_allclose(got, ref.trace_sums, rtol=2e-3,
                               atol=2e-3 * np.abs(ref.trace_sums).max())
    _, tr_vals, _ = _read_tr(str(tmp_path / "run_test.pheno.tr"))
    np.testing.assert_array_equal(np.array(tr_vals).reshape(5, K, K),
                                  got[:, :K, :K])
