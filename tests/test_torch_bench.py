"""PyTorch port, the measurement tools (pyrhe_tpu_torch.bench) on the CPU:
the matvec tool's one-JSON-line contract (as tests/test_bench.py holds
bench.py's) with platform cpu and no device metric; its useful-flop count
against bench.py's, without the dominance over-count; its body (the
engine's streaming pass 1, the kernels' plain versions) against the JAX
package's block_stats_core summed over the same blocks, and acc ==
standard bitwise; e2e against the port's RHE run and, in float64, the JAX
Engine on the same files; host_read staging the engine's bytes at any
thread count; the scaling study's --merge; and every tool refusing to run
without a card unless --device cpu is passed. Inputs come from numpy
seeds."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrhe_tpu.core.data import load_dataset as jax_load_dataset
from pyrhe_tpu.core.engine import Engine as JaxEngine
from pyrhe_tpu.core.engine import ModelSpec as JaxModelSpec
from pyrhe_tpu.core.engine import RunConfig as JaxRunConfig
from pyrhe_tpu.ops import moments as jm

from pyrhe_tpu_torch import RHE
from pyrhe_tpu_torch.bench import (e2e, host_read, kernels, matvec,
                                   scaling_study, staging, timing)
from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig
from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.io.bed import BedFile

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5             # float32, another summation order
N_E2E, M_E2E, J_E2E = 2000, 2000, 10


def run_tool(module, argv, capsys):
    """module.main(argv) in this process; its last stdout line as JSON."""
    module.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def e2e_dir(tmp_path_factory):
    """A directory whose e2e_2000_2000 dataset e2e synthesizes on first
    use (the JAX tool's generators and seeds)."""
    return str(tmp_path_factory.mktemp("e2e"))


def e2e_argv(d, *extra):
    return ["-N", str(N_E2E), "-M", str(M_E2E), "-jn", str(J_E2E),
            "--repeats", "2", "--device", "cpu", "--dir", d, *extra]


def test_matvec_json_contract():
    env = dict(os.environ, BENCH_BLOCKS="2", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.bench.matvec",
                          "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "genotype_matvec_gflops_per_chip"
    assert out["unit"] == "GFLOP/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert out["wide"]["value"] > 0
    assert out["wide"]["config"]["K"] == 8 and out["wide"]["config"]["cov"]
    # a CPU run names its platform and reports no device metric
    assert out["device"]["platform"] == "cpu"
    for cfg in (out, out["wide"]):
        assert cfg["mfu_pct"] is None
        assert cfg["device_busy_pct"] is None
        assert cfg["acc_equals_standard"] is True
        assert cfg["samples"] == 7 and cfg["gflops_q1"] <= cfg["gflops_q3"]
    assert out["peak_tflops"] == 989.0


@pytest.mark.parametrize("num_env", [0, 2])
@pytest.mark.parametrize("dom", [False, True])
def test_useful_flops_drop_the_dom_overcount(num_env, dom):
    N, m, K, B = 131072, 2048, 8, 10
    b2 = 2 * B
    Bp = b2 + 1
    # bench.py:169-177, verbatim
    components = (("add", None),) + tuple(("add", e) for e in range(num_env))
    if dom:
        components += (("dom", None),)
    V = 1 + num_env
    n_dom = sum(1 for kind, _ in components if kind == "dom")
    s2_widths = len(components) * K * b2 + n_dom * K * b2
    jax_flops = 2.0 * N * m * (Bp * V * (2 if n_dom else 1) + s2_widths)
    got = matvec.useful_flops_per_block(N, m, K, b2, Bp, num_env, dom)
    over = 2.0 * N * m * Bp * (V - 1) if (dom and num_env) else 0.0
    assert got == jax_flops - over


def _unpermute(x, perm, N):
    """(..., n_pad) in the kernels' plane order -> (..., N) natural."""
    out = np.empty_like(x)
    out[..., perm] = x
    return out[..., :N]


@pytest.mark.parametrize("cov,num_env,dom", [(False, 0, False),
                                             (True, 1, False),
                                             (True, 0, True)])
def test_matvec_body_matches_jax_block_stats_core(cov, num_env, dom):
    """The port's streaming pass-1 body (acc kernels' plain versions)
    summed over 3 blocks against the JAX package's block_stats_core summed
    over the same blocks."""
    N, m, K, B = 3000, 64, 3, 4
    case = matvec.make_case(N, m, K, B, use_cov=cov, num_env=num_env,
                            dom=dom)
    n_pad = case.P.shape[0]
    perm = matvec.plane_permutation(n_pad)
    blocks = matvec.make_blocks(3, m, n_pad, "cpu")
    totX, toty = matvec.acc_body(case, blocks, "f32")

    P = _unpermute(case.P.numpy().T, perm, N).T
    env = (_unpermute(case.env.numpy().T, perm, N).T
           if num_env else None)
    X0, y0 = 0.0, 0.0
    for w in blocks:
        packed = w.numpy().view(np.uint8)[:, :(N + 3) // 4]
        X, y, _ = jm.block_stats_core(
            jnp.asarray(packed), jnp.zeros(m), jnp.asarray(case.annot.numpy()),
            jnp.asarray(P), None if env is None else jnp.asarray(env),
            n_indiv=N, components=case.components, b2=case.b2, packed=True,
            dtype=jnp.float32, mm_mode="exact")
        X0, y0 = X0 + np.asarray(X), y0 + np.asarray(y)
    got = _unpermute(totX.numpy(), perm, N).transpose(0, 2, 1)
    for a, ref in ((got, X0), (toty.numpy(), y0)):
        np.testing.assert_allclose(a, ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("mode,num_env,dom", [("f32", 1, False),
                                              ("bf16", 0, True)])
def test_matvec_acc_equals_standard_bitwise(mode, num_env, dom):
    case = matvec.make_case(2500, 96, 2, 3, use_cov=True, num_env=num_env,
                            dom=dom)
    blocks = matvec.make_blocks(3, 96, case.P.shape[0], "cpu")
    assert matvec.acc_equals_standard(case, blocks, mode)


def test_matvec_exact_impl():
    """BENCH_IMPL=exact times the standard body through
    ops/moments.block_stats_core (g decoded, torch products), against the
    f32 peak; the acc check still holds the kernel bodies."""
    out = matvec.bench_config(2500, 64, 2, 3, 2, impl="exact", reps=2)
    assert out["config"]["mode"] == "exact" and not out["config"]["acc"]
    assert out["peak_tflops"] == 67.0 and out["value"] > 0
    assert out["acc_equals_standard"] is True


def test_e2e_cpu_equals_the_port_rhe_run(e2e_dir, capsys):
    out = run_tool(e2e, e2e_argv(e2e_dir), capsys)
    assert out["device"]["platform"] == "cpu" and out["peak_gb"] is None
    assert out["sigma_repeats_equal"]
    for name in e2e.PHASES:
        assert out["phases_s"][name]["n"] == 2
        assert len(out["samples_s"][name]) == 2
    prefix = out["prefix"]
    model = RHE(geno_file=prefix, annot_file=prefix + ".annot",
                pheno_file=prefix + ".pheno", num_jack=J_E2E,
                num_random_vec=10, seed=1, device="cpu")
    want = [float(x) for x in model(trait=0)["sigma_ests_total"]]
    assert out["sigma"] == want


def test_e2e_cpu_float64_matches_jax_engine(e2e_dir, capsys):
    out = run_tool(e2e, e2e_argv(e2e_dir, "--dtype", "float64"), capsys)
    prefix = out["prefix"]
    data = jax_load_dataset(prefix, annot_file=prefix + ".annot",
                            pheno_file=prefix + ".pheno", num_random_vec=10,
                            seed=1)
    ref = JaxEngine(data, JaxModelSpec.build("rhe"),
                    JaxRunConfig(num_random_vec=10, num_jack=J_E2E, seed=1,
                                 dtype="float64"))
    ref.run_precompute_and_assemble()
    np.testing.assert_allclose(out["sigma"], ref.estimate(0)[1], rtol=1e-8)


def test_host_read_stages_the_engine_bytes_at_any_thread_count(e2e_dir,
                                                               capsys):
    out = run_tool(e2e, e2e_argv(e2e_dir, "--repeats", "1"), capsys)
    prefix = out["prefix"]
    rows = run_tool(host_read, ["--prefix", prefix, "--threads", "1,2",
                                "--device", "cpu"], capsys)["rows"]
    assert [r["threads"] for r in rows] == [1, 2]
    assert all(r["staging_shape"] == [2016, 512] for r in rows)
    # block 0 as the engine stages it, and as the tool cleans it
    data = load_dataset(prefix, annot_file=prefix + ".annot",
                        pheno_file=prefix + ".pheno", seed=1)
    eng = Engine(data, ModelSpec.build("rhe"),
                 RunConfig(num_jack=J_E2E, seed=1, device="cpu"))
    words, _, _ = eng._load_block_uncached(0)
    s, e = eng._block_range(0)
    staged = []
    for nt in (1, 2):
        buf = host_read.staging_buffer(e - s, N_E2E, pin=False).numpy()
        host_read.stage_seconds(BedFile(prefix + ".bed", N_E2E, M_E2E,
                                        num_threads=nt), s, e, 1, buf, nt)
        staged.append(buf)
    np.testing.assert_array_equal(staged[0], staged[1])
    np.testing.assert_array_equal(staged[0], words.view(torch.uint8).numpy())


def test_scaling_study_merge(tmp_path, capsys):
    row = {"tool": "e2e", "N": 100000, "M": 100000, "model": "rhe",
           "streaming": False, "dtype": "float32", "cache_blocks": -1,
           "cold_read": False,
           "device": {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
                      "power_limit": "700.00 W"},
           "phases_s": {k: {"median": 1.5, "q1": 1.4, "q3": 1.6, "n": 3}
                        for k in e2e.PHASES},
           "engine_phases_s": {"host_read_s": {"median": 1.3, "q1": 1.2,
                                               "q3": 1.4, "n": 3}},
           "peak_gb": {"median": 6.7, "q1": 6.7, "q3": 6.7, "n": 3}}
    md, js = tmp_path / "study" / "s.md", tmp_path / "study" / "s.json"
    argv = ["--out", str(md), "--json_out", str(js)]
    for r in (row, dict(row, streaming=True), dict(row, N=10000), row):
        f = tmp_path / "row.txt"
        f.write_text("log line\n" + json.dumps(r) + "\n")
        scaling_study.main(["--merge", str(f), *argv])
    rows = json.loads(js.read_text())
    assert [(r["N"], r["streaming"]) for r in rows] == [
        (10000, False), (100000, False), (100000, True)]
    text = md.read_text()
    assert "NVIDIA H100 80GB HBM3 (700.00 W)" in text
    assert "| 10,000 | 100,000 |" in text and "| 21.09 | 39.95 |" in text
    assert "merged" in capsys.readouterr().out


@pytest.mark.parametrize("module,argv", [
    (timing, []), (matvec, []), (kernels, []), (staging, []),
    (e2e, ["-N", "100", "-M", "100"]), (host_read, ["--prefix", "x"]),
    (scaling_study, ["--json_out", "none.json"]),
    (kernels, ["--device", "cpu"]), (staging, ["--device", "cpu"])])
def test_tools_need_a_card(module, argv):
    """No tool falls back to the CPU: the default device raises without a
    card, and the two tools with no CPU meaning refuse --device cpu."""
    if torch.cuda.is_available() and "cpu" not in argv:
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        module.main(argv)


def test_summary_and_checks():
    s = timing.summary([4.0, 1.0, 3.0, 2.0, 5.0])
    assert s == {"median": 3.0, "q1": 2.0, "q3": 4.0, "n": 5}
    assert timing.summary([2.5]) == {"median": 2.5, "q1": 2.5, "q3": 2.5,
                                     "n": 1}
    out = {"a": 1.0, "b": [2, {"c": 0.0}], "d": None, "e": True,
           "f": "x", "g": {"h": -1}, "i": float("nan")}
    assert timing.finite_positive(out, skip=("g",)) == [".b[1].c", ".d",
                                                        ".i"]
    ms, by = timing.bound(3.35e9, 1.0, torch.float32)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = timing.bound(1.0, 989e9, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(1.0)
