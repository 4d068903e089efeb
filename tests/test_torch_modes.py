"""PyTorch port, working dtypes, mm_modes and the two caches on the CPU:
float64 (mm_mode exact) against the numpy Oracle at the oracle tests' own
tolerances (tests/test_engine_vs_oracle.py) and against the JAX package's
float64 Engine; mm_mode bf16 against the JAX mm_mode bf16 run and inside the
bf16 envelope of float64; streaming == cached bitwise in both modes; the
hybrid stats cache (cache_blocks, and the auto split under a small device
budget) and the host block cache bitwise equal to the plain runs."""
import numpy as np
import pytest
import torch

from conftest import load_geno_nan
from oracle_numpy import Oracle

from pyrhe_tpu.core.data import load_dataset as jax_load_dataset
from pyrhe_tpu.core.engine import Engine as JaxEngine
from pyrhe_tpu.core.engine import ModelSpec as JaxModelSpec
from pyrhe_tpu.core.engine import RunConfig as JaxRunConfig

from pyrhe_tpu_torch.core import solver as S
from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import (Engine, ModelSpec, RunConfig,
                                         resolve_mm_mode)
from pyrhe_tpu_torch.ops import moments as tm

torch.set_num_threads(2)

N, M = 600, 800


def data_kw(ds, annot_key, cov, env, B, seed):
    return dict(annot_file=ds[annot_key], pheno_file=ds["pheno_path"],
                cov_file=ds["cov_path"] if cov else None,
                env_file=ds["env_path"] if env else None,
                num_random_vec=B, seed=seed)


def run_port(ds, model="rhe", genie_model="G", annot_key="annot1_path",
             cov=False, env=False, J=8, B=8, seed=7, impute="binary",
             run=True, **cfg):
    """The port's engine on the CPU (float64 unless cfg says otherwise),
    with the argument defaults of test_engine_vs_oracle.run_engine."""
    data = load_dataset(ds["prefix"],
                        **data_kw(ds, annot_key, cov, env, B, seed))
    cfg = dict(dict(dtype="float64"), **cfg)
    eng = Engine(data, ModelSpec.build(model, genie_model, data.num_env),
                 RunConfig(num_random_vec=B, num_jack=J, seed=seed,
                           geno_impute_method=impute, device="cpu", **cfg))
    if run:
        eng.run_precompute_and_assemble()
    return data, eng


def run_jax(ds, model="rhe", genie_model="G", annot_key="annot1_path",
            cov=False, env=False, J=8, B=8, seed=7, impute="binary", **cfg):
    data = jax_load_dataset(ds["prefix"],
                            **data_kw(ds, annot_key, cov, env, B, seed))
    ref = JaxEngine(data, JaxModelSpec.build(model, genie_model,
                                             data.num_env),
                    JaxRunConfig(num_random_vec=B, num_jack=J, seed=seed,
                                 geno_impute_method=impute,
                                 **dict(dict(dtype="float64"), **cfg)))
    ref.run_precompute_and_assemble()
    return ref


def make_oracle(ds, data, model="rhe", genie_model="G", J=8, B=8, seed=7,
                impute="binary", annot=None):
    return Oracle(load_geno_nan(ds["prefix"], N, M),
                  annot if annot is not None else ds["annot1"],
                  data.pheno, cov=data.cov, env=data.env, model=model,
                  genie_model=genie_model, num_random_vec=B, num_jack=J,
                  seed=seed, geno_impute_method=impute)


# ------------------------------------------------ float64 vs the oracle
@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("impute", ["binary", "mean"])
def test_port_f64_rhe_single_bin_vs_oracle(small_dataset, cov, impute):
    data, eng = run_port(small_dataset, cov=cov, impute=impute)
    assert eng.mm_mode == eng.mode == "exact"
    assert eng.dtype == torch.float64
    orc = make_oracle(small_dataset, data, impute=impute)
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-7, atol=1e-9)


def test_port_f64_rhe_8bin_cov_vs_oracle(small_dataset):
    data, eng = run_port(small_dataset, annot_key="annot8_path", cov=True)
    orc = make_oracle(small_dataset, data, annot=small_dataset["annot8"])
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)
    h2_e = S.h2_nonoverlapping(np.vstack([sj_e, st_e[None]]))
    h2_o = orc.h2_nonoverlap(sj_o, st_o)
    np.testing.assert_allclose(h2_e, h2_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(S.enrichment(h2_e, eng.M_mat),
                               orc.enrichment(h2_o), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(S.jackknife_se(sj_e, eng.J),
                               orc.jackknife_se(sj_o, orc.J), rtol=1e-6,
                               atol=1e-10)


def test_port_f64_rhe_dom_vs_oracle(small_dataset):
    data, eng = run_port(small_dataset, model="rhe_dom", cov=True)
    orc = make_oracle(small_dataset, data, model="rhe_dom")
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("genie_model", ["G", "G+GxE", "G+GxE+NxE"])
def test_port_f64_genie_vs_oracle(small_dataset, genie_model):
    data, eng = run_port(small_dataset, model="genie",
                         genie_model=genie_model, cov=True, env=True)
    orc = make_oracle(small_dataset, data, model="genie",
                      genie_model=genie_model)
    sj_o, st_o = orc.estimate()
    sj_e, st_e = eng.estimate(0)
    np.testing.assert_allclose(eng.M_mat, orc.Mmat)
    np.testing.assert_allclose(st_e, st_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(sj_e, sj_o, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(eng.T_all[:, :, eng.E][-1],
                               orc.T_border[-1], rtol=1e-7)


# ------------------------------------------- float64 vs the JAX Engine
def assert_T_q_close(eng, ref, rtol=1e-10):
    """T_all / q_all at rtol, with an atol of 1e-12 of the largest entry
    for the near-zero ones."""
    for got, want in ((eng.T_all, ref.T_all), (eng.q_all, ref.q_all)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("which,model,annot_key,cov,impute", [
    ("small", "rhe", "annot1_path", True, "binary"),
    ("small", "rhe", "annot8_path", False, "mean"),
    ("filtered", "rhe", "annot8_path", True, "binary"),
    ("small", "rhe_dom", "annot8_path", True, "binary"),
    ("filtered", "rhe_dom", "annot1_path", False, "binary"),
])
def test_port_f64_matches_jax_f64_engine(small_dataset, filtered_dataset,
                                         which, model, annot_key, cov,
                                         impute):
    ds = small_dataset if which == "small" else filtered_dataset
    kw = dict(model=model, annot_key=annot_key, cov=cov, impute=impute)
    _, eng = run_port(ds, **kw)
    ref = run_jax(ds, **kw)
    np.testing.assert_array_equal(eng.M_mat, ref.M_mat)
    assert_T_q_close(eng, ref)


@pytest.mark.parametrize("genie_model,which", [
    ("G+GxE", "small"), ("G+GxE+NxE", "filtered")])
def test_port_f64_genie_matches_jax_f64_engine(small_dataset,
                                               filtered_dataset, genie_model,
                                               which):
    ds = small_dataset if which == "small" else filtered_dataset
    kw = dict(model="genie", genie_model=genie_model,
              annot_key="annot8_path", cov=True, env=True)
    _, eng = run_port(ds, **kw)
    assert_T_q_close(eng, run_jax(ds, **kw))


@pytest.mark.parametrize("model,genie_model", [
    ("rhe", "G"), ("rhe_dom", "G"), ("genie", "G+GxE+NxE")])
@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_port_streaming_equals_cached_per_dtype(small_dataset, model,
                                                genie_model, dtype):
    """Streaming == cached bitwise in float64 (exact: the standard block
    stats added to the totals in both passes) and in bf16 (unsplit bf16
    operands through ytg_acc / ytg_acc2 in streaming pass 1)."""
    kw = dict(model=model, genie_model=genie_model,
              annot_key="annot8_path", cov=True, env=model == "genie",
              J=4, B=4, dtype=dtype)
    _, cached = run_port(small_dataset, **kw)
    _, streaming = run_port(small_dataset, streaming=True, **kw)
    assert cached.mode == ("exact" if dtype == "float64" else "bf16")
    np.testing.assert_array_equal(streaming.T_all, cached.T_all)
    np.testing.assert_array_equal(streaming.q_all, cached.q_all)


# ---------------------------------------------------------- bf16 mode
def test_dtype_settings_resolve_like_the_reference():
    for dtype, mode in (("float32", "split2"), ("float64", "exact"),
                        ("bfloat16", "bf16")):
        assert resolve_mm_mode(RunConfig(dtype=dtype)) == mode
    assert resolve_mm_mode(RunConfig(dtype="float32",
                                     mm_mode="exact")) == "exact"
    for bad in (dict(dtype="float16"), dict(mm_mode="split3"),
                dict(dtype="float64", mm_mode="bf16")):
        with pytest.raises(ValueError):
            resolve_mm_mode(RunConfig(**bad))


def envelope(st, sj, st64, sj64, rtol_sig, rtol_h2):
    """test_engine_vs_oracle.test_mm_mode_end_to_end_envelope's check."""
    np.testing.assert_allclose(st, st64, rtol=rtol_sig,
                               atol=rtol_sig * np.abs(st64).max())
    h2_64 = S.h2_nonoverlapping(np.vstack([sj64, st64[None]]))
    h2 = S.h2_nonoverlapping(np.vstack([sj, st[None]]))
    np.testing.assert_allclose(h2[-1], h2_64[-1], rtol=rtol_h2,
                               atol=rtol_h2 * np.abs(h2_64[-1]).max())


@pytest.mark.parametrize("model,annot_key", [
    ("rhe", "annot1_path"), ("rhe", "annot8_path"),
    ("rhe_dom", "annot1_path")])
def test_port_bf16_matches_jax_bf16_and_f64_envelope(small_dataset, model,
                                                     annot_key):
    """mm_mode bf16 (dtype bfloat16: f32 state, the probe side rounded to
    bf16 once) against the JAX bf16 run on the same inputs, and both
    inside the bf16 envelope of the port's float64 run (3e-2 on sigma^2,
    2e-2 on h2). The two bf16 runs round the same operands to bf16 from
    f32 values that differ only in summation order; their sigma^2 gap was
    at most 6.8e-7 of max |sigma^2| on these cases (printed under pytest
    -s), so the test holds them to 1e-5."""
    kw = dict(model=model, annot_key=annot_key, cov=True)
    _, e64 = run_port(small_dataset, **kw)
    _, ebf = run_port(small_dataset, dtype="bfloat16", **kw)
    assert ebf.mode == "bf16" and ebf.dtype == torch.float32
    ref = run_jax(small_dataset, dtype="float32", mm_mode="bf16", **kw)
    sj64, st64 = e64.estimate(0)
    sj, st = ebf.estimate(0)
    sjr, str_ = ref.estimate(0)
    gap = np.abs(st - str_).max() / np.abs(str_).max()
    print(f"bf16 port vs JAX {model} {annot_key}: max |sigma2| gap {gap:.3e}"
          f" of max |sigma2|; port vs float64 "
          f"{np.abs(st - st64).max() / np.abs(st64).max():.3e}")
    np.testing.assert_allclose(st, str_, rtol=1e-5,
                               atol=1e-5 * np.abs(str_).max())
    envelope(st, sj, st64, sj64, 3e-2, 2e-2)
    envelope(str_, sjr, st64, sj64, 3e-2, 2e-2)


def test_port_exact_f32_close_to_f64(small_dataset):
    """mm_mode exact in float32 (torch products in f32, no kernel) within
    test_engine_vs_oracle.test_float32_close_to_float64's 2e-3 of the
    float64 run."""
    _, e64 = run_port(small_dataset, cov=True)
    _, e32 = run_port(small_dataset, cov=True, dtype="float32",
                      mm_mode="exact")
    assert e32.mode == "exact" and e32.T_all.dtype == np.float64
    np.testing.assert_allclose(e32.estimate(0)[1], e64.estimate(0)[1],
                               rtol=2e-3, atol=2e-4)


def test_exact_core_matches_kernel_core_in_f32():
    """The exact core (decode + torch products) and the kernel core's plain
    f32 products compute the same stats: the f32 summation order differs
    only."""
    from test_torch_moments import COMPONENTS, as_torch, make_inputs
    for comps in COMPONENTS:
        a, n_indiv, b2 = make_inputs(9)
        w, annot, P, env, mask = as_torch(a)
        kw = dict(n_indiv=n_indiv, components=comps, b2=b2)
        X0, y0, M0 = tm.block_stats_pallas_core(w, annot, P, env, mask,
                                                mode="f32", **kw)
        X1, y1, M1 = tm.block_stats_core(w, annot, P, env, mask, **kw)
        for got, ref in ((X1, X0), (y1, y0)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5 * ref.abs().max().item())
        assert torch.equal(M0, M1)
        X64, _, _ = tm.block_stats_core(w, annot, P.double(), env.double(),
                                        mask.double(), **kw)
        assert X64.dtype == torch.float64
        np.testing.assert_allclose(X64.numpy(), X0.numpy(), rtol=1e-4,
                                   atol=1e-4 * X0.abs().max().item())


# --------------------------------------------------------- hybrid cache
@pytest.mark.parametrize("model", ["rhe", "rhe_dom"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hybrid_cache_equals_cached_and_streaming(small_dataset, model,
                                                  dtype):
    """cache_blocks 2 and 0 (pass 2 recomputes the uncached blocks, pass
    1 adds them through the acc kernels in a kernel mode) bitwise equal to
    the full cache and to streaming (reference test_pallas_engine.py
    hybrid tests)."""
    kw = dict(model=model, annot_key="annot8_path", cov=True, J=4, B=4,
              dtype=dtype)
    full = run_port(small_dataset, **kw)[1]
    assert full.cache_limit == 4
    for other in (dict(cache_blocks=2), dict(cache_blocks=0),
                  dict(streaming=True)):
        eng = run_port(small_dataset, **kw, **other)[1]
        assert eng.cache_limit == other.get("cache_blocks", 0)
        assert not eng._cache
        np.testing.assert_array_equal(eng.T_all, full.T_all)
        np.testing.assert_array_equal(eng.q_all, full.q_all)


def test_hybrid_walk_recomputes_each_gap_once(small_dataset):
    """Pass 2 pops the cached blocks and reads each uncached block once,
    in block order, one _blocks walk per run of gaps."""
    _, eng = run_port(small_dataset, J=5, B=4, cache_blocks=2, run=False)
    eng.precompute()
    assert sorted(eng._cache) == [0, 1]
    eng._cache[3] = eng._cache.pop(1)       # a cached block between gaps
    walks = []
    orig = eng._blocks

    def spy(indices):
        walks.append(list(indices))
        return orig(walks[-1])

    eng._blocks = spy
    assert len(list(eng._loo_blocks())) == 5
    assert walks == [[1, 2], [4]] and not eng._cache


def test_auto_hybrid_under_a_small_budget(small_dataset, monkeypatch):
    """Without cache_blocks, a budget below the full cache caches
    budget // per_block - 4 leading blocks (hybrid), and switches to
    streaming only when not one fits; both bitwise equal to the full
    cache."""
    kw = dict(annot_key="annot8_path", cov=True, J=8, B=4, dtype="float32")
    full = run_port(small_dataset, **kw)[1]
    per_block = full.E_geno * full.b2 * full.n_pad * 4
    monkeypatch.setattr(Engine, "_cache_budget",
                        lambda self: 7.5 * per_block)
    hybrid = run_port(small_dataset, **kw)[1]
    assert hybrid.cache_limit == 3 and not hybrid.cfg.streaming
    assert any("caching 3/8 blocks" in m for m in hybrid.log.msgs)
    monkeypatch.setattr(Engine, "_cache_budget",
                        lambda self: 4.5 * per_block)
    streaming = run_port(small_dataset, **kw)[1]
    assert streaming.cfg.streaming and streaming.cache_limit == 0
    for eng in (hybrid, streaming):
        np.testing.assert_array_equal(eng.T_all, full.T_all)
        np.testing.assert_array_equal(eng.q_all, full.q_all)


# ----------------------------------------------------------- host cache
@pytest.mark.parametrize("model,dtype", [
    ("rhe", "float64"), ("rhe", "float32"), ("rhe_dom", "bfloat16")])
def test_streaming_host_cache_skips_reread(small_dataset, model, dtype):
    """The host block cache: pass 1 reads each block once, streaming pass
    2 reads none (every block a host_cache_hit), bitwise equal to the
    cache-off run (reference test_features.py host-cache test)."""
    kw = dict(model=model, J=6, B=4, dtype=dtype, streaming=True)
    off = run_port(small_dataset, host_cache_gb=0, **kw)[1]
    assert off._host_cache is None
    on = run_port(small_dataset, host_cache_gb=-1, run=False, **kw)[1]
    assert on._host_cache is not None, "tiny dataset must fit the cache"
    calls = []
    orig = on._load_block_uncached

    def spy(j):
        calls.append(j)
        return orig(j)

    on._load_block_uncached = spy
    on.run_precompute_and_assemble()
    assert calls == list(range(on.J))
    assert on.phase_times["host_cache_hits"] == on.J
    np.testing.assert_array_equal(on.T_all, off.T_all)
    np.testing.assert_array_equal(on.q_all, off.q_all)


def test_host_cache_budget(small_dataset):
    """On only when streaming; an explicit budget below the estimate turns
    it off, one above it on."""
    assert run_port(small_dataset, J=4, B=4, run=False)[1]._host_cache \
        is None
    _, eng = run_port(small_dataset, J=4, B=4, streaming=True,
                      host_cache_gb=1e-9, run=False)
    assert eng._host_cache is None
    _, eng = run_port(small_dataset, J=4, B=4, streaming=True,
                      host_cache_gb=1.0, run=False)
    assert eng._host_cache == {}
