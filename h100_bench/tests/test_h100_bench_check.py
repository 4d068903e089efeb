"""The comparison that decides `correct`: the plain reference agrees with
the port at a small size, the TF32 control and the faults of the timed
path fail it, and the cache-mode check catches an engine that ran another
mode than its cell names."""
import numpy as np
import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from h100_bench import compare, harness, inputs, layout, reference, work

# every configuration on both cache modes, and the GENIE models a
# configuration may name besides G+GxE+NxE
CONFIG_CELLS = [("rhe_k50.streaming", {}), ("rhe_k50.cached", {}),
                ("genie.cached", {}), ("genie_gxe_nxe.streaming", {}),
                ("genie_gxe_nxe.cached", {"genie_model": "G+GxE"}),
                ("genie_gxe_nxe.streaming", {"genie_model": "G"})]
CONFIG_IDS = [n + "".join("-" + v for v in o.values())
              for n, o in CONFIG_CELLS]


def _readings(cell, cache, seed=3, requests=(1, 2)):
    s = harness.prepare(cell, seed, "cpu", cache)
    ests = [harness.one_estimate(s, r) for r in requests]
    phenos = np.concatenate([e["pheno"] for e in ests], axis=1)
    prog = np.concatenate([e["sigma"] for e in ests], axis=0)
    ref = reference.estimate(s.problem, phenos, "cpu")
    var = reference.pheno_variance(s.problem, phenos)
    return s, ests, phenos, prog, ref, var


@pytest.mark.parametrize("name,over", CONFIG_CELLS, ids=CONFIG_IDS)
def test_reference_agrees_with_the_port(name, over, tiny, cache):
    cell = tiny(name, **over)
    s, ests, _, prog, ref, var = _readings(cell, cache)
    assert all(e["mode_ok"] for e in ests)
    gap = compare.sigma_gap(prog, ref, var)
    assert gap <= cell.config["limits"]["sigma_gap"]
    # the estimates are real ones: every bin's sigma² near its truth
    K = cell.config["num_bin"]
    assert np.all(np.abs(ref[:, -1, :K] - cell.config["h2_per_bin"]) < 0.08)


@pytest.mark.parametrize("name,over", CONFIG_CELLS, ids=CONFIG_IDS)
def test_the_tf32_control_fails(name, over, tiny, cache):
    cell = tiny(name, **over)
    s, _, phenos, prog, ref, var = _readings(cell, cache)
    ctl = reference.estimate(s.problem, phenos, "cpu", precision="tf32")
    limit = cell.config["limits"]["sigma_gap"]
    assert compare.sigma_gap(ctl, ref, var) > limit
    assert compare.sigma_gap(prog, ref, var) < limit


def test_tf32_rounding():
    import torch
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12,
                      1.0 + 3 * 2**-11], dtype=torch.float32)
    got = reference._tf32(x).tolist()
    assert got == [1.0, 1.0, 1.0 + 2**-10, -3.0, 1.0 + 2**-9]


def test_sigma_gap_fails_a_nan():
    a = np.zeros((1, 2, 3))
    b = a.copy()
    b[0, 1, 2] = np.nan
    assert not compare.sigma_gap(b, a, np.ones(1)) <= 1.0


def test_layout_of_each_model(tiny):
    assert {"genie", "rhe"} <= set(layout.model_files())
    cfg = tiny("genie.cached").config
    K, n_env = cfg["num_bin"], cfg["num_env"]
    expect = {"G+GxE+NxE": (1 + n_env, n_env), "G+GxE": (1 + n_env, 0),
              "G": (1, 0)}
    for gm, (comps, nxe) in expect.items():
        lay = layout.layout({**cfg, "genie_model": gm})
        assert (len(lay.components), lay.num_analytic) == (comps, nxe)
        assert lay.E == comps * K + nxe
        assert lay.stochastic.count(False) == K
    rhe = layout.layout(tiny("rhe_k50.cached").config)
    assert len(rhe.components) == 1 and rhe.E == K
    assert rhe.stochastic == (False,) * K


@pytest.mark.parametrize("over", [{"model": "rhe_dom"},
                                  {"model": "no_such_model"},
                                  {"model": "../layout"},
                                  {"genie_model": "G+NxE"},
                                  {"genie_model": "G+GxE", "num_env": 0}])
def test_a_model_the_reference_lacks_is_refused(over, tiny, cache):
    cell = tiny("genie.cached", **over)
    if over.get("model") in layout.model_files():
        # a model is refused only while it has no file under models/
        assert callable(layout.model(cell.config).layout)
        return
    with pytest.raises(ValueError, match="genie_gxe_nxe") as err:
        harness.prepare(cell, 1, "cpu", cache)
    if "model" in over:
        # a model with no file under models/: the message lists the files
        files = ", ".join(layout.model_files())
        assert f"model files: {files})" in str(err.value)
    with pytest.raises(ValueError):
        work.estimate_work(cell.config, cell.traffic,
                           np.eye(cell.config["num_bin"]))


def test_the_work_follows_the_layout(tiny):
    cfg, tr = tiny("genie.cached").config, tiny("genie.cached").traffic
    annot = np.eye(cfg["num_bin"])[np.arange(cfg["num_snp"])
                                   % cfg["num_bin"]]
    flops = {gm: work.estimate_work({**cfg, "genie_model": gm}, tr,
                                    annot)["flops"]
             for gm in layout.model(cfg).GENIE_MODELS}
    assert flops["G"] < flops["G+GxE"] < flops["G+GxE+NxE"]
    rhe = work.estimate_work({**cfg, "model": "rhe"}, tr, annot)
    assert rhe["flops"] == flops["G"]


def test_a_hybrid_traffic_runs_its_fixed_split(tiny, cache):
    cell = tiny("rhe_k50.cached")
    cell.traffic = {"mode": "hybrid", "cache_blocks": 4,
                    "traits_per_request": 1}
    run = harness.measure(cell, 8, 0.2, False, device="cpu", cache=cache)
    assert run.correct and run.attempted >= 1, run.checks


@pytest.mark.parametrize("name", ["genie.cached", "rhe_k50.cached"])
def test_a_fall_to_hybrid_is_caught(name, tiny, cache, monkeypatch):
    from pyrhe_tpu_torch.core.engine import Engine
    monkeypatch.setattr(Engine, "_plan_cache", lambda self: self.J // 2)
    run = harness.measure(tiny(name), 4, 0.2, False, device="cpu",
                         cache=cache)
    assert run.failed == run.attempted > 0
    assert not run.correct
    assert run.checks["failed_estimates"][0] == run.failed


def test_streaming_without_the_host_cache_is_caught(tiny, cache,
                                                    monkeypatch):
    from pyrhe_tpu_torch.core.engine import Engine
    monkeypatch.setattr(Engine, "_init_host_cache", lambda self: None)
    run = harness.measure(tiny("rhe_k50.streaming"), 4, 0.2, False,
                         device="cpu", cache=cache)
    assert run.failed == run.attempted > 0 and not run.correct


def _stale_estimate(monkeypatch):
    """Each engine answers with the first engine's sigma²: a step that
    returns its state unchanged."""
    from pyrhe_tpu_torch.core.engine import Engine
    first = {}
    orig = Engine.estimate

    def stale(self, trait=0, method="QR"):
        return first.setdefault(trait, orig(self, trait, method))
    monkeypatch.setattr(Engine, "estimate", stale)


def _half_the_blocks(monkeypatch):
    """Every odd block is read as the block before it: half of the blocks
    left out, the rest counted twice."""
    from pyrhe_tpu_torch.core.engine import Engine
    orig = Engine._blocks

    def half(self, indices):
        return orig(self, [j - (j % 2) for j in indices])
    monkeypatch.setattr(Engine, "_blocks", half)


def _altered_answer(monkeypatch):
    """One variance component of the full sample moved by a tenth of a
    percent of the phenotype variance where the solve produces it."""
    from pyrhe_tpu_torch.core import solver
    orig = solver.solve_all

    def altered(T, q, method="QR"):
        out = orig(T, q, method)
        out[-1, 0] += 1e-3 * q[-1, -1] / 2000
        return out
    monkeypatch.setattr(solver, "solve_all", altered)


@pytest.mark.parametrize("fault", [_stale_estimate, _half_the_blocks,
                                   _altered_answer])
@pytest.mark.parametrize("name", ["rhe_k50.streaming", "genie.cached"])
def test_a_broken_timed_path_reads_incorrect(fault, name, tiny, cache,
                                             monkeypatch):
    fault(monkeypatch)
    run = harness.measure(tiny(name), 6, 0.3, False, device="cpu",
                         cache=cache)
    assert run.attempted >= 1
    assert not run.correct
    assert run.checks["sigma_gap"][0] > run.checks["sigma_gap"][1]


def test_inputs_depend_on_the_seed_only(tiny):
    cfg = tiny("genie.cached").config
    a, b = inputs.covariates(cfg, 2**31 + 5), inputs.covariates(cfg, 2**31 + 5)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, inputs.covariates(cfg, 2**31 + 6))
    assert inputs.seed_words(2**40 + 3) == [3, 256]
