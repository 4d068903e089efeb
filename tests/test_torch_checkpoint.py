"""PyTorch port, crash-safe checkpoint/resume (pyrhe_tpu_torch/core/
checkpoint.py and its engine wiring), mirroring tests/test_checkpoint.py
case by case on the CPU.

Every resumed run is compared bit for bit with an uninterrupted run of the
port in the same configuration: snapshots hold exact host copies of the
accumulators and a resume replays the remaining blocks in the same order.
Crashes are simulated by raising from the checkpoint's commit, the last
step of every save. Once per model the resumed float64 port is also held
against the JAX package's float64 Engine at rtol 1e-10 on T and q."""
import os
import shutil

import numpy as np
import pytest
import torch

from pyrhe_tpu_torch.core.checkpoint import Checkpoint
from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig

torch.set_num_threads(2)

GENIE = "G+GxE+NxE"


def data_kw(ds, model, B, seed):
    """RHE: one bin; RHE-DOM and GENIE: 8 bins and covariates, GENIE with
    its environment."""
    multi = model != "rhe"
    return dict(annot_file=ds["annot8_path" if multi else "annot1_path"],
                pheno_file=ds["pheno_path"],
                cov_file=ds["cov_path"] if multi else None,
                env_file=ds["env_path"] if model == "genie" else None,
                num_random_vec=B, seed=seed)


def make_engine(ds, ckpt_dir=None, streaming=False, J=8, B=4,
                dtype="float64", every=1, seed=7, cache_blocks=-1,
                model="rhe", get_trace=False):
    data = load_dataset(ds["prefix"], **data_kw(ds, model, B, seed))
    spec = ModelSpec.build(model, GENIE, data.num_env)
    cfg = RunConfig(num_random_vec=B, num_jack=J, seed=seed, dtype=dtype,
                    streaming=streaming, device="cpu",
                    checkpoint_dir=ckpt_dir, checkpoint_every=every,
                    cache_blocks=cache_blocks, get_trace=get_trace)
    return Engine(data, spec, cfg)


def run(ds, ckpt_dir=None, **kw):
    eng = make_engine(ds, ckpt_dir, **kw)
    eng.run_precompute_and_assemble()
    return eng


def crash_commit_after(eng, n_allowed=None, phase_at=None):
    """Replace the engine checkpoint's commit with one that raises after
    n_allowed successful commits (or when a given (phase, next_j) commit
    is attempted), leaving the last committed state intact."""
    real = eng._ckpt.commit
    seen = {"n": 0}

    def crasher(phase, next_j):
        if phase_at is not None and (phase, next_j) == phase_at:
            raise RuntimeError("simulated crash")
        if n_allowed is not None and seen["n"] >= n_allowed:
            raise RuntimeError("simulated crash")
        seen["n"] += 1
        real(phase, next_j)

    eng._ckpt.commit = crasher


def crash(ds, ck, n_allowed=None, phase_at=None, **kw):
    eng = make_engine(ds, ck, **kw)
    crash_commit_after(eng, n_allowed, phase_at)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run_precompute_and_assemble()
    return eng


def spy_loads(eng):
    """Block indices read by the engine (the prefetch thread reads one
    block ahead)."""
    loaded = []
    orig = eng._load_block

    def spy(j):
        loaded.append(j)
        return orig(j)

    eng._load_block = spy
    return loaded


def assert_same(eng, base):
    np.testing.assert_array_equal(eng.T_all, base.T_all)
    np.testing.assert_array_equal(eng.q_all, base.q_all)


def test_done_resume_reads_nothing(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    base = run(small_dataset, get_trace=True)
    assert_same(run(small_dataset, ck, get_trace=True), base)

    eng2 = make_engine(small_dataset, ck, get_trace=True)

    def boom(j):
        raise AssertionError("resume from phase done must not touch .bed")

    eng2._load_block = boom
    eng2.run_precompute_and_assemble()
    assert_same(eng2, base)
    np.testing.assert_array_equal(eng2.trace_sums, base.trace_sums)
    for got, want in zip(eng2.estimate(0), base.estimate(0)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,cfg", [
    ("float64", dict()),                      # exact, cached blocks
    ("float64", dict(streaming=True)),        # exact, uncached adds
    ("float32", dict(streaming=True)),        # split2: acc kernels
    ("float32", dict(cache_blocks=3)),        # hybrid: cached, then acc
])
def test_crash_mid_precompute(small_dataset, tmp_path, dtype, cfg):
    ck = str(tmp_path / "ck")
    base = run(small_dataset, dtype=dtype, **cfg)
    eng = crash(small_dataset, ck, n_allowed=4, dtype=dtype, **cfg)
    assert eng._ckpt.state() == ("precompute", 4)

    eng2 = make_engine(small_dataset, ck, dtype=dtype, **cfg)
    assert eng2.mode == ("exact" if dtype == "float64" else "f32")
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # the crash hit the j=5 COMMIT after totals.npz (blocks 0..4) was
    # saved: the self-describing totals let resume skip block 4 too. Pass
    # 2 then reads every uncached block (streaming: all; hybrid: 3..7)
    assert loaded[:3] == [5, 6, 7], "blocks 0-4 were checkpointed"
    if not cfg:
        assert loaded == [5, 6, 7]
    assert_same(eng2, base)


@pytest.mark.parametrize("cfg", [dict(streaming=True), dict(),
                                 dict(cache_blocks=3)],
                         ids=["streaming", "cached", "hybrid"])
def test_crash_mid_assemble(small_dataset, tmp_path, cfg):
    ck = str(tmp_path / "ck")
    base = run(small_dataset, dtype="float32", **cfg)
    crash(small_dataset, ck, phase_at=("assemble", 4), dtype="float32",
          **cfg)

    eng2 = make_engine(small_dataset, ck, dtype="float32", **cfg)
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # pass 1 was complete; assemble.npz covering samples 0..3 was saved
    # before the crashing commit: only samples 4.. are built again, from
    # the block files (cached) or from the .bed (streaming, hybrid tail)
    if cfg.get("streaming") or cfg.get("cache_blocks") == 3:
        assert min(loaded) == 4
    else:
        assert loaded == []
    assert_same(eng2, base)


@pytest.mark.parametrize("model", ["rhe_dom", "genie"])
def test_crash_resume_kernel_models(small_dataset, tmp_path, model):
    """RHE-DOM streaming pass 1 through ytg_acc2 and GENIE G+GxE+NxE
    through the env-scaled ytg_acc (plain versions on the CPU), crashed in
    pass 1 and again in pass 2: every resume bitwise equal."""
    kw = dict(dtype="float32", streaming=True, model=model)
    base = run(small_dataset, **kw)
    ck = str(tmp_path / "ck")
    crash(small_dataset, ck, n_allowed=2, **kw)
    crash(small_dataset, ck, phase_at=("assemble", 6), **kw)
    eng = make_engine(small_dataset, ck, **kw)
    loaded = spy_loads(eng)
    eng.run_precompute_and_assemble()
    assert min(loaded) == 6
    assert_same(eng, base)


@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_resumed_f64_matches_jax_engine(small_dataset, tmp_path, model):
    """Hybrid float64 run crashed mid pass 1, resumed: bitwise equal to the
    port's uninterrupted run, and within rtol 1e-10 of the JAX float64
    Engine on the same inputs."""
    from jax_reference import run_jax

    kw = dict(model=model, cache_blocks=3)
    base = run(small_dataset, **kw)
    ck = str(tmp_path / "ck")
    crash(small_dataset, ck, n_allowed=5, **kw)
    eng = run(small_dataset, ck, **kw)
    assert_same(eng, base)

    ref = run_jax(small_dataset["prefix"], model, 8,
                  data_kw(small_dataset, model, 4, 7), GENIE)
    for got, want in ((eng.T_all, ref.T_all), (eng.q_all, ref.q_all)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())


def test_fingerprint_mismatch_starts_fresh(small_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    run(small_dataset, ck)
    base8 = run(small_dataset, seed=8)
    eng2 = make_engine(small_dataset, ck, seed=8)   # another seed
    assert eng2._ckpt.state() is None, "stale checkpoint must be discarded"
    eng2.run_precompute_and_assemble()
    assert_same(eng2, base8)


def test_pheno_change_invalidates_checkpoint(small_dataset, tmp_path):
    """A phenotype swapped in place (same shape) must not reuse stale
    totals: the fingerprint hashes the pheno/cov/env/annot content."""
    ck = str(tmp_path / "ck")
    data = load_dataset(small_dataset["prefix"],
                        **data_kw(small_dataset, "rhe", 4, 7))
    spec = ModelSpec.build("rhe")
    cfg = RunConfig(num_random_vec=4, num_jack=8, seed=7, dtype="float64",
                    device="cpu", checkpoint_dir=ck)
    Engine(data, spec, cfg).run_precompute_and_assemble()
    data.pheno = data.pheno + 1.0    # content change, same shape
    assert Engine(data, spec, cfg)._ckpt.state() is None


def test_bed_content_change_invalidates(small_dataset, tmp_path):
    """A regenerated .bed of the same size at the same path must
    invalidate the checkpoint."""
    prefix = str(tmp_path / "copy")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(small_dataset["prefix"] + ext, prefix + ext)
    ds = dict(small_dataset, prefix=prefix)
    ck = str(tmp_path / "ck")
    run(ds, ck)
    with open(prefix + ".bed", "r+b") as f:   # flip bytes mid-file
        f.seek(os.path.getsize(prefix + ".bed") // 2)
        f.write(bytes([0x55, 0xAA]))
    assert make_engine(ds, ck)._ckpt.state() is None


def test_corrupt_block_file_recomputes_only_that_block(small_dataset,
                                                       tmp_path):
    """A truncated block file neither crashes the resume nor discards the
    totals: it is skipped on load and pass 2 recomputes that block
    alone."""
    ck = tmp_path / "ck"
    base = run(small_dataset)
    crash(small_dataset, str(ck), n_allowed=5)
    victim = ck / "block_000002.npz"
    victim.write_bytes(victim.read_bytes()[:10])

    eng2 = make_engine(small_dataset, str(ck))
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    # pass 1 resumes at 6 (the totals are intact); the corrupt block 2 is
    # the only earlier block read again, by pass 2's cache miss
    assert sorted(set(loaded)) == [2, 6, 7]
    assert_same(eng2, base)


def test_corrupt_totals_starts_fresh(small_dataset, tmp_path):
    ck = tmp_path / "ck"
    base = run(small_dataset)
    crash(small_dataset, str(ck), n_allowed=5)
    victim = ck / "totals.npz"
    victim.write_bytes(victim.read_bytes()[:10])

    eng2 = make_engine(small_dataset, str(ck))
    loaded = spy_loads(eng2)
    eng2.run_precompute_and_assemble()
    assert min(loaded) == 0, "corrupt totals must restart from block 0"
    assert_same(eng2, base)


def test_corrupt_results_recomputes(small_dataset, tmp_path):
    ck = tmp_path / "ck"
    base = run(small_dataset)
    run(small_dataset, str(ck))
    (ck / "results.npz").write_bytes(b"not a zip")
    assert_same(run(small_dataset, str(ck)), base)


def test_lock_excludes_other_processes(small_dataset, tmp_path):
    """Two live runs must not share one --checkpoint_dir: the second runs
    WITHOUT checkpointing and leaves the first's state alone."""
    import subprocess
    import sys
    import time

    ck = tmp_path / "ck"
    ck.mkdir()
    marker = ck / "meta.json"
    marker.write_text("{}")   # reset() fodder if the lock failed
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import fcntl,os,sys,time\n"
         f"fd=os.open({str(ck / '.lock')!r}, os.O_CREAT|os.O_RDWR)\n"
         "fcntl.flock(fd, fcntl.LOCK_EX)\n"
         "print('locked', flush=True)\n"
         "time.sleep(60)\n"], stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "locked"
        eng = make_engine(small_dataset, str(ck))
        assert eng._ckpt is None, "a locked dir must disable checkpointing"
        eng.run_precompute_and_assemble()   # still runs
        assert marker.read_text() == "{}", "the other run's state survives"
    finally:
        holder.kill()
        holder.wait(timeout=30)
    assert holder.poll() is not None


def test_checkpoint_every_gates_stats_io(tmp_path):
    """--checkpoint_every throttles the dominant I/O: staged block saves
    hit the disk only when the covering totals or commit are written."""
    ck = Checkpoint(str(tmp_path), {"a": 1})
    for j in range(3):
        ck.stage_block(j, torch.ones((2, 4)), np.ones((2, 1)))
    assert not list(tmp_path.glob("block_*.npz")), "stats writes not gated"
    ck.save_totals(torch.zeros(3), np.zeros(3), 3)
    assert len(list(tmp_path.glob("block_*.npz"))) == 3
    ck.commit("precompute", 3)
    assert ck.state() == ("precompute", 3)


def test_engine_commits_at_the_cadence(small_dataset, tmp_path):
    """checkpoint_every 3 over J = 8 blocks: pass 1 commits after blocks 3
    and 6, pass 2 after samples 3 and 6, and the run ends committed
    done."""
    eng = make_engine(small_dataset, str(tmp_path / "ck"), every=3,
                      dtype="float32", cache_blocks=4)
    seen = []
    real = eng._ckpt.commit

    def spy(phase, next_j):
        seen.append((phase, next_j))
        real(phase, next_j)

    eng._ckpt.commit = spy
    eng.run_precompute_and_assemble()
    assert seen == [("precompute", 3), ("precompute", 6), ("assemble", 0),
                    ("assemble", 3), ("assemble", 6), ("done", 8)]
    assert sorted(p.name for p in (tmp_path / "ck").glob("block_*")) == [
        f"block_{j:06d}.npz" for j in range(4)]


def test_reset_cleans_own_tmp_files(tmp_path):
    (tmp_path / "totals.npz.tmp").write_bytes(b"torn write")
    (tmp_path / "meta.json.tmp").write_text("torn")
    (tmp_path / "users_file.txt").write_text("keep me")   # not ours
    ck = Checkpoint(str(tmp_path), {"a": 1})
    ck.reset()
    assert not (tmp_path / "totals.npz.tmp").exists()
    assert not (tmp_path / "meta.json.tmp").exists()
    assert (tmp_path / "users_file.txt").exists()


def test_jax_checkpoint_directory_is_not_loaded(small_dataset, tmp_path):
    """A directory the JAX package's engine checkpointed (its own magic,
    its (E, N, b2) layout) reads as a mismatch: the port starts fresh and
    gives its uninterrupted result."""
    from jax_reference import run_jax

    jax_dir = tmp_path / "jax_ck"
    run_jax(small_dataset["prefix"], "rhe", 8,
            data_kw(small_dataset, "rhe", 4, 7), checkpoint_dir=str(jax_dir))
    assert (jax_dir / "results.npz").exists()
    # a copy, so no lock of this process is held on it
    ck = tmp_path / "ck"
    shutil.copytree(jax_dir, ck)
    base = run(small_dataset)
    eng = make_engine(small_dataset, str(ck))
    assert eng._ckpt.state() is None
    assert any("does not match" in m for m in eng.log.msgs)
    loaded = spy_loads(eng)
    eng.run_precompute_and_assemble()
    assert min(loaded) == 0
    assert_same(eng, base)


def test_cli_checkpoint_dir_twice(small_dataset, tmp_path):
    """--checkpoint_dir through the CLI: the second run logs the resume
    and reports the same estimates."""
    from pyrhe_tpu_torch.cli import cli_entry
    ds = small_dataset
    ck = str(tmp_path / "ck")
    reports = []
    for i in range(2):
        out = tmp_path / f"o{i}.txt"
        cli_entry(["-g", ds["prefix"], "-p", ds["pheno_path"], "-annot",
                   ds["annot1_path"], "-k", "4", "-jn", "4", "--device",
                   "cpu", "--suppress", "-o", str(out), "--checkpoint_dir",
                   ck, "--checkpoint_every", "2"])
        reports.append(out.read_text().splitlines())
    assert not any("Resumed completed" in line for line in reports[0])
    assert any("Resumed completed" in line for line in reports[1])

    def estimates(lines):
        return [line for line in lines if line.startswith(
            ("Sigma^2", "h2_", "Total h2", "Enrichment"))]

    assert estimates(reports[0]) and \
        estimates(reports[0]) == estimates(reports[1])
