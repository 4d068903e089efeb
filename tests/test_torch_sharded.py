"""PyTorch port, jackknife sharding over torch.distributed ranks
(pyrhe_tpu_torch/parallel/sharded.py) on the CPU with gloo.

World size 1 in this process: Engine.run_sharded() bitwise equal to the
sequential engine for RHE, RHE-DOM and GENIE, cached, streaming and
hybrid. Two ranks: this file run as a script is the worker
(`python tests/test_torch_sharded.py RANK WORLD PORT DATA_DIR OUT_DIR
JOB`, jax-free), started twice per job with a free MASTER_PORT; every wait
has a limit (communicate(timeout=120), a 60 s process-group timeout). Two
float64 ranks match the sequential port and the JAX float64 Engine at rtol
1e-10, the ranks bitwise identical; per-rank checkpoints resume bitwise;
the CLI runs under torchrun.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyrhe_tpu_torch import GENIE, RHE, RHE_DOM
from pyrhe_tpu_torch.core.checkpoint import Checkpoint
from pyrhe_tpu_torch.parallel import distributed
from pyrhe_tpu_torch.parallel.sharded import ShardedRunner
from pyrhe_tpu_torch.utils.logger import Logger

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
B, SEED = 8, 7
GENIE_MODEL = "G+GxE+NxE"
WORLD = 2
TIMEOUT_S = 120

# the two-rank runs: name -> model settings
GRID = {
    "f64_cached": dict(dtype="float64"),
    "f64_streaming": dict(dtype="float64", streaming=True),
    "f64_cached_J3": dict(dtype="float64", J=3),
    "f64_streaming_J7": dict(dtype="float64", J=7, streaming=True),
    "f64_hybrid": dict(dtype="float64", cache_blocks=2),
    "f32_streaming": dict(dtype="float32", streaming=True),
    "f32_hybrid": dict(dtype="float32", cache_blocks=2),
    "dom_f64": dict(model="rhe_dom", dtype="float64"),
    "genie_f64": dict(model="genie", dtype="float64", streaming=True),
}
# checkpointed runs: name -> (grid entry, crash spec)
CRASHES = {
    "ck_pass1": ("f64_streaming", dict(n_allowed=2)),
    "ck_pass2": ("f32_hybrid", dict(phase_at=3)),
}


def build(ds_dir, model="rhe", dtype="float64", J=10, streaming=False,
          cache_blocks=-1, ckpt=None):
    """A model on the small dataset in ds_dir (RHE: one bin; RHE-DOM and
    GENIE: 8 bins, GENIE with its environment; covariates), on the CPU."""
    prefix = os.path.join(ds_dir, "test")
    cls = {"rhe": RHE, "rhe_dom": RHE_DOM, "genie": GENIE}[model]
    return cls(geno_file=prefix,
               annot_file=os.path.join(
                   ds_dir, "single.annot" if model == "rhe"
                   else "multi.annot"),
               pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
               env_file=prefix + ".env", genie_model=GENIE_MODEL,
               num_jack=J, num_random_vec=B, seed=SEED, device="cpu",
               dtype=dtype, streaming=streaming, cache_blocks=cache_blocks,
               checkpoint_dir=ckpt, log=Logger(suppress=True,
                                               debug_mode=False))


def spy_loads(eng):
    loaded = []
    orig = eng._load_block

    def spy(j):
        loaded.append(j)
        return orig(j)

    eng._load_block = spy
    return loaded


def sequential(ds_dir, **kw):
    eng = build(ds_dir, **kw).engine
    eng.run_precompute_and_assemble()
    return eng


# ------------------------------------------------------------- world size 1
def test_world1_without_process_group(small_dataset):
    """No process group: one rank, no collective; float64 bitwise the
    sequential engine, with the trace sums."""
    ds = small_dataset["dir"]
    assert not torch.distributed.is_initialized()
    model = build(ds, dtype="float64", J=8)
    model.engine.cfg.get_trace = True
    model.engine.run_sharded()
    base = sequential(ds, dtype="float64", J=8)
    np.testing.assert_array_equal(model.engine.T_all, base.T_all)
    np.testing.assert_array_equal(model.engine.trace_sums,
                                  base._compute_trace_sums())


def test_want_sharded_and_environment(small_dataset, monkeypatch):
    """PYRHE_TPU_DISTRIBUTED=1 in one process logs the note and runs the
    sequential engine; no process group in the environment raises."""
    model = build(small_dataset["dir"], J=4)
    monkeypatch.setenv("PYRHE_TPU_DISTRIBUTED", "1")
    assert not model._want_sharded()
    assert any("only one process" in m for m in model.log.msgs)
    for k in ("WORLD_SIZE", "MASTER_PORT", "NUM_PROCESSES",
              "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.env_world_size() == 1
    monkeypatch.setenv("NUM_PROCESSES", "3")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert distributed.env_world_size() == 3
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("auto") == "nccl"
    monkeypatch.delenv("NUM_PROCESSES")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.initialize("cpu")


@pytest.fixture(scope="module")
def gloo_world1():
    """A gloo process group of one rank in this process."""
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    try:
        distributed.initialize("cpu", timeout_s=60)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert distributed.world() == (0, 1)
    yield
    distributed.destroy()


@pytest.mark.parametrize("mode", [dict(), dict(streaming=True),
                                  dict(cache_blocks=3)],
                         ids=["cached", "streaming", "hybrid"])
@pytest.mark.parametrize("model", ["rhe", "rhe_dom", "genie"])
def test_world1_sharded_equals_sequential(small_dataset, gloo_world1, model,
                                          mode):
    """World size 1 through a real gloo group: bitwise the sequential
    engine (float32; the kernels' plain versions on the CPU)."""
    ds = small_dataset["dir"]
    base = sequential(ds, model=model, dtype="float32", J=8, **mode)
    eng = build(ds, model=model, dtype="float32", J=8, **mode).engine
    eng.run_sharded()
    np.testing.assert_array_equal(eng.T_all, base.T_all)
    np.testing.assert_array_equal(eng.q_all, base.q_all)


def test_cuda_engine_needs_nccl(gloo_world1):
    """A CUDA engine in a gloo group raises instead of running."""
    from types import SimpleNamespace
    with pytest.raises(RuntimeError, match="nccl"):
        ShardedRunner(SimpleNamespace(dev=torch.device("cuda"), J=8))


# ---------------------------------------------------------------- two ranks
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(ds_dir, out_dir, job):
    """Both ranks of one job; returns {name: [rank 0 npz, rank 1 npz]}."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port), ds_dir, out_dir, job], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{job} worker failed:\n{log[-3000:]}"
    names = GRID if job == "grid" else CRASHES
    return {name: [dict(np.load(os.path.join(out_dir, f"{job}_{name}_r{r}"
                                             ".npz")))
                   for r in range(WORLD)] for name in names}


@pytest.fixture(scope="module")
def two_ranks(small_dataset, tmp_path_factory):
    """The five two-rank runs: the grid; the checkpointed runs crashed,
    resumed, and resumed again from done; the CLI under torchrun."""
    ds = small_dataset["dir"]
    out = str(tmp_path_factory.mktemp("ranks"))
    res = {"grid": run_ranks(ds, out, "grid")}
    for job in ("crash", "resume", "done"):
        res[job] = run_ranks(ds, out, job)
    res["out"] = out
    return res


def test_ranks_are_jax_free_and_identical(two_ranks):
    for job in ("grid", "crash", "resume", "done"):
        for name, (r0, r1) in two_ranks[job].items():
            assert not r0["foreign"].size and not r1["foreign"].size, (
                job, name, r0["foreign"], r1["foreign"])
            if job != "crash":
                np.testing.assert_array_equal(r0["T_all"], r1["T_all"])
                np.testing.assert_array_equal(r0["q_all"], r1["q_all"])


@pytest.mark.parametrize("name", [n for n in GRID if "f64" in n])
def test_two_ranks_f64_match_sequential_and_jax(small_dataset, two_ranks,
                                                name):
    """float64 over two gloo ranks: the sequential port and the JAX float64
    Engine at rtol 1e-10 (the rank-order merge sums the totals in another
    order than the sequential pass)."""
    from jax_reference import run_jax

    kw = dict(GRID[name])
    model = kw.get("model", "rhe")
    ds = small_dataset
    seq = sequential(ds["dir"], **kw)
    ref = run_jax(
        ds["prefix"], model, kw.get("J", 10),
        dict(annot_file=ds["annot1_path" if model == "rhe"
                           else "annot8_path"],
             pheno_file=ds["pheno_path"], cov_file=ds["cov_path"],
             env_file=ds["env_path"] if model == "genie" else None,
             num_random_vec=B, seed=SEED), GENIE_MODEL)
    got = two_ranks["grid"][name][0]
    for key, want in (("T_all", seq.T_all), ("q_all", seq.q_all),
                      ("T_all", np.asarray(ref.T_all)),
                      ("q_all", np.asarray(ref.q_all))):
        np.testing.assert_allclose(got[key], want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())


def test_two_ranks_split2_streaming_within_envelope(small_dataset,
                                                    two_ranks):
    """split2 streaming (the acc kernels' plain versions) over two ranks
    within 1e-4 of the sequential run."""
    seq = sequential(small_dataset["dir"], **GRID["f32_streaming"])
    got = two_ranks["grid"]["f32_streaming"][0]
    for key, want in (("T_all", seq.T_all), ("q_all", seq.q_all)):
        np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("a,b", [("f64_streaming", "f64_cached"),
                                 ("f64_hybrid", "f64_cached"),
                                 ("f32_hybrid", "f32_streaming")])
def test_two_ranks_cache_modes_bitwise(two_ranks, a, b):
    """Sharded streaming == hybrid == cached, bitwise."""
    grid = two_ranks["grid"]
    np.testing.assert_array_equal(grid[a][0]["T_all"], grid[b][0]["T_all"])
    np.testing.assert_array_equal(grid[a][0]["q_all"], grid[b][0]["q_all"])


@pytest.mark.parametrize("name", list(CRASHES))
def test_two_ranks_kill_and_resume(two_ranks, name):
    """Both ranks crash (mid pass 1 / mid pass 2), resume from their own
    shard_<r>_of_2 checkpoints, bitwise equal to the uncrashed two-rank
    run; then a rerun resumes completed on both ranks, reading nothing."""
    base = two_ranks["grid"][CRASHES[name][0]][0]
    J_loc = 5
    for r in range(WORLD):
        assert two_ranks["crash"][name][r]["crashed"]
        res = two_ranks["resume"][name][r]
        loaded = list(res["loaded"])
        lo = r * J_loc
        # three blocks (pass 1) or samples (pass 2) were saved before the
        # crashing commit
        if name == "ck_pass1":
            assert loaded[:2] == [lo + 3, lo + 4], loaded
        else:
            assert loaded == [lo + 3, lo + 4], loaded
        assert any("Resuming" in str(m) for m in res["msgs"])
        done = two_ranks["done"][name][r]
        assert list(done["loaded"]) == []
        assert any("Resumed completed" in str(m) for m in done["msgs"])
        for got in (res, done):
            np.testing.assert_array_equal(got["T_all"], base["T_all"])
            np.testing.assert_array_equal(got["q_all"], base["q_all"])


def test_changed_world_size_starts_fresh(small_dataset, two_ranks):
    """The two-rank checkpoint does not resume a world-1 run: it starts
    fresh (the merge order depends on the world size), with a note, and
    gives the sequential result bitwise."""
    if distributed.world() != (0, 1):
        pytest.fail(f"unexpected world {distributed.world()}")
    ds = small_dataset["dir"]
    ck = os.path.join(two_ranks["out"], "ck_pass1")
    assert os.path.isdir(os.path.join(ck, "shard_1_of_2"))
    model = build(ds, ckpt=ck, **GRID["f64_streaming"])
    loaded = spy_loads(model.engine)
    model.engine.run_sharded()
    assert min(loaded) == 0
    assert any("world size [2]" in m for m in model.log.msgs)
    base = sequential(ds, **GRID["f64_streaming"])
    np.testing.assert_array_equal(model.engine.T_all, base.T_all)
    np.testing.assert_array_equal(model.engine.q_all, base.q_all)


def test_cli_under_torchrun(small_dataset, tmp_path):
    """The CLI in two processes under torchrun (gloo): rank 0's report
    holds the sequential CLI's estimates at rtol 1e-10 (float64)."""
    from pyrhe_tpu_torch.cli import cli_entry
    ds = small_dataset
    args = ["-g", ds["prefix"], "-p", ds["pheno_path"], "-annot",
            ds["annot8_path"], "-c", ds["cov_path"], "-k", str(B), "-jn",
            "10", "-s", str(SEED), "--device", "cpu", "--dtype", "float64",
            "--suppress"]
    cli_entry(args + ["-o", str(tmp_path / "seq.txt")])
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "pyrhe_tpu_torch.cli", *args,
         "-o", str(tmp_path / "ranks.txt")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]

    def estimates(path):
        out = {}
        for line in path.read_text().splitlines():
            if line.startswith(("Sigma^2", "h2_", "Total h2")):
                name, rest = line.split(" : ", 1)
                out[name] = float(rest.split()[0])
        return out

    seq, ranks = estimates(tmp_path / "seq.txt"), estimates(
        tmp_path / "ranks.txt")
    assert seq and sorted(seq) == sorted(ranks)
    for name, v in seq.items():
        assert ranks[name] == pytest.approx(v, rel=1e-10, abs=1e-12), name


# ------------------------------------------------------------------- worker
def _worker(rank, world, port, ds_dir, out_dir, job):
    """One rank of a two-rank job; writes <out_dir>/<job>_<name>_r<rank>.npz
    per run (T_all, q_all, the blocks read, the report lines, whether it
    crashed, and any jax / pyrhe_tpu module it imported)."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    distributed.initialize("cpu", timeout_s=60)
    real_commit = Checkpoint.commit
    runs = GRID if job == "grid" else CRASHES
    for name, spec in runs.items():
        if job == "grid":
            kw, ckpt, crash = spec, None, None
        else:
            kw, ckpt = GRID[spec[0]], os.path.join(out_dir, name)
            crash = spec[1] if job == "crash" else None
        model = build(ds_dir, ckpt=ckpt, **kw)
        loaded = spy_loads(model.engine)
        seen = [0]
        lo = rank * -(-model.engine.J // world)

        def crasher(self, phase, next_j, crash=crash):
            if crash is not None and (
                    seen[0] >= crash.get("n_allowed", 1 << 30)
                    or (phase, next_j) == ("assemble",
                                           lo + crash.get("phase_at", -9))):
                raise RuntimeError("simulated crash")
            seen[0] += 1
            real_commit(self, phase, next_j)

        Checkpoint.commit = crasher
        crashed = False
        try:
            model.estimate()       # world 2: the sharded path
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
            crashed = True
        finally:
            Checkpoint.commit = real_commit
        eng = model.engine
        empty = np.zeros(0)
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "pyrhe_tpu"))
        np.savez(os.path.join(out_dir, f"{job}_{name}_r{rank}.npz"),
                 T_all=empty if crashed else eng.T_all,
                 q_all=empty if crashed else eng.q_all,
                 loaded=np.array(loaded, np.int64),
                 msgs=np.array(model.log.msgs), crashed=crashed,
                 foreign=np.array(foreign, dtype=str))
    distributed.destroy()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            *sys.argv[4:7])
