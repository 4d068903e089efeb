"""Set-up, the measured window and the check of one cell on the port.

Set-up: the cohort (written once per checkout by a child process, then
reused), the seed's covariates and environments (inputs.py), one
`pyrhe_tpu_torch.core.data.load_dataset` of the cohort with the seed as
the model seed, the genetic value of the seed's phenotypes (plain torch on
the device), and one warm estimate of the cell's own shapes, which builds
the kernels (into the port's build directory inside the checkout) and
fills the allocator's and the pinned pools.

The window is a closed loop of back-to-back estimates, each what a user
with many phenotypes on one loaded cohort pays per phenotype: a fresh
phenotype installed with dataclasses.replace(data, pheno=...), an
`Engine` in the cell's cache mode, pass 1 and pass 2 (the two steps of
Engine.run_precompute_and_assemble, which without a checkpoint only calls
them in turn) and Engine.estimate per trait. The loop runs whole
estimates until the window's seconds have passed. Every estimate checks
that it ran the mode its cell names: a cached cell caches all J blocks
(`cache_limit == J`), a hybrid one the traffic's fixed number, a
streaming cell streams and serves all J blocks of pass 2 from the host
block cache.

The profiler records the device's activities over the window in every
CUDA run (and the host's too with --trace 1): the union of the device's
work is the end-to-end `device_s`. Without --trace it records one
estimate a cycle and keeps only each cycle's busy seconds (_profiler).

After the window (its peak memory read, the port's state freed) the plain
reference (reference.py) recomputes every estimate of the window from the
raw inputs, and compare.py judges them.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from . import cohort, compare, devtrace, inputs, layout, reference, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pyrhe_tpu")
SPAN = "h100_bench."


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list          # BENCHMARK.json metric entries of this cell
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, with its workload, configuration
    and traffic files from h100_bench/."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = _read_json(os.path.join(HERE, "workloads", name + ".json"))
    for k in ("config", "traffic", "chips"):
        if wl[k] != entry[k]:
            raise ValueError(f"workloads/{name}.json says {k} {wl[k]!r}, "
                             f"BENCHMARK.json {entry[k]!r}")
    return cell_of(name, wl["config"], wl["traffic"], wl["chips"],
                   [m for m in bench["end_to_end"] if _applies(m, name)],
                   [m for m in bench["per_layer"] if _applies(m, name)])


def cell_of(name: str, config: str, traffic: str, chips: int = 1,
            end_to_end=(), per_layer=()) -> Cell:
    """A cell of the configuration and traffic files named."""
    return Cell(name,
                _read_json(os.path.join(HERE, "configs", config + ".json")),
                _read_json(os.path.join(HERE, "traffic", traffic + ".json")),
                chips, list(end_to_end), list(per_layer))


def cohort_prefix(config: dict, cache: str = CACHE) -> str:
    """The cohort of the configuration's geometry, written by a child
    process when this checkout does not hold it yet."""
    geo = cohort.geometry(config)
    out = os.path.join(cache, "cohort-" + cohort.key(geo))
    prefix = os.path.join(out, "cohort")
    if not os.path.exists(prefix + ".annot"):
        os.makedirs(cache, exist_ok=True)
        subprocess.run([sys.executable, "-m", "h100_bench.cohort", "--out",
                        out, "--geometry", json.dumps(geo)],
                       cwd=ROOT, check=True)
    return prefix


def model_seed(seed: int) -> int:
    """The seed handed to the port (and the reference): numpy's legacy
    RandomState takes 32 bits."""
    return int(seed) % 2**32


@dataclass
class Prepared:
    """What set-up made for one run."""
    cell: Cell
    seed: int
    data: object              # the port's DataBundle of the cohort
    spec: object              # the port's ModelSpec
    run_cfg: object           # the port's RunConfig
    problem: reference.Problem
    g: np.ndarray             # genetic value of the seed's phenotypes
    load_s: float
    log: object


def prepare(cell: Cell, seed: int, device: str, cache: str = CACHE):
    """Everything before the warm estimate; returns a Prepared."""
    from pyrhe_tpu_torch.core.data import load_dataset
    from pyrhe_tpu_torch.core.engine import ModelSpec, RunConfig
    from pyrhe_tpu_torch.utils.logger import Logger

    cfg, tr = cell.config, cell.traffic
    model = layout.model(cfg)            # refuses a model with no file
    lay = model.layout(cfg)
    prefix = cohort_prefix(cfg, cache)
    side = inputs.write_side_files(cfg, seed, os.path.join(cache, "run"))
    ms = model_seed(seed)
    log = Logger(suppress=True, debug_mode=False)
    t0 = time.perf_counter()
    data = load_dataset(prefix, annot_file=prefix + ".annot",
                        cov_file=side["cov_file"], env_file=side["env_file"],
                        num_bin=cfg["num_bin"],
                        num_random_vec=cfg["num_random_vec"], seed=ms,
                        log=log)
    load_s = time.perf_counter() - t0
    spec = ModelSpec.build(cfg["model"], cfg.get("genie_model") or "G",
                           data.num_env)
    J = cfg["num_jack"]
    run_cfg = RunConfig(num_random_vec=cfg["num_random_vec"], num_jack=J,
                        seed=ms, dtype=cfg["dtype"],
                        streaming=tr["mode"] == "streaming", device=device,
                        cache_blocks=cache_blocks(tr, J),
                        host_cache_gb=tr.get("host_cache_gb", -1.0))
    problem = reference.Problem(
        bed_path=prefix + ".bed", num_indiv=cfg["num_indiv"],
        num_snp=cfg["num_snp"], annot=cohort.annotation(cohort.geometry(cfg)),
        cov=side["cov"], env=side["env"], model=model, layout=lay,
        num_random_vec=cfg["num_random_vec"], num_jack=J, seed=ms)
    genetic_value = getattr(model, "genetic_value", inputs.genetic_value)
    g = genetic_value(cfg, seed, problem.bed_path, problem.annot, device)
    return Prepared(cell, seed, data, spec, run_cfg, problem, g, load_s, log)


def cache_blocks(traffic: dict, J: int) -> int:
    """The stats-cache size a traffic mode fixes: all J blocks (cached),
    the traffic's `cache_blocks` (hybrid), none (streaming, -1)."""
    mode = traffic["mode"]
    if mode == "cached":
        return J
    if mode == "hybrid":
        return traffic["cache_blocks"]
    if mode == "streaming":
        return -1
    raise ValueError(f"unknown cache mode {mode!r}")


def mode_ok(eng, traffic: dict, J: int) -> bool:
    """Did the engine run the cache mode the cell names? Cached and
    hybrid: the planned cache holds the fixed number of blocks; streaming:
    every block of pass 2 came from the host block cache."""
    if traffic["mode"] == "streaming":
        return (eng.cfg.streaming
                and eng.phase_times.get("host_cache_hits", 0.0) == J)
    return (eng.cache_limit == cache_blocks(traffic, J)
            and not eng.cfg.streaming)


def _span(name):
    return torch.profiler.record_function(SPAN + name)


def one_estimate(s: Prepared, request: int) -> dict:
    """One estimate of the window; returns its record."""
    from pyrhe_tpu_torch.core.engine import Engine

    tr, J = s.cell.traffic, s.cell.config["num_jack"]
    t0 = time.perf_counter()
    with _span("phenotype"):
        pheno = inputs.phenotype(s.cell.config, tr, s.seed, request, s.g)
        data = dataclasses.replace(s.data, pheno=pheno)
    with _span("engine_init"):
        eng = Engine(data, s.spec, s.run_cfg, s.log)
    with _span("pass1"):
        eng.precompute()
    with _span("pass2"):
        eng.assemble()
    t1 = time.perf_counter()
    with _span("solve"):
        sig = []
        for t in range(pheno.shape[1]):
            jack, total = eng.estimate(t)
            sig.append(np.vstack([jack, total[None]]))
    t2 = time.perf_counter()
    return {"pheno": pheno, "sigma": np.stack(sig),
            "mode_ok": mode_ok(eng, tr, J), "phase_times": eng.phase_times,
            "solve_s": t2 - t1, "wall_s": t2 - t0}


@dataclass
class Run:
    cell: Cell
    seed: int
    setup_s: float = 0.0
    load_s: float = 0.0
    window_s: float = 0.0
    estimates: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    peak_device_bytes: int = 0
    peak_host_bytes: int = 0
    trace: devtrace.Summary | None = None
    device_busy_s: float | None = None    # union of the window's device work
    work: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    forbidden: list = field(default_factory=list)

    @property
    def attempted(self) -> int:
        return len(self.estimates) + len(self.errors)

    @property
    def failed(self) -> int:
        return (len(self.errors)
                + sum(not e["mode_ok"] for e in self.estimates))

    def mean_phase(self, key: str) -> float | None:
        """Engine.phase_times[key] per estimate, averaged over the
        window's estimates."""
        vals = [e["phase_times"][key] for e in self.estimates
                if key in e["phase_times"]]
        return sum(vals) / len(vals) if vals else None

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))


def _sync(device: str):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _profiler(trace: bool, cuda: bool):
    """(profiler of the window or None, list its cycles' device-busy
    seconds go to, or None). --trace 1: host and device over the whole
    window, for devtrace.summarize. Otherwise, on a card: the device
    alone, one cycle an estimate (the window calls step() after each),
    each cycle reduced to its busy seconds and dropped, so that the
    profiler's memory does not grow with the window's estimates and move
    peak_host_gb."""
    acts = torch.profiler.ProfilerActivity
    if trace:
        return torch.profiler.profile(
            activities=[acts.CPU] + ([acts.CUDA] if cuda else [])), None
    if not cuda:
        return None, None
    busy = []
    prof = torch.profiler.profile(
        activities=[acts.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=0, active=1),
        on_trace_ready=lambda p: busy.append(devtrace.device_busy_s(p)))
    return prof, busy


def measure(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float | None = None,
            cache: str = CACHE) -> Run:
    """Set-up, the window and the check of one run of the cell."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed)
    s = prepare(cell, seed, device, cache)
    run.load_s = s.load_s
    one_estimate(s, 0)                                  # warm
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    run.work = work.estimate_work(cell.config, cell.traffic,
                                  s.problem.annot)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof, busy = _profiler(trace, cuda)
    if prof is not None:
        prof.start()
    request = 1
    with _span("window"):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                run.estimates.append(one_estimate(s, request))
            except Exception as e:          # counted as a failed estimate
                traceback.print_exc()
                run.errors.append(repr(e))
            if busy is not None:
                prof.step()
            request += 1
        _sync(device)
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    if cuda:
        run.peak_device_bytes = torch.cuda.max_memory_allocated()
    run.peak_host_bytes = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    run.forbidden = forbidden_modules()
    if trace:
        run.trace = devtrace.summarize(prof)
        run.device_busy_s = run.trace.busy_s if cuda else None
    elif busy is not None:
        run.device_busy_s = sum(busy)
    del prof
    check(run, s, device)
    return run


def check(run: Run, s: Prepared, device: str):
    """Free the port's state, recompute every estimate of the window with
    the plain reference and fill run.checks."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if not run.estimates:
        return
    phenos = np.concatenate([e["pheno"] for e in run.estimates], axis=1)
    prog = np.concatenate([e["sigma"] for e in run.estimates], axis=0)
    ref = reference.estimate(s.problem, phenos, device)
    var = reference.pheno_variance(s.problem, phenos)
    run.checks = compare.checks(s.cell.config, prog, ref, var, run.failed)
