"""End-to-end wall time of one estimate on the card, phase by phase,
repeated inside one call.

    python -m pyrhe_tpu_torch.bench.e2e [-N 50000] [-M 100000] [-k 10]
        [-jn 100] [--model rhe|rhe_dom|genie] [--genie_model G]
        [--streaming] [--dir D | --prefix P] [--cov FILE] [--seed 1]
        [--checkpoint_dir D] [--pheno FILE] [--cache_blocks -1]
        [--cold_read] [--device auto] [--dtype float32] [--repeats 3]

The port's counterpart of scripts/bench_e2e.py, with its flags. Unless
--prefix names an existing dataset, it synthesizes one (once) at
`<dir>/e2e_<N>_<M>` with the port's io/synth (the JAX tool's generators,
seeds and missing rate; an environment file for GENIE G+GxE*). The CUDA
context, cuBLAS and the kernels' build are timed apart as `setup_s`. Then the
estimate runs `--repeats` times (default 3) through the engine's own
steps: `load+init` (core/data.load_dataset, the engine and its static
arrays), `precompute` (pass 1, ending in a synchronize), `assemble` (pass
2), `solve` (the host float64 solve), `total`. Per phase the tool reports
the median, quartiles and count over the repeats, and likewise for the
engine's overlapped sub-phases (`engine.phase_times`: host_read_s on the
prefetch thread, h2d_s as CUDA events, pass1_s / pass2_s, host cache hits)
and the peak device memory (`torch.cuda.max_memory_allocated`, reset each
repeat). No profiler runs: pyrhe_tpu_torch.profile_run is the traced tool
for the device-time breakdown. Prints ONE JSON line, whose `sigma` is the
last repeat's σ² at full precision (`sigma_repeats_equal` says whether the
repeats agreed bitwise).

--cold_read drops the OS page cache before each repeat (root only), so the
.bed comes off storage; the tool exits non-zero when it cannot.
--checkpoint_dir gives each repeat a directory of its own below it, so no
repeat resumes another's run. --stage_streams is accepted for the JAX
tool's command lines and unused: the engine stages one block at a time.
--device cpu runs the same path on the CPU; its times are host times.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .timing import card, require_card, summary

PHASES = ("load+init", "precompute", "assemble", "solve", "total")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-N", type=int, default=50000)
    ap.add_argument("-M", type=int, default=100000)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-jn", type=int, default=100)
    ap.add_argument("--model", default="rhe",
                    choices=["rhe", "rhe_dom", "genie"])
    ap.add_argument("--genie_model", default="G",
                    choices=["G", "G+GxE", "G+GxE+NxE"])
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "pyrhe_torch_e2e"),
                    help="where the synthesized dataset lives")
    ap.add_argument("--prefix", default=None,
                    help="an existing dataset (.bed/.bim/.fam/.annot/"
                         ".pheno) instead of synthesizing one")
    ap.add_argument("--cov", default=None, help="covariate file")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--stage_streams", type=int, default=0,
                    help="accepted for the JAX tool's command lines; unused")
    ap.add_argument("--pheno", default=None,
                    help="phenotype file (default <prefix>.pheno)")
    ap.add_argument("--cache_blocks", type=int, default=-1,
                    help="hybrid stats-cache split (RunConfig.cache_blocks)")
    ap.add_argument("--cold_read", action="store_true",
                    help="drop the OS page cache before each repeat "
                         "(root only)")
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda; raises without a card) | cuda | cpu")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--repeats", type=int, default=3)
    return ap


def synthesize(args) -> tuple[str, float | None]:
    """(dataset prefix, seconds spent writing it, or None when it was
    there already)."""
    from ..io import synth
    if args.prefix:
        return args.prefix, None
    os.makedirs(args.dir, exist_ok=True)
    prefix = os.path.join(args.dir, f"e2e_{args.N}_{args.M}")
    if os.path.exists(prefix + ".bed"):
        return prefix, None
    t0 = time.perf_counter()
    if args.N * args.M > 10**8:          # large scale: one-pass synthesis
        synth.make_dataset_fast(prefix, args.N, args.M, [0.3], seed=9,
                                missing_rate=0.01)
    else:
        synth.make_dataset(prefix, args.N, args.M, seed=9,
                           missing_rate=0.01)
        annot = synth.make_annot(prefix + ".annot", args.M, 1, seed=9)
        synth.simulate_pheno_file(prefix, prefix, [0.3], annot, seed=10)
    return prefix, time.perf_counter() - t0


def drop_page_cache():
    """Sync, then drop the OS page cache (root only); exits non-zero when
    it cannot, since a cold-read row would then be a warm one."""
    os.sync()
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
    except OSError as e:
        sys.exit(f"--cold_read: could not drop the page cache ({e})")


def run_once(args, prefix, env_file, dev, ckpt_dir):
    """One estimate; returns (phase seconds, engine.phase_times, peak GB
    or None, sigma_total)."""
    from ..core.data import load_dataset
    from ..core.engine import Engine, ModelSpec, RunConfig
    from ..utils.logger import Logger

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    t_start = t0 = time.perf_counter()
    log = Logger(suppress=True, debug_mode=False)
    data = load_dataset(prefix, annot_file=prefix + ".annot",
                        pheno_file=args.pheno or prefix + ".pheno",
                        cov_file=args.cov, env_file=env_file,
                        num_random_vec=args.k, seed=args.seed, log=log)
    spec = ModelSpec.build(args.model, args.genie_model, data.num_env)
    eng = Engine(data, spec, RunConfig(
        num_random_vec=args.k, num_jack=args.jn, seed=args.seed,
        dtype=args.dtype, streaming=args.streaming,
        cache_blocks=args.cache_blocks, checkpoint_dir=ckpt_dir,
        device=str(dev)), log)
    times["load+init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.precompute()                 # ends in a synchronize
    times["precompute"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.assemble()
    times["assemble"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, sigma = eng.estimate(0)
    times["solve"] = time.perf_counter() - t0
    times["total"] = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    return times, dict(eng.phase_times), peak, sigma


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = require_card(args.device)
    prefix, synth_s = synthesize(args)
    env_file = None
    if args.model == "genie" and "GxE" in args.genie_model:
        env_file = prefix + ".env"
        if not os.path.exists(env_file):
            from ..io import synth
            synth.make_env_file(env_file, args.N, num_env=1, seed=11)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from ..ops.kernels import build
        x = torch.ones(8, 8, device=dev)   # the CUDA context and cuBLAS
        x @ x
        build()
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    samples = {k: [] for k in PHASES}
    engine_samples, peaks, sigmas = {}, [], []
    for r in range(args.repeats):
        if args.cold_read:
            drop_page_cache()
        ckpt = (os.path.join(args.checkpoint_dir, f"repeat_{r}")
                if args.checkpoint_dir else None)
        times, eng_times, peak, sigma = run_once(args, prefix, env_file,
                                                 dev, ckpt)
        for k, v in times.items():
            samples[k].append(v)
        for k, v in eng_times.items():
            engine_samples.setdefault(k, []).append(v)
        if peak is not None:
            peaks.append(peak)
        sigmas.append(np.asarray(sigma, np.float64))
    print(json.dumps({
        "tool": "e2e", "N": args.N, "M": args.M, "k": args.k, "J": args.jn,
        "prefix": prefix,
        "model": (args.model if args.model != "genie"
                  else f"genie:{args.genie_model}"),
        "streaming": args.streaming, "dtype": args.dtype,
        "cache_blocks": args.cache_blocks, "cold_read": args.cold_read,
        "repeats": args.repeats, "device": card(dev),
        "sigma": [float(x) for x in sigmas[-1]],
        "sigma_repeats_equal": all(np.array_equal(s, sigmas[0])
                                   for s in sigmas),
        "setup_s": setup_s,
        **({"synthesize_s": synth_s} if synth_s is not None else {}),
        "phases_s": {k: summary(v) for k, v in samples.items()},
        "engine_phases_s": {k: summary(v) for k, v in
                            engine_samples.items()},
        "peak_gb": summary(peaks) if peaks else None,
        "samples_s": samples,
    }))


if __name__ == "__main__":
    main()
