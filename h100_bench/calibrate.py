"""Readings for the limits of compare.py, on the card, in one process.

    python -m h100_bench.calibrate --workload <cell> --seeds 1,2,3
        [--estimates 1] [--control 3]

For each seed: the run's set-up (harness.prepare), `--estimates` estimates
of the port on the cell's traffic, the port's state freed, and the plain
reference: one JSON line per seed with the port's sigma_gap. For the first
`--control` seeds the control too (reference.py in TF32 in the port's
place) and its gap against the float64 reference. The benchmark's runs do
not run this; PERF.md records its readings and the limits set from them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100_bench import compare, harness, reference  # noqa: E402


def readings(cell, seed: int, n_est: int, control: bool,
             device: str = "cuda", cache: str = harness.CACHE) -> dict:
    t0 = time.perf_counter()
    s = harness.prepare(cell, seed, device, cache)
    ests = [harness.one_estimate(s, r) for r in range(1, n_est + 1)]
    mode_ok = all(e["mode_ok"] for e in ests)
    phenos = np.concatenate([e["pheno"] for e in ests], axis=1)
    prog = np.concatenate([e["sigma"] for e in ests], axis=0)
    del ests
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    packed = reference.load_packed(s.problem.bed_path, s.problem.num_indiv,
                                   s.problem.num_snp, device)
    var = reference.pheno_variance(s.problem, phenos)
    ref = reference.estimate(s.problem, phenos, device, packed=packed)
    out = {"workload": cell.name, "seed": seed, "mode_ok": mode_ok,
           "sigma_gap": compare.sigma_gap(prog, ref, var)}
    if control:
        ctl = reference.estimate(s.problem, phenos, device,
                                 precision="tf32", packed=packed)
        out["control_gap"] = compare.sigma_gap(ctl, ref, var)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--estimates", type=int, default=1)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("calibrate needs a CUDA card")
    cell = harness.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        print(json.dumps(readings(cell, seed, args.estimates,
                                  i < args.control)), flush=True)


if __name__ == "__main__":
    main()
