#!/usr/bin/env python
"""Sweep many phenotypes over one genotype dataset on the port (the role
of the reference's test_real.py, which loops 50 UKBB phenotypes by editing
a shared INI config under an fcntl lock and launching one process each —
re-reading the genotypes for every phenotype). The port's copy of
scripts/sweep_phenotypes.py, with the same functions, flags and outputs.

The genome pass is amortized twice over:
  - every trait column inside one file shares a single engine precompute
    (each residualized trait is one more column of the probe matrix, so on
    the card one more stage-1 column of gp_matmul; the stats cache does not
    depend on the trait count);
  - phenotype FILES with identical missing-individual sets are MERGED
    into one multi-trait pass (same filtering -> same probe matrix ->
    the same per-trait estimates as an individual run; guarded by
    tests/test_torch_sweep.py), so a 50-file sweep with complete
    phenotypes pays ONE genome pass, not 50. Files whose missing sets
    differ get their own group (filtering changes the kept cohort).

Results are collected into a summary JSON compatible with
parse_output.py's schema, plus one report .txt per input file. Each
group's line on stdout gives its wall time and, on the card, its peak
device memory.

`--device` defaults to the CUDA card and raises without one; `--device
cpu` runs the same path on the CPU. `--dtype` is the working dtype, as in
the port's CLI (default float32).

Usage:
    python -m pyrhe_tpu_torch.sweep_phenotypes -g data/geno \
        -annot data/snps.annot --pheno_glob 'phenos/*.pheno' -o results/ \
        [-c covar.cov] [-k 10] [--streaming] [--device cpu] [--dtype float64]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def group_pheno_files(files: list[str]):
    """Group phenotype files by (row count, missing-individual set).

    Files in one group drop the same individuals, so their traits can
    share a single engine pass. Returns a list of groups, each a list of
    paths (input order preserved within and across groups)."""
    from .io.readers import read_pheno

    groups: dict[tuple, list[str]] = {}
    for path in files:
        y, missing, _ = read_pheno(path)
        groups.setdefault((y.shape[0], tuple(missing)), []).append(path)
    return list(groups.values())


def merge_pheno_files(paths: list[str], out_path: str):
    """Write a single `FID IID <traits...>` file concatenating every
    group member's trait columns (column names prefixed by file stem to
    stay unique). Every member must list the SAME individuals in the
    SAME order — merging is purely row-positional, so a reordered file
    would silently attach traits to the wrong IDs otherwise. Returns the
    per-file trait counts, in path order."""
    fids = None
    headers: list[str] = []
    bodies: list[list[list[str]]] = []
    n_traits: list[int] = []
    for p in paths:
        with open(p) as f:
            lines = [ln.split() for ln in f.read().splitlines()
                     if ln.strip()]
        hdr, rows = lines[0], lines[1:]
        ids = [(r[0], r[1]) for r in rows]
        if fids is None:
            fids = ids
        elif ids != fids:
            raise ValueError(
                f"{p} lists different (or differently ordered) FID/IID "
                f"rows than {paths[0]}; cannot merge into one pass")
        stem = os.path.splitext(os.path.basename(p))[0]
        headers.extend(f"{stem}_{h}" for h in hdr[2:])
        bodies.append([r[2:] for r in rows])
        n_traits.append(len(hdr) - 2)
    with open(out_path, "w") as f:
        f.write("FID IID " + " ".join(headers) + "\n")
        for i, (fid, iid) in enumerate(fids):
            vals = [v for b in bodies for v in b[i]]
            f.write(f"{fid} {iid} " + " ".join(vals) + "\n")
    return n_traits


def run_sweep(args) -> dict:
    import torch

    from .core.engine import pick_device
    from .models import RHE, StreamingRHE
    from .utils.logger import Logger

    # raise before any file is read when the card is asked for and absent
    dev = pick_device(args.device)
    on_card = dev.type == "cuda"
    os.makedirs(args.output_dir, exist_ok=True)
    summary: dict = {}
    files = sorted(glob.glob(args.pheno_glob))
    if not files:
        sys.exit(f"no phenotype files match {args.pheno_glob}")
    cls = StreamingRHE if args.streaming else RHE
    groups = ([[p] for p in files] if args.no_merge
              else group_pheno_files(files))
    print(f"{len(files)} phenotype files -> {len(groups)} genome "
          f"pass(es)", flush=True)

    for gi, group in enumerate(groups):
        t_group = time.time()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        if len(group) == 1:
            pheno_path = group[0]
            with open(pheno_path) as f:
                traits_per_file = [len(f.readline().split()) - 2]
        else:
            pheno_path = os.path.join(args.output_dir,
                                      f"_merged_group{gi}.pheno")
            traits_per_file = merge_pheno_files(group, pheno_path)
        model = cls(geno_file=args.genotype, annot_file=args.annotation,
                    pheno_file=pheno_path, cov_file=args.covariate,
                    num_jack=args.num_block, num_random_vec=args.num_vec,
                    seed=args.seed, device=args.device, dtype=args.dtype)
        trait0 = 0
        for path, nt in zip(group, traits_per_file):
            name = os.path.splitext(os.path.basename(path))[0]
            # per-file wall time: the group's shared precompute lands in
            # the FIRST file's runtime (where the lazy engine pass runs),
            # later files report only their near-free solve time
            t_file = time.time()
            # per-file report: swap in a fresh logger so each input file
            # gets its own .txt with only its trait sections. The engine
            # captured the ctor-time logger (models/base.py), so retarget
            # it too: what it logs during the lazy passes must land in the
            # first file's report. load_dataset logs only while the model
            # is built, and the sweep opens no checkpoint, so nothing else
            # holds the logger.
            model.log = Logger(suppress=True, debug_mode=False)
            model.engine.log = model.log
            for t in range(nt):
                res = model(trait=trait0 + t)
                key = name if nt == 1 else f"{name}:trait{t}"
                summary[key] = {k: (v.tolist() if hasattr(v, "tolist")
                                    else v) for k, v in res.items()}
                summary[key]["runtime"] = time.time() - t_file
            model.log.output_file = os.path.join(args.output_dir,
                                                 name + ".txt")
            model.log._save_log()
            trait0 += nt
            print(f"{name}: done in {time.time() - t_file:.1f}s "
                  f"(group {gi + 1}/{len(groups)})", flush=True)
        # the next group's model must not coexist with this one (its
        # stats cache would double the peak)
        del model
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB"
                if on_card else "")
        print(f"group {gi + 1}/{len(groups)}: {len(group)} file(s), "
              f"{sum(traits_per_file)} trait(s): "
              f"{time.time() - t_group:.3f} s{peak}", flush=True)

    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {args.output_dir}/summary.json ({len(summary)} traits)")
    return summary


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("-g", "--genotype", required=True)
    ap.add_argument("-annot", "--annotation", default=None)
    ap.add_argument("--pheno_glob", required=True)
    ap.add_argument("-c", "--covariate", default=None)
    ap.add_argument("-o", "--output_dir", default=None,
                    help="defaults to $RESULT_DIR/sweep_out (constant.py)")
    ap.add_argument("-k", "--num_vec", type=int, default=10)
    ap.add_argument("-jn", "--num_block", type=int, default=100)
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_merge", action="store_true",
                    help="one engine pass per file even when files share "
                         "a missing-individual set")
    ap.add_argument("--device", type=str, default="auto",
                    help="auto (= cuda) | cuda | cpu")
    ap.add_argument("--dtype", type=str, default=None,
                    choices=[None, "float32", "float64", "bfloat16"],
                    help="working dtype (default float32, as the port's "
                         "CLI)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.output_dir is None:
        from .constant import RESULT_DIR
        args.output_dir = os.path.join(RESULT_DIR, "sweep_out")
    run_sweep(args)


if __name__ == "__main__":
    main()
