#!/usr/bin/env python
"""Add a fixed covariate effect to existing phenotype files (the role of
the reference's util/simulate_pheno.py: y += standardized(cov) @ 1 for
each .phen replicate, writing <name>_with_cov.phen alongside). The port's
copy of pyrhe_tpu/utils/add_cov_pheno.py: the same arguments and the same
output files, byte for byte.

Usage:
    python -m pyrhe_tpu_torch.utils.add_cov_pheno --pheno_dir DIR \
        --cov FILE [--effect 1.0] [--suffix _with_cov]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def add_cov_effect(pheno_path: str, cov_path: str, effect: float = 1.0,
                   suffix: str = "_with_cov") -> str:
    """Reads a FID IID pheno... file, adds standardized-covariate effect
    (each covariate column standardized then summed with weight `effect`),
    writes the result next to the input. Returns the output path."""
    from ..io.readers import read_cov

    cov, _ = read_cov(cov_path, std=True)
    header = None
    with open(pheno_path) as f:
        first = f.readline().split()
        has_header = not _is_float(first[-1])
    rows = np.loadtxt(pheno_path, skiprows=1 if has_header else 0,
                      dtype=str, ndmin=2)
    if has_header:
        with open(pheno_path) as f:
            header = f.readline().rstrip("\n")
    vals = rows[:, 2:].astype(np.float64)
    vals = vals + effect * cov.sum(axis=1, keepdims=True)
    base, ext = os.path.splitext(pheno_path)
    out_path = base + suffix + ext
    with open(out_path, "w") as f:
        if header:
            f.write(header + "\n")
        for i in range(rows.shape[0]):
            cols = [rows[i, 0], rows[i, 1]] + [f"{v:.6f}" for v in vals[i]]
            f.write(" ".join(cols) + "\n")
    return out_path


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pheno_dir", required=True,
                    help="directory of .phen/.pheno files")
    ap.add_argument("--cov", required=True, help="covariate file")
    ap.add_argument("--effect", type=float, default=1.0)
    ap.add_argument("--suffix", default="_with_cov")
    args = ap.parse_args(argv)
    pats = [os.path.join(args.pheno_dir, "*.phen"),
            os.path.join(args.pheno_dir, "*.pheno")]
    files = [p for pat in pats for p in sorted(glob.glob(pat))
             if args.suffix not in p]
    for p in files:
        out = add_cov_effect(p, args.cov, args.effect, args.suffix)
        print(f"{p} -> {out}")


if __name__ == "__main__":
    main()
