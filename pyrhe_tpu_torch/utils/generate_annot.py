#!/usr/bin/env python
"""CLI: write a random one-hot annotation file for a .bed (reference
util/generate_annot.py); the port's copy of
pyrhe_tpu/utils/generate_annot.py, with the same arguments and output.

    python -m pyrhe_tpu_torch.utils.generate_annot -g geno -b 8 \
        -o generated_annot [--seed 0]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate random annot")
    ap.add_argument("-g", "--genotype", required=True,
                    help="PLINK prefix (reads .bim for SNP count)")
    ap.add_argument("-b", "--num_bin", type=int, default=8)
    ap.add_argument("-o", "--output", default="generated_annot")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    from ..io.readers import generate_annot, read_bim

    num_snp = read_bim(args.genotype + ".bim")
    rng = np.random.RandomState(args.seed) if args.seed is not None else None
    generate_annot(args.output, num_snp, args.num_bin, rng=rng)
    print(f"wrote {args.output} ({num_snp} SNPs x {args.num_bin} bins)")


if __name__ == "__main__":
    main()
