#!/usr/bin/env python
"""Simulate replicate phenotypes from a real .bed (reference
simulate_pheno.py:17-59): per-bin effect sizes beta ~ N(0, sigma_k/M_k) on
standardized genotypes, optional covariate effect, writes
`<out_dir>/<i>.phen` replicates. The port's copy of the JAX package's
root simulate_pheno.py: the same arguments and, for the same seed, the
same files byte for byte. It runs on the host (numpy), as that one does.

    python -m pyrhe_tpu_torch.simulate_pheno -g geno [-annot a.annot | -b K]
        [--sigma s1 .. sK] [-c cov] [--replicates 25] [--seed 0] [-o dir]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="Simulate phenotypes")
    ap.add_argument("-g", "--genotype", required=True, help="PLINK prefix")
    ap.add_argument("-annot", "--annotation", default=None)
    ap.add_argument("-b", "--num_bin", type=int, default=1)
    ap.add_argument("--sigma", type=float, nargs="+", default=[0.25],
                    help="per-bin genetic variances")
    ap.add_argument("-c", "--covariate", default=None)
    ap.add_argument("--beta_cov", type=float, default=0.05,
                    help="fixed covariate effect size (reference uses 0.05)")
    ap.add_argument("--replicates", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--out_dir", default=".")
    args = ap.parse_args(argv)

    from .io import synth
    from .io.readers import read_annot, read_bim, read_cov, read_fam

    num_indiv, _ = read_fam(args.genotype + ".fam")
    num_snp = read_bim(args.genotype + ".bim")
    if args.annotation:
        _, annot, _ = read_annot(args.annotation)
    else:
        annot = synth.make_annot(
            os.path.join(args.out_dir, "generated_annot"), num_snp,
            args.num_bin, seed=args.seed)
    cov = None
    if args.covariate:
        cov, _ = read_cov(args.covariate)
        covs = (cov - cov.mean(0)) / cov.std(0, ddof=1)
        cov = covs * args.beta_cov / 0.05  # scale folded into effect below

    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(args.replicates):
        ys = synth.simulate_pheno_file(
            os.path.join(args.out_dir, str(i)), args.genotype,
            args.sigma, annot, seed=args.seed + i, cov=cov, write=False)
        with open(os.path.join(args.out_dir, f"{i}.phen"), "w") as f:
            f.write("FID IID pheno\n")
            for n in range(num_indiv):
                f.write(f"{n} 1 {ys[n, 0]:.6g}\n")
    print(f"wrote {args.replicates} replicates to {args.out_dir}")


if __name__ == "__main__":
    main()
