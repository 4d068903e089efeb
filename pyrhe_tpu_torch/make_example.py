#!/usr/bin/env python
"""Write the example dataset that example/configs/* and the golden outputs
in example/outputs/ expect: N = 5000 individuals, M = 10000 SNPs, one
trait, 5 covariates, a binary environment, single- and 8-bin annotations,
and a two-trait phenotype file. The port's copy of example/make_example.py:
the same files under the same names, byte for byte, for the same seeds.
It runs on the host (numpy) and imports neither torch nor jax.

    python -m pyrhe_tpu_torch.make_example [--out DIR]

Files: test.{bed,bim,fam,cov,env,pheno}, single.annot, multi.annot and
test.pheno.multi. The configs name them relative to the directory they
run in, so run a config from DIR.
"""
from __future__ import annotations

import argparse
import os

from .io import synth


def main(out: str = ".") -> str:
    """Write the example dataset into out; returns its genotype prefix."""
    os.makedirs(out, exist_ok=True)
    prefix = os.path.join(out, "test")
    synth.make_dataset(prefix, 5000, 10000, seed=42, missing_rate=0.005)
    a1 = synth.make_annot(os.path.join(out, "single.annot"), 10000, 1,
                          seed=42)
    synth.make_annot(os.path.join(out, "multi.annot"), 10000, 8, seed=43)
    cov = synth.make_cov_file(os.path.join(out, "test.cov"), 5000,
                              num_cov=5, seed=42)
    env = synth.make_env_file(os.path.join(out, "test.env"), 5000,
                              num_env=1, seed=42)
    synth.simulate_pheno_file(prefix, prefix, [0.2], a1, seed=44, cov=cov,
                              env=env, sigma_gxe=0.05)
    synth.simulate_pheno_file(os.path.join(out, "test.multi"), prefix,
                              [0.2], a1, seed=45, num_traits=2)
    os.replace(os.path.join(out, "test.multi.pheno"),
               os.path.join(out, "test.pheno.multi"))
    print("example dataset written under", out)
    return prefix


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Write the example dataset")
    ap.add_argument("--out", default=".",
                    help="directory to write into (made if missing)")
    main(ap.parse_args().out)
