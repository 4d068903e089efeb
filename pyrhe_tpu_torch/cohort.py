"""The biobank-size synthetic cohort of the on-card runs.

chip_smoke.py (phase 4) and profile_run drive the main paths on this one
cohort, so their numbers describe the same work: N = 100,000 individuals x
M = 100,000 SNPs (a 2.5 GB .bed, 1 % missing), 8 bins of per-bin h2 0.05
(total 0.4, no dominance effect), 4 covariates; models run it with
J = 100 jackknife blocks, B = 10 random probes and seed 5.
"""
from __future__ import annotations

N, M, BINS, NCOV = 100_000, 100_000, 8, 4
JACK, PROBES, SEED = 100, 10, 5
SIGMA = [0.05] * BINS            # per-bin h2; truth total 0.4


def make(prefix: str) -> str:
    """Write the cohort's .bed/.bim/.fam/.annot/.pheno/.cov at prefix."""
    from .io import synth
    synth.make_dataset_fast(prefix, N, M, SIGMA, seed=11, missing_rate=0.01)
    synth.make_cov_file(prefix + ".cov", N, num_cov=NCOV, seed=11)
    return prefix


def model(cls, prefix: str):
    """cls (RHE, StreamingRHE, ...) on the cohort at prefix, on the card."""
    from .utils.logger import Logger
    return cls(geno_file=prefix, annot_file=prefix + ".annot",
               pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
               num_jack=JACK, num_random_vec=PROBES, seed=SEED,
               device="cuda", log=Logger(suppress=True, debug_mode=False))


def cli_args(prefix: str) -> list:
    """The CLI flags that run the same model on the cohort at prefix."""
    return ["-g", prefix, "-annot", prefix + ".annot", "-p",
            prefix + ".pheno", "-c", prefix + ".cov", "-k", str(PROBES),
            "-jn", str(JACK), "-s", str(SEED), "--device", "cuda"]
