"""The biobank-size synthetic cohort of the on-card runs.

chip_smoke.py (phase 4) and profile_run drive the main paths on this one
cohort, so their numbers describe the same work: N = 100,000 individuals x
M = 100,000 SNPs (a 2.5 GB .bed, 1 % missing), 8 bins of per-bin h2 0.05
(total 0.4, no dominance, GxE or NxE effect), 4 covariates and 2 binary
environments (read by GENIE only); models run it with J = 100 jackknife
blocks, B = 10 random probes and seed 5.
"""
from __future__ import annotations

N, M, BINS, NCOV, NUM_ENV = 100_000, 100_000, 8, 4, 2
JACK, PROBES, SEED = 100, 10, 5
SIGMA = [0.05] * BINS            # per-bin h2; truth total 0.4


GENIE_MODEL = "G+GxE+NxE"


def make(prefix: str) -> str:
    """Write the cohort's .bed/.bim/.fam/.annot/.pheno/.cov/.env at
    prefix."""
    from .io import synth
    synth.make_dataset_fast(prefix, N, M, SIGMA, seed=11, missing_rate=0.01)
    synth.make_cov_file(prefix + ".cov", N, num_cov=NCOV, seed=11)
    synth.make_env_file(prefix + ".env", N, num_env=NUM_ENV, seed=11)
    return prefix


def genie_kw(prefix: str) -> dict:
    """GENIE's extra arguments on the cohort at prefix (G+GxE+NxE)."""
    return dict(env_file=prefix + ".env", genie_model=GENIE_MODEL)


def model(cls, prefix: str, **kw):
    """cls (RHE, StreamingRHE, GENIE with genie_kw(prefix), ...) on the
    cohort at prefix, on the card; kw may set num_random_vec (default
    PROBES)."""
    from .utils.logger import Logger
    kw.setdefault("num_random_vec", PROBES)
    return cls(geno_file=prefix, annot_file=prefix + ".annot",
               pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
               num_jack=JACK, seed=SEED, device="cuda",
               log=Logger(suppress=True, debug_mode=False), **kw)


def cli_args(prefix: str, env_file: str | None = None,
             genie_model: str | None = None) -> list:
    """The CLI flags that run the same model on the cohort at prefix (with
    genie_kw(prefix) for GENIE)."""
    args = ["-g", prefix, "-annot", prefix + ".annot", "-p",
            prefix + ".pheno", "-c", prefix + ".cov", "-k", str(PROBES),
            "-jn", str(JACK), "-s", str(SEED), "--device", "cuda"]
    if env_file is not None:
        args += ["-e", env_file]
    if genie_model is not None:
        args += ["--genie_model", genie_model]
    return args
