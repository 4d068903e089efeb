"""Dataset assembly: files -> filtered, centered, projection-ready arrays.

Carried over from pyrhe_tpu/core/data.py unchanged apart from the
pandas-free fam table (io/readers.py): Z, Uzb and Q come out bit-identical
to the reference's for the same files and seed.

Behavioral spec: the data-ingest half of the reference's Base.__init__
(reference base.py:99-188): read fam/bim/annot/pheno/cov/env, drop
individuals missing in phenotype or covariates, center the phenotype,
compute the covariate projection Q = pinv(W^T W), and draw the shared
random probes z_b (and U z_b) with the reference's RNG ordering
(np.random.seed(seed) -> optional generate_annot -> randn probes,
base.py:73,112,176-178).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bed import BedFile
from ..io.readers import (generate_annot, read_annot, read_bim, read_cov,
                          read_env_file, read_fam, read_pheno)
from ..utils.logger import Logger


@dataclass
class DataBundle:
    bed: BedFile
    num_indv: int
    num_snp: int
    num_bin: int
    annot: np.ndarray            # (M, K) int
    len_bin: np.ndarray          # (K,)
    pheno: np.ndarray | None     # (N, T) centered float64
    binary_pheno: bool
    cov: np.ndarray | None       # (N, C)
    Q: np.ndarray | None         # (C, C)
    env: np.ndarray | None       # (N, num_env)
    num_env: int
    Z: np.ndarray                # (N, B) probes
    Uzb: np.ndarray | None       # (N, B) projected probes
    missing_indv: list = field(default_factory=list)
    num_indv_original: int = 0
    pheno_file: str | None = None

    @property
    def num_traits(self) -> int:
        return 0 if self.pheno is None else self.pheno.shape[1]

    def resid_pheno(self) -> np.ndarray:
        """Covariate-residualized phenotype (reference base.py:396-401)."""
        y = self.pheno
        if self.cov is None:
            return y
        return y - self.cov @ (self.Q @ (self.cov.T @ y))


def load_dataset(
    geno_file: str,
    annot_file: str | None = None,
    pheno_file: str | None = None,
    cov_file: str | None = None,
    env_file: str | None = None,
    num_bin: int | None = 8,
    num_random_vec: int = 10,
    seed: int = 0,
    cov_impute_method: str = "ignore",
    cov_one_hot_conversion: bool = False,
    categorical_threshhold: int = 100,
    log: Logger | None = None,
) -> DataBundle:
    log = log or Logger(debug_mode=False)
    rs = np.random.RandomState(seed)

    num_indv_original, fam = read_fam(geno_file + ".fam")
    num_snp = read_bim(geno_file + ".bim")

    if annot_file is None:
        if num_bin is None:
            raise ValueError(
                "Must specify number of bins if annot file is not provided")
        annot_file = "generated_annot"
        generate_annot(annot_file, num_snp, num_bin, rng=rs)
    num_bin, annot, len_bin = read_annot(annot_file)
    # Cross-file geometry checks: a mismatched side file must fail HERE
    # with both file names, not as a cryptic broadcast error deep in the
    # engine. (The reference's only geometry guard is the .bed size
    # implied by .fam x .bim, base.py:100 — this is deliberately
    # stricter.)
    if annot.shape[0] != num_snp:
        raise ValueError(
            f"annotation file {annot_file} has {annot.shape[0]} SNP rows "
            f"but {geno_file}.bim has {num_snp} SNPs — the files do not "
            "describe the same genotype matrix")

    if pheno_file is not None:
        pheno, missing_indv, binary_pheno = read_pheno(pheno_file)
        if pheno.shape[0] != num_indv_original:
            raise ValueError(
                f"phenotype file {pheno_file} has {pheno.shape[0]} "
                f"individual rows but {geno_file}.fam has "
                f"{num_indv_original} individuals — the files do not "
                "describe the same cohort")
    else:
        pheno, missing_indv, binary_pheno = None, [], False

    if pheno is not None:
        log._log(f"Number of traits: {pheno.shape[1]}")

    cov = Q = None
    if cov_file is not None:
        cov, missing_indv = read_cov(
            cov_file,
            missing_indvs=missing_indv,
            cov_impute_method=cov_impute_method,
            one_hot_conversion=cov_one_hot_conversion,
            categorical_threshold=categorical_threshhold,
            logger=log,
        )
        rank = np.linalg.matrix_rank(cov)
        log._log(f"Rank of the covariate matrix: {rank}")
        Q = np.linalg.pinv(cov.T @ cov)

    if pheno is not None and missing_indv:
        pheno = np.delete(pheno, missing_indv, axis=0)
    if pheno is not None:
        pheno = pheno - np.mean(pheno, axis=0)

    num_indv = num_indv_original - len(missing_indv)
    if cov is not None and cov.shape[0] != num_indv:
        raise ValueError(
            f"covariate file {cov_file} has {cov.shape[0]} rows after "
            f"missing-individual filtering but {geno_file}.fam implies "
            f"{num_indv} kept individuals — the files do not describe "
            "the same cohort")
    for idx, mi in enumerate(missing_indv, start=1):
        log._log(f"missing individual {idx}: FID:{fam[mi, 0]} "
                 f"IID:{fam[mi, 1]}")
    log._log(f"Number of individuals after filtering: {num_indv}")
    if cov is not None:
        log._log(f"Number of covariates: {cov.shape[1]}")
    log._log("*****")
    for i, n in enumerate(len_bin):
        log._log(f"Number of features in bin {i} : {n}")

    keep_idx = None
    if missing_indv:
        keep_idx = np.setdiff1d(np.arange(num_indv_original),
                                np.array(missing_indv, dtype=np.int64))
    bed = BedFile(geno_file + ".bed", num_indv_original, num_snp,
                  keep_idx=keep_idx)

    env = None
    num_env = 0
    if env_file is not None:
        num_env, env = read_env_file(env_file)
        if env.shape[0] != num_indv_original:
            raise ValueError(
                f"environment file {env_file} has {env.shape[0]} "
                f"individual rows but {geno_file}.fam has "
                f"{num_indv_original} individuals — the files do not "
                "describe the same cohort")
        if missing_indv:
            env = np.delete(env, missing_indv, axis=0)

    Z = rs.randn(num_indv, num_random_vec)
    Uzb = cov @ (Q @ (cov.T @ Z)) if cov is not None else None

    return DataBundle(
        bed=bed, num_indv=num_indv, num_snp=num_snp, num_bin=num_bin,
        annot=annot, len_bin=len_bin, pheno=pheno,
        binary_pheno=binary_pheno, cov=cov, Q=Q, env=env, num_env=num_env,
        Z=Z, Uzb=Uzb, missing_indv=missing_indv,
        num_indv_original=num_indv_original, pheno_file=pheno_file,
    )
