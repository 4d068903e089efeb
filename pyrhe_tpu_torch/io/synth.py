"""Synthetic genotype/phenotype fixture generation.

The reference's example/test.bed is a stripped large blob, so this module
regenerates complete PLINK datasets (bed/bim/fam + annot/pheno/cov/env) with
pinned seeds for tests and benchmarks, mirroring the reference's simulators
(reference simulate_pheno.py:17-59, base.py:208-262, util/generate_annot.py).
"""
from __future__ import annotations

import os

import numpy as np

from .bed import write_bed


def make_dataset(
    prefix: str,
    num_indiv: int,
    num_snp: int,
    seed: int = 0,
    maf_range=(0.05, 0.45),
    missing_rate: float = 0.0,
    chunk: int = 4096,
):
    """Write `<prefix>.bed/.bim/.fam` with HWE genotypes at random MAFs.

    Returns the per-SNP MAF array. Genotypes are dosages of the A2 allele
    (our decoder's convention); missing genotypes are coded 255 in .bed.
    """
    rng = np.random.default_rng(seed)
    mafs = rng.uniform(maf_range[0], maf_range[1], size=num_snp)

    with open(prefix + ".bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        for s0 in range(0, num_snp, chunk):
            s1 = min(s0 + chunk, num_snp)
            p = mafs[s0:s1][:, None].astype(np.float32)
            # float32 randoms + in-place compares: biobank-scale synthesis
            # (N=300k, M=500k) is RNG-bandwidth-bound
            u = rng.random((s1 - s0, num_indiv), dtype=np.float32)
            geno = (u < p * p).astype(np.uint8)   # 2 with prob p^2
            geno += u < (p * p + 2 * p * (1 - p))  # +1 with p^2+2p(1-p)
            if missing_rate > 0:
                miss = rng.random(geno.shape,
                                  dtype=np.float32) < missing_rate
                geno = np.where(miss, np.uint8(255), geno)
            from .bed import encode_dosage
            f.write(encode_dosage(geno).tobytes())

    with open(prefix + ".bim", "w") as f:
        for i in range(num_snp):
            f.write(f"1\trs{i}\t0\t{i}\tA\tG\n")
    with open(prefix + ".fam", "w") as f:
        for i in range(num_indiv):
            f.write(f"{i} 1 0 0 0 -9\n")
    return mafs


def make_dataset_fast(
    prefix: str,
    num_indiv: int,
    num_snp: int,
    sigma_list,
    seed: int = 0,
    maf_range=(0.05, 0.45),
    missing_rate: float = 0.0,
    chunk: int = 2048,
):
    """One-pass biobank-scale synthesis for benchmarks.

    Writes `<prefix>.bed/.bim/.fam/.annot/.pheno` in a single sweep. The
    genotypes and the phenotype contribution y = sum_k X_k beta_k are
    generated together by the native C++ generator (io/bed.synth_packed_
    block: HWE draws written straight into packed 2-bit bytes, never
    materializing the (m, N) dosage matrix), falling back to a chunked
    NumPy path (uint8 uniforms; MAF quantized to 1/256 — immaterial for
    benchmarking). Both avoid the second full .bed read that make_dataset
    + simulate_pheno_file pays. Fixtures must keep using make_dataset: its
    RNG stream is pinned by the golden tests.
    """
    rng = np.random.default_rng(seed)
    mafs = rng.uniform(maf_range[0], maf_range[1], size=num_snp)
    num_bin = len(sigma_list)
    annot = np.zeros((num_snp, num_bin), dtype=np.int64)
    annot[np.arange(num_snp), rng.integers(0, num_bin, size=num_snp)] = 1
    len_bin = annot.sum(axis=0)
    bin_of = annot.argmax(axis=1)
    beta_sd = np.sqrt(np.asarray(sigma_list) / np.maximum(len_bin, 1))
    beta = rng.normal(size=num_snp) * beta_sd[bin_of]
    # standardization uses the generative moments: mean = 2p (quantized),
    # sd = sqrt(mean * (1 - mean/2)) — the engine's formula
    mean = 2.0 * mafs
    sd = np.sqrt(np.maximum(mean * (1 - 0.5 * mean), 1e-12))
    w = (beta / sd).astype(np.float32)

    from .bed import encode_dosage, synth_packed_block

    y = np.zeros(num_indiv, dtype=np.float64)
    with open(prefix + ".bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        for s0 in range(0, num_snp, chunk):
            s1 = min(s0 + chunk, num_snp)
            packed = synth_packed_block(seed, s0, s1 - s0, num_indiv,
                                        mafs[s0:s1], missing_rate,
                                        w[s0:s1], y)
            if packed is None:               # NumPy fallback
                p = mafs[s0:s1][:, None].astype(np.float32)
                t2 = np.floor(p * p * 256).astype(np.uint8)
                t12 = np.floor((p * p + 2 * p * (1 - p)) * 256) \
                    .astype(np.uint8)
                u = rng.integers(0, 256, size=(s1 - s0, num_indiv),
                                 dtype=np.uint8)
                geno = (u < t2).astype(np.uint8)
                geno += u < t12
                y += geno.astype(np.float32).T @ w[s0:s1]
                if missing_rate > 0:
                    n_miss = rng.binomial(geno.size, missing_rate)
                    idx = rng.integers(0, geno.size, size=n_miss)
                    geno.ravel()[idx] = 255
                packed = encode_dosage(geno)
            f.write(packed.tobytes())

    # subtract the analytic mean offset of the standardized contributions
    y -= float(mean @ (w.astype(np.float64)))
    resid = max(1.0 - float(np.sum(sigma_list)), 0.05)
    y += rng.normal(0, np.sqrt(resid), size=num_indiv)

    with open(prefix + ".bim", "w") as f:
        for i in range(num_snp):
            f.write(f"1\trs{i}\t0\t{i}\tA\tG\n")
    with open(prefix + ".fam", "w") as f:
        for i in range(num_indiv):
            f.write(f"{i} 1 0 0 0 -9\n")
    np.savetxt(prefix + ".annot", annot, fmt="%d", delimiter=" ")
    with open(prefix + ".pheno", "w") as f:
        f.write("FID IID pheno\n")
        for i in range(num_indiv):
            f.write(f"{i} 1 {y[i]:.6g}\n")
    return mafs, annot, y


def make_annot(path: str, num_snp: int, num_bin: int, seed: int = 0,
               overlap: bool = False):
    """Write an annot file; one-hot by default, ~20% double-membership if overlap."""
    rng = np.random.default_rng(seed)
    annot = np.zeros((num_snp, num_bin), dtype=np.int64)
    annot[np.arange(num_snp), rng.integers(0, num_bin, size=num_snp)] = 1
    if overlap and num_bin > 1:
        extra = rng.random(num_snp) < 0.2
        second = rng.integers(0, num_bin, size=num_snp)
        annot[extra, second[extra]] = 1
    np.savetxt(path, annot, fmt="%d", delimiter=" ")
    return annot


def simulate_pheno_file(
    prefix: str,
    bed_prefix: str,
    sigma_list,
    annot: np.ndarray,
    seed: int = 0,
    num_traits: int = 1,
    cov: np.ndarray | None = None,
    env: np.ndarray | None = None,
    sigma_gxe=0.0,
    sigma_nxe=0.0,
    binary: bool = False,
    write: bool = True,
):
    """Simulate y = sum_k X_k beta_k (+ GxE) (+ NxE) (+ cov effect) + e and
    write `<prefix>.pheno`. Returns the (N, T) phenotype matrix.

    Follows the reference's generative model (simulate_pheno.py:31-59,
    base.py:229-256): per-bin betas ~ N(0, sigma_k / M_k), residual variance
    1 - sum(sigma); with covariates a fixed unit effect is added.

    `sigma_gxe` / `sigma_nxe` may be a scalar (applies to env column 0,
    backward compatible) or a sequence with one value per env column:
      GxE: y += env_e * (X_std @ gamma_e),  gamma_e ~ N(0, s_gxe[e]/M_k)
      NxE: y += env_e * nu_e,               nu_e    ~ N(0, s_nxe[e] I)
    which makes Var(y) = sum s_gxe[e] * diag(env_e) K diag(env_e)
    + sum s_nxe[e] * diag(env_e^2) + ... — exactly GENIE's G+GxE+NxE
    estimand (reference genie.py:53-84 kernel definitions), so the
    estimates can be tested against the known truth.
    """
    from .readers import read_bim, read_fam
    from .bed import BedFile

    num_indiv, _ = read_fam(bed_prefix + ".fam")
    num_snp = read_bim(bed_prefix + ".bim")
    bed = BedFile(bed_prefix + ".bed", num_indiv, num_snp)
    rng = np.random.default_rng(seed)

    num_bin = annot.shape[1]
    sigma_list = list(sigma_list)
    assert len(sigma_list) == num_bin
    len_bin = annot.sum(axis=0)

    def _per_env(s):
        """Scalar -> env column 0 only (backward compat); sequence -> one
        value per env column."""
        if env is None:
            return []
        if np.isscalar(s):
            return [float(s)] + [0.0] * (env.shape[1] - 1)
        s = [float(v) for v in s]
        assert len(s) == env.shape[1], (len(s), env.shape[1])
        return s
    s_gxe, s_nxe = _per_env(sigma_gxe), _per_env(sigma_nxe)

    ys = np.zeros((num_indiv, num_traits))
    for t in range(num_traits):
        y = np.zeros(num_indiv)
        for s0 in range(0, num_snp, 4096):
            s1 = min(s0 + 4096, num_snp)
            g = bed.read_block(s0, s1)                    # (m, N) u8
            sums, nmiss = bed.col_stats(g)
            n_obs = np.maximum(g.shape[1] - nmiss, 1)
            mean = (sums / n_obs).astype(np.float32)
            gf = g.astype(np.float32)
            miss = g == 255
            if miss.any():
                gf[miss] = np.broadcast_to(mean[:, None], g.shape)[miss]
            sd = np.sqrt(mean * (1 - 0.5 * mean))
            sd[sd == 0] = 1.0
            gs = (gf - mean[:, None]) / sd[:, None]  # standardized (m, N)
            for k in range(num_bin):
                mask = annot[s0:s1, k] == 1
                if not mask.any() or len_bin[k] == 0:
                    continue
                beta = rng.normal(0, np.sqrt(sigma_list[k] / len_bin[k]),
                                  size=mask.sum())
                contrib = gs[mask].T @ beta.astype(np.float32)
                y += contrib
                for e, s_e in enumerate(s_gxe):
                    if s_e <= 0:
                        continue
                    beta_gxe = rng.normal(
                        0, np.sqrt(s_e / len_bin[k]), size=mask.sum())
                    y += env[:, e] * (gs[mask].T
                                      @ beta_gxe.astype(np.float32))
        for e, s_e in enumerate(s_nxe):
            if s_e > 0:
                y += env[:, e] * rng.normal(0, np.sqrt(s_e),
                                            size=num_indiv)
        resid = max(1.0 - sum(sigma_list) - sum(s_gxe) - sum(s_nxe), 0.05)
        y += rng.normal(0, np.sqrt(resid), size=num_indiv)
        if cov is not None:
            y += cov @ np.ones(cov.shape[1]) * 0.05
        if binary:
            y = (y > np.quantile(y, 0.7)).astype(np.float64)
        ys[:, t] = y

    if write:
        cols = " ".join(f"pheno{t}" if num_traits > 1 else "pheno"
                        for t in range(num_traits))
        with open(prefix + ".pheno", "w") as f:
            f.write(f"FID IID {cols}\n")
            for i in range(num_indiv):
                vals = " ".join(f"{v:.6g}" for v in ys[i])
                f.write(f"{i} 1 {vals}\n")
    return ys


def make_cov_file(path: str, num_indiv: int, num_cov: int = 5, seed: int = 0,
                  binary_first: bool = True):
    rng = np.random.default_rng(seed + 1)
    cov = rng.normal(size=(num_indiv, num_cov))
    if binary_first and num_cov > 0:
        cov[:, 0] = (cov[:, 0] > 0).astype(np.float64)
    with open(path, "w") as f:
        hdr = " ".join(f"cov{i}" for i in range(num_cov))
        f.write(f"FID IID {hdr}\n")
        for i in range(num_indiv):
            vals = " ".join(f"{v:.15g}" for v in cov[i])
            f.write(f"{i} 1 {vals}\n")
    return cov


def make_env_file(path: str, num_indiv: int, num_env: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed + 2)
    env = (rng.random((num_indiv, num_env)) < 0.5).astype(np.float64)
    with open(path, "w") as f:
        hdr = " ".join("env" if num_env == 1 else f"env{i}"
                       for i in range(num_env))
        f.write(f"FID IID {hdr}\n")
        for i in range(num_indiv):
            vals = " ".join(f"{v:.0f}" for v in env[i])
            f.write(f"{i} 1 {vals}\n")
    return env
