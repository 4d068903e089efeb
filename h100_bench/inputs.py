"""What a run draws from its --seed: covariates, environments, phenotypes.

The genotypes are the cohort's (cohort.py, fixed by the configuration's
`geno_seed`); everything a user changes between analyses of one cohort
comes from the run's seed:

  - covariates (N, num_cov): standard normal, the first one made binary
    (as the port's synth.make_cov_file draws them), from
    default_rng([seed, 101]);
  - environments (N, num_env): binary, P(1) = 1/2, from
    default_rng([seed, 102]);
  - per-SNP effects beta_s ~ N(0, h2_k / M_k) of SNP s in bin k, from
    default_rng([seed, 103]), and the genetic value g = Σ_s x_s beta_s over
    the standardized dosages (missing calls at the mean), computed once
    in set-up on the device: the additive genetic value, which a model
    file (layout.py) may replace with a `genetic_value` of its own;
  - per request r, noise ~ N(0, 1 - Σ_k h2_k) from
    default_rng([seed, 104, r]) and a phenotype (g + noise) per trait,
    centered, as the port's loader centers a phenotype file.

Covariates and environments are written as text files, which the port
loads as a user's would; the arrays go to the reference as drawn (a value
printed with 17 significant digits reads back within an ulp).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import reference


def seed_words(seed: int) -> list:
    """A non-negative seed of any size as 32-bit words for SeedSequence."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("the seed must be non-negative")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def _rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng([*seed_words(seed), *tags])


def covariates(config: dict, seed: int) -> np.ndarray | None:
    if not config["num_cov"]:
        return None
    cov = _rng(seed, 101).normal(size=(config["num_indiv"],
                                       config["num_cov"]))
    cov[:, 0] = (cov[:, 0] > 0).astype(np.float64)
    return cov


def environments(config: dict, seed: int) -> np.ndarray | None:
    if not config["num_env"]:
        return None
    return (_rng(seed, 102).random((config["num_indiv"], config["num_env"]))
            < 0.5).astype(np.float64)


def write_table(path: str, values: np.ndarray, prefix: str) -> str:
    """A FID IID table of `values` (N, k) with columns prefix0.. ."""
    hdr = " ".join(f"{prefix}{i}" for i in range(values.shape[1]))
    rows = np.char.add(
        np.char.add(np.arange(len(values)).astype(str), " 1 "),
        [" ".join(f"{v:.17g}" for v in row) for row in values])
    with open(path, "w") as f:
        f.write(f"FID IID {hdr}\n")
        f.write("\n".join(rows.tolist()) + "\n")
    return path


def genetic_value(config: dict, seed: int, bed_path: str, annot: np.ndarray,
                  device) -> np.ndarray:
    """The additive g = Σ_s x_s beta_s (N,) float64 over the cohort's
    .bed."""
    n, m = config["num_indiv"], config["num_snp"]
    len_bin = annot.sum(0)
    sd = np.sqrt(config["h2_per_bin"] / np.maximum(len_bin, 1))
    beta = _rng(seed, 103).normal(size=m) * (annot @ sd)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=device)
    g = torch.zeros(n, dtype=torch.float64, device=device)
    chunks = reference.read_packed(bed_path, n, m, device, chunk_snps=2048)
    for s0, s1, packed in chunks:
        dos = reference.decode(packed, n)
        obs = (dos >= 0).float()
        x = dos.clamp(min=0).float()
        mean = (x * obs).sum(1) / obs.sum(1).clamp(min=1)
        sd_s = torch.sqrt(torch.clamp(mean * (1 - 0.5 * mean), min=1e-12))
        x = (x - mean[:, None]) * obs / sd_s[:, None]
        g += (x.T @ beta_t[s0:s1]).double()
    return g.cpu().numpy()


def phenotype(config: dict, traffic: dict, seed: int, request: int,
              g: np.ndarray) -> np.ndarray:
    """The centered (N, T) phenotype of one request."""
    T = traffic["traits_per_request"]
    resid = 1.0 - config["h2_per_bin"] * config["num_bin"]
    noise = _rng(seed, 104, request).normal(
        0.0, np.sqrt(resid), size=(config["num_indiv"], T))
    y = g[:, None] + noise
    return y - y.mean(axis=0)


def write_side_files(config: dict, seed: int, out_dir: str) -> dict:
    """Draw the seed's covariates and environments, write them under
    out_dir, and return {"cov": array|None, "env": array|None,
    "cov_file": path|None, "env_file": path|None}."""
    os.makedirs(out_dir, exist_ok=True)
    cov, env = covariates(config, seed), environments(config, seed)
    return {
        "cov": cov, "env": env,
        "cov_file": (write_table(os.path.join(out_dir, "run.cov"), cov, "cov")
                     if cov is not None else None),
        "env_file": (write_table(os.path.join(out_dir, "run.env"), env, "env")
                     if env is not None else None),
    }
