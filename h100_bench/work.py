"""The least device time an estimate needs: the benchmark's frozen roofline.

Peaks: NVIDIA's published figures for one H100 SXM at its full 700 W
power limit, dense (copied from pyrhe_tpu_torch/bench/timing.py): 989
TFLOP/s on bf16 tensor cores, 3.35 TB/s of HBM. The run prints the card's
power limit beside every share of them.

Work of one estimate, counted from the cell's shapes (the algorithm's
products, whatever implements them):

  - stage 1 of each block: the dosages g (m x N) times the probe side
    [z | Uz | ỹ] once per genotype component (V = the Layout's
    components: an environment variant of the probe side, or a form of
    the dosages): 2 m N Bp V useful flops (the mask column and the
    split's second half are not useful); bytes: the 2-bit genotypes, the
    probe side and the (m, Bp V) result;
  - stage 2 of each block: per bin, the bin's standardized rows times
    their stage-1 rows, for each genotype component: 2 N b2 V nnz useful
    flops, nnz the block's annotation entries (the products a bin's SNPs
    make; a one-hot annotation has one per SNP); bytes: the 2-bit
    genotypes, the (m, b2 V) operand and the (V K b2, N) float32 stats;
  - both stages once per block, twice for the blocks pass 2 computes
    again (all of them streaming, those past the cache hybrid);
  - pass 2, for each of the J + 1 samples: the inner products of the E
    components' stats over N x B (one per pair, E (E+1)/2), the
    covariate projections C'XXz and C'XXUz, and the border products with
    z and Uz; bytes: the (E, N, b2) float32 stats read once.

The bound is max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) over the
estimate's totals. The useful-flop convention (no mask column, no split
half) is the one of pyrhe_tpu_torch/bench/matvec.py's
useful_flops_per_block, copied here with stage 2 counted per bin.
"""
from __future__ import annotations

import numpy as np

from .layout import layout

HBM_BPS, PEAK_BF16 = 3.35e12, 989e12
F32 = 4


def estimate_work(config: dict, traffic: dict, annot: np.ndarray) -> dict:
    """{"flops", "bytes", "least_s"} of one estimate of the cell."""
    N, M, J = config["num_indiv"], config["num_snp"], config["num_jack"]
    K, B = config["num_bin"], config["num_random_vec"]
    T = traffic["traits_per_request"]
    cov = config["num_cov"] > 0
    b2 = B * (2 if cov else 1)
    lay = layout(config)
    V, E = len(lay.components), lay.E
    Bp = b2 + T
    # blocks whose stage products pass 2 computes again
    again = {"streaming": J, "cached": 0,
             "hybrid": J - traffic.get("cache_blocks", J)}[traffic["mode"]]
    step = M // J
    flops = nbytes = 0.0
    for j in range(J):
        s, e = j * step, ((j + 1) * step if j < J - 1 else M)
        m = e - s
        nnz = float(np.count_nonzero(annot[s:e]))
        words = m * N / 4
        passes = 2 if j >= J - again else 1
        flops += passes * (2.0 * m * N * Bp * V + 2.0 * N * b2 * V * nnz)
        nbytes += passes * (words + N * Bp * V * F32 + m * Bp * V * F32
                            + words + m * b2 * V * F32 + V * K * b2 * N * F32)
    pairs = E * (E + 1) / 2
    per_sample = 2.0 * N * B * (pairs + 2 * E)
    if cov:
        per_sample += 2.0 * 2 * E * N * config["num_cov"] * B
    flops += (J + 1) * per_sample
    nbytes += (J + 1) * E * N * b2 * F32
    return {"flops": flops, "bytes": nbytes,
            "least_s": max(flops / PEAK_BF16, nbytes / HBM_BPS)}
