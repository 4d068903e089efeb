"""Small-matrix estimation: solves, jackknife SEs, h2, enrichment, liability.

These run replicated on host in float64 (the (E+1)^2 systems are tiny; the
reference does the same in numpy/scipy, base.py:298-312,630-868). All
jackknife loops are vectorized over the J+1 samples.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg


def solve_all(T_all: np.ndarray, q_all: np.ndarray, method: str = "QR"):
    """Solve T_j sigma_j = q_j for every jackknife sample.

    T_all: (J+1, E+1, E+1), q_all: (J+1, E+1). Returns sigma (J+1, E+1).
    method "QR" mirrors reference base.py:306-312 (scipy QR + triangular
    solve); "lstsq" mirrors base.py:298-303.
    """
    out = np.zeros_like(q_all)
    for j in range(T_all.shape[0]):
        if method == "lstsq":
            out[j] = np.linalg.lstsq(T_all[j], q_all[j][:, None], rcond=None)[0][:, 0]
        elif method == "QR":
            Qm, R = scipy.linalg.qr(T_all[j])
            out[j] = scipy.linalg.solve_triangular(
                R, Qm.T @ q_all[j][:, None])[:, 0]
        else:
            raise ValueError("Unsupported method for solving linear equation")
    return out


def jackknife_se(ests: np.ndarray, num_jack: int) -> np.ndarray:
    """SE = sqrt((J-1)/J * sum_j (est_j - mean)^2) per column
    (reference base.py:680-703)."""
    mean = ests.mean(axis=0)
    sq = ((ests - mean) ** 2).sum(axis=0)
    return np.sqrt((num_jack - 1) * sq / num_jack)


def h2_nonoverlapping(sigma: np.ndarray) -> np.ndarray:
    """sigma: (J+1, E+1) -> h2 (J+1, E+1): per-bin h2_k then total h_SNP^2
    (reference base.py:705-742)."""
    total = sigma[:, :-1].sum(axis=1, keepdims=True)
    denom = total + sigma[:, -1:]
    h2 = sigma[:, :-1] / denom
    return np.concatenate([h2, total / denom], axis=1)


def h2_overlapping(
    sigma: np.ndarray,       # (J+1, E+1)
    annot: np.ndarray,       # (M, K)
    M_mat: np.ndarray,       # (J+1, E)
    num_jack: int,
) -> np.ndarray:
    """Overlapping-annotation h2 (reference base.py:744-785) vectorized:

    h2_j[k] = sum_{snp in bin k, snp not in block j} sum_{b in bins(snp)}
              sigma_j[b]/M_j[b]  / (total + sigma_e)
            = (C_j @ w_j)[k] / denom with C_j the K x K LOO annot-overlap
    count matrix. Replicates the reference's j == J quirk where the
    "total" sample excludes the remainder SNPs (base.py:382-393 with
    jack_index == num_jack, slice clipped at M).
    """
    num_snp, K = annot.shape
    step = num_snp // num_jack
    rem = num_snp % num_jack
    C_total = annot.T @ annot  # (K, K)

    J1 = sigma.shape[0]
    h2 = np.zeros((J1, K + 1))
    total = sigma[:, :-1].sum(axis=1)
    denom = total + sigma[:, -1]
    for j in range(J1):
        if j < num_jack - 1:
            s, e = j * step, (j + 1) * step
        elif j == num_jack - 1:
            s, e = j * step, num_snp
        else:  # j == num_jack: reference masks [J*step, J*step+step+rem) clipped
            s, e = num_jack * step, min(num_jack * step + step + rem, num_snp)
        blk = annot[s:e]
        C_j = C_total - blk.T @ blk
        Mj = M_mat[j, :K].astype(np.float64)
        w = np.where(Mj != 0, sigma[j, :K] / np.where(Mj == 0, 1, Mj), 0.0)
        h2[j, :K] = (C_j @ w) / denom[j]
    h2[:, K] = total / denom
    return h2


def enrichment(h2: np.ndarray, M_mat: np.ndarray) -> np.ndarray:
    """e_k = (h2_k / h2_SNP) / (M_k / sum(M)) (reference base.py:788-825).
    h2: (J+1, E+1) with total in last col; M_mat: (J+1, E)."""
    E = M_mat.shape[1]
    Mf = M_mat.astype(np.float64)
    Msum = Mf.sum(axis=1, keepdims=True)
    h_snp = h2[:, -1:]
    frac_h = np.divide(h2[:, :E], h_snp, out=np.zeros((h2.shape[0], E)),
                       where=h_snp != 0)
    frac_m = np.divide(Mf, Msum, out=np.ones_like(Mf), where=Msum != 0)
    ok = (Msum != 0) & (Mf != 0)
    return np.where(ok, np.divide(frac_h, frac_m,
                                  out=np.zeros_like(frac_h),
                                  where=frac_m != 0), 0.0)


def liability_h2(h2, seh2, pop_prev, samp_prev):
    """Observed- to liability-scale conversion + chi2 p-value
    (reference base.py:857-868)."""
    from scipy.stats import chi2, norm

    K, P = pop_prev, samp_prev
    zv = norm.pdf(norm.ppf(K))
    scale = K ** 2 * (1 - K) ** 2 / P / (1 - P) / zv ** 2
    h2_liab = h2 * scale
    var_h2_liab = (seh2 * scale) ** 2
    p_liab = chi2.sf(h2_liab ** 2 / var_h2_liab, 1)
    return h2_liab, var_h2_liab ** 0.5, p_liab


def calc_lsum(tr, n, m1, m2):
    """SUMRHE LD-sum transform (reference base.py:827-829)."""
    return (tr - n) * (m1 * m2) / pow(n, 2)


def genie_h2_nonoverlapping(sigma_adj: np.ndarray, num_bin: int,
                            num_gen_env_bin: int, num_env: int,
                            genie_model: str) -> np.ndarray:
    """GENIE h2 on trace-adjusted sigmas with component totals appended
    (reference genie.py:146-189). Columns: per-estimate h2, then
    [total_h2, total_h2_g, (total_h2_gxe)]."""
    total_var = sigma_adj[:, :-1].sum(axis=1, keepdims=True)
    denom = total_var + sigma_adj[:, -1:]
    h2 = sigma_adj[:, :-1] / denom
    g_total = h2[:, :num_bin].sum(axis=1, keepdims=True)
    cols = [h2]
    gxe_total = np.zeros_like(g_total)
    if genie_model in ("G+GxE", "G+GxE+NxE"):
        gxe_total = h2[:, num_bin:num_bin + num_gen_env_bin].sum(
            axis=1, keepdims=True)
    nxe_total = np.zeros_like(g_total)
    if genie_model == "G+GxE+NxE":
        nxe_total = h2[:, num_bin + num_gen_env_bin:
                       num_bin + num_gen_env_bin + num_env].sum(
            axis=1, keepdims=True)
    cols.append(g_total + gxe_total + nxe_total)  # total h2
    cols.append(g_total)
    if genie_model in ("G+GxE", "G+GxE+NxE"):
        cols.append(gxe_total)
    return np.concatenate(cols, axis=1)


def genie_enrichment(h2_jack: np.ndarray, h2_total: np.ndarray,
                     M_mat: np.ndarray, num_bin: int) -> np.ndarray:
    """GENIE enrichment over genetic bins only, using total-row M
    (reference genie.py:191-219, including its use of M[-1] for every
    jackknife sample)."""
    M_last = M_mat[-1, :num_bin].astype(np.float64)
    h2 = np.vstack([h2_jack, h2_total[None, :]])
    out = np.zeros((h2.shape[0], num_bin))
    total_snps = M_last.sum()
    for j in range(h2.shape[0]):
        total_h2 = h2[j, :num_bin].sum()
        denom = total_h2 / total_snps
        out[j] = (h2[j, :num_bin] / M_last) / denom
    return out
