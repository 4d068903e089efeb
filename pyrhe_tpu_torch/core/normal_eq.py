"""Per-jackknife-sample normal-equation assembly (device-side).

Port of pyrhe_tpu/core/normal_eq.py (`assemble_Tq_core`). Builds the
(E+1, E+1) LHS T and (E+1, T_traits) RHS q of the method-of-moments
system from leave-one-out moment statistics; the engine calls it once per
jackknife sample.

Behavioral spec: reference base.py:568-628 (setup_lhs_rhs_jackknife):
  T[k,l] = [<XXz_k, XXz_l> + <XXUz_k, UXXz_l> - 2 <proj XXz_k, XXz_l>]
             / num_random_vec / (M_k * M_l)      (0 when M_k*M_l == 0)
  T[k,E] = b_tr(k) - <XXz_k, Uzb> / (B * M_k)    (the subtraction only
             with covariates; b_tr is N for standardized genotype
             components, stochastic for GxE/NxE rows, genie.py:84-94)
  T[E,E] = N - #cov
  q[k]   = yXXy_k / M_k;  q[E] = y~^T y~

The covariate-projected stats UXXz = C Q C^T XXz are never built: with
P = C^T XXz and R = C^T XXUz (E, ncov, B) and Q symmetric,
  <proj XXz_k, XXz_l> = sum_b P_k[:, b]^T Q P_l[:, b]   (G2)
  <XXUz_k, UXXz_l>    = sum_b R_k[:, b]^T Q P_l[:, b]   (G3),
exact in algebra, so every length-N contraction of a sample (the Gram G1,
P, R and the two border products) is one pass over its stats:
ops/kernels.sample_contract, one kernel launch on the card, and its plain
multiply+reduce version on the CPU. The stats arrive as the engine holds
them, (E_geno, b2, N) totals less the left-out block, NxE rows apart.

Accuracy. A length-N contraction is never a matrix product on the tensor
cores (TF32 or bf16 would round the f32 stats; the reference measured
~1.5e-7 relative error from dot lowering on CPU float64, catastrophic for
these positive quadratic forms). The kernel forms products and sums in the
stats' dtype over runs of at most 256 terms and adds the runs in float64,
where the former float32 torch.sum rounded each product and accumulated
all N * B of them in float32: its error is no larger. The sums leave it in
float64, and G2, G3, G1 + G3 - 2 G2 (which cancels when XXz lies mostly in
span(C)) and T are formed in float64 from them, then cast to the stats'
dtype as before; q keeps its float32 arithmetic. The length-ncov and
ncov * B contractions of covariate space use einsum and multiply+reduce.
"""
from __future__ import annotations

import torch

from ..ops.kernels import sample_contract
from ..utils.trace import span


def assemble_Tq_core(
    X,            # (E_geno, b2, N) pass-1 totals (or a sample's stats)
    drop,         # (E_geno, b2, N) the left-out block's stats, or None
    nxe,          # (num_nxe, b2, N) NxE rows appended to X, or None
    yXXy,         # (E, T) leave-one-out quadratic forms
    M,            # (E,) leave-one-out SNP counts
    Zt,           # (B, N) probes, transposed
    Ut,           # (B, N) projected probes, transposed, or None
    Ct,           # (ncov, N) covariates, transposed, or None
    Q,            # (ncov, ncov) pinv(C^T C) or None
    q_last,       # (T,) y~^T y~ per trait
    stoch_mask,   # (E,) bool: stochastic border-trace rows (GxE/NxE)
    *,
    num_random_vec: int,
    n_indiv: int,
    n_cov: int,
):
    """(T, q) of the sample whose stats are X - drop with nxe appended (the
    reference's XXP (E, N, b2) transposed); T and q in X's dtype. The
    contractions run in a `pyrhe.sample_contract` span, G2 and G3 in
    `pyrhe.cov_gram`."""
    B = num_random_vec
    dtype = X.dtype
    f64 = torch.float64
    with span("sample_contract"):
        G1, P, R, zd, ud = sample_contract(X, drop, nxe, Ct, Zt, Ut, B=B)
    if Ct is not None:
        with span("cov_gram"):
            QP = torch.einsum("cd,fdb->fcb", Q.to(f64), P)
            G2 = torch.sum(P[:, None] * QP[None], dim=(2, 3))
            G3 = torch.sum(R[:, None] * QP[None], dim=(2, 3))
        raw = G1 + G3 - 2.0 * G2
    else:
        raw = G1

    Mf = M.to(f64)
    MM = Mf[:, None] * Mf[None, :]
    T_top = torch.where(MM != 0,
                        raw / B / torch.where(MM == 0, 1.0, MM), 0.0)

    Msafe = torch.where(Mf == 0, 1.0, Mf)
    btr = torch.where(stoch_mask, zd / (B * Msafe), float(n_indiv))
    if Ct is not None:
        btr = btr - ud / (B * Msafe)

    corner = T_top.new_full((1, 1), float(n_indiv - n_cov))
    T = torch.cat([
        torch.cat([T_top, btr[:, None]], dim=1),
        torch.cat([btr[None, :], corner], dim=1),
    ], dim=0).to(dtype)

    Mq = M.to(dtype)
    q_top = torch.where(Mq[:, None] != 0,
                        yXXy / torch.where(Mq == 0, 1.0, Mq)[:, None], 0.0)
    q = torch.cat([q_top, q_last[None, :].to(dtype)], dim=0)
    return T, q
