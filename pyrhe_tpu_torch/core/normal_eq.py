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

The covariate-projected stats UXXz = C Q C^T XXz are DERIVED here by
linearity instead of being accumulated per block like the reference
(base.py:407-412) — projection commutes with the leave-one-out sums.

Every length-N contraction is multiply + reduce, never a matrix product:
a product's reduced-precision accumulation is catastrophic for these
positive quadratic forms (the reference measured ~1.5e-7 relative error
from dot lowering on CPU float64). Only the tiny length-ncov contractions
use einsum.
"""
from __future__ import annotations

import torch


def _gram(A, B):
    """(E, N, B), (F, N, B) -> (E, F) pairwise inner products via
    multiply+reduce, one row of A at a time."""
    return torch.stack([torch.sum(a[None, :, :] * B, dim=(1, 2)) for a in A])


def _dotvec(A, V):
    """(E, N, B), (N, B) -> (E,) accurate inner products."""
    return torch.sum(A * V[None, :, :], dim=(1, 2))


def project_cov(C, Q, XXz):
    """C Q C^T applied to each (N, B) slice of XXz (E, N, B).

    The length-N contraction uses multiply+reduce (see _gram); the tiny
    length-ncov contractions use einsum."""
    t = torch.stack([torch.sum(C[:, :, None] * x[:, None, :], dim=0)
                     for x in XXz])                   # (E, ncov, B)
    t = torch.einsum("cd,edb->ecb", Q, t)
    return torch.einsum("nc,ecb->enb", C, t)


def assemble_Tq_core(
    XXP,          # (E, N, b2) leave-one-out moment stats
    yXXy,         # (E, T) leave-one-out quadratic forms
    M,            # (E,) leave-one-out SNP counts
    Z,            # (N, B) probes
    Uzb,          # (N, B) projected probes, or zeros when no covariates
    C,            # (N, ncov) covariates or None
    Q,            # (ncov, ncov) pinv(C^T C) or None
    q_last,       # (T,) y~^T y~ per trait
    stoch_mask,   # (E,) bool: stochastic border-trace rows (GxE/NxE)
    *,
    num_random_vec: int,
    n_indiv: int,
    n_cov: int,
):
    B = num_random_vec
    dtype = XXP.dtype
    XXz = XXP[:, :, :B]

    G1 = _gram(XXz, XXz)
    if C is not None:
        XXUz = XXP[:, :, B:]
        UXXz = project_cov(C, Q, XXz)
        G2 = _gram(UXXz, XXz)
        G3 = _gram(XXUz, UXXz)
        raw = G1 + G3 - 2.0 * G2
    else:
        raw = G1

    Mf = M.to(dtype)
    MM = Mf[:, None] * Mf[None, :]
    T_top = torch.where(MM != 0,
                        raw / B / torch.where(MM == 0, 1.0, MM), 0.0)

    Msafe = torch.where(Mf == 0, 1.0, Mf)
    zdot = _dotvec(XXz, Z) / (B * Msafe)
    btr = torch.where(stoch_mask, zdot,
                      torch.tensor(float(n_indiv), dtype=dtype,
                                   device=XXP.device))
    if C is not None:
        btr = btr - _dotvec(XXz, Uzb) / (B * Msafe)

    corner = torch.tensor([[float(n_indiv - n_cov)]], dtype=dtype,
                          device=XXP.device)
    T = torch.cat([
        torch.cat([T_top, btr[:, None]], dim=1),
        torch.cat([btr[None, :], corner], dim=1),
    ], dim=0)

    q_top = torch.where(Mf[:, None] != 0, yXXy / Msafe[:, None], 0.0)
    q = torch.cat([q_top, q_last[None, :].to(dtype)], dim=0)
    return T, q
