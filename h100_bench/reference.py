"""Plain reference of the estimate the benchmark times, for any model
with a file under models/ (layout.py): the variance components as its
Layout lists them, the rows as its `rows` and `analytic_rows` give them.

Plain PyTorch and NumPy, in float64, written from the method (randomized
Haseman-Elston regression, PyRHE's base.py normal equations) and not from
the port: it imports nothing of `pyrhe_tpu_torch` and takes none
of its arrays. From the raw inputs (the .bed, the annotation, covariates,
environments, phenotypes and the seed) it works out again everything the
port derives:

  - the probes z_b: `np.random.RandomState(seed).randn(N, B)`, the draw a
    PyRHE run with that seed makes (no other draw precedes it when the
    annotation comes from a file), and their covariate projection
    U z_b = C (C'C)^+ C' z_b;
  - the missing genotypes' HWE fills: per jackknife block the generator is
    reseeded with `seed` and draws one uniform per SNP; the fill is 0, 1
    or 2 by the HWE genotype frequencies at the observed allele frequency;
  - standardization x = (g - mean) / sqrt(mean (1 - mean / 2)) over the
    filled dosages (0 where the variance is 0);
    (the model file's `rows` start from the raw dosages and call
    `standardized` for the rows that need it);
  - per bin k and genotype component c, r_s the rows the model gives c:
    XXP = Σ_{s in k} r_s (r_s' [z | Uz]) and yXXy = Σ_{s in k} (r_s' ỹ)²,
    ỹ the covariate-residualized phenotype; the model's analytic rows
    (M = 1) as its `analytic_rows` computes them;
  - leave-one-block-out sums, the (E+1) x (E+1) normal equations
      T[k,l] = (<XXz_k, XXz_l> + <XXUz_k, UXXz_l> - 2 <UXXz_k, XXz_l>)
               / (B M_k M_l)
      T[k,E] = tr_k - <XXz_k, Uz> / (B M_k), tr_k = N, or
               <XXz_k, z> / (B M_k) for the rows the Layout marks
               stochastic,
      T[E,E] = N - #covariates, q[k] = yXXy_k / M_k, q[E] = ỹ'ỹ
    and sigma² = T^-1 q for the full sample and every leave-one-out one.

`precision="tf32"` is the control of the benchmark's comparison: the same
computation in float32 with every matrix product's operands rounded to
TF32 (10 mantissa bits, as the H100's tensor cores take float32 with TF32
on; explicitly, so that the CPU computes the same), the step below the
float32 the configurations state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layout import Layout

MAGIC = bytes([0x6C, 0x1B, 0x01])
# 2-bit .bed codes 00, 01, 10, 11 are dosages 0, missing (-1 here), 1, 2


@dataclass
class Problem:
    """The raw inputs of one estimate, as the benchmark made them."""
    bed_path: str
    num_indiv: int
    num_snp: int
    annot: np.ndarray            # (M, K) 0/1
    cov: np.ndarray | None       # (N, C)
    env: np.ndarray | None       # (N, num_env)
    model: object                # the configuration's model file
    layout: Layout               # its variance components
    num_random_vec: int
    num_jack: int
    seed: int


def read_packed(path: str, num_indiv: int, num_snp: int, device,
                chunk_snps: int = 8192):
    """Yield (s0, s1, (s1 - s0, ceil(N/4)) uint8 tensor on device) over
    the .bed, chunk by chunk, through one reused host buffer."""
    bps = (num_indiv + 3) // 4
    with open(path, "rb") as f:
        if f.read(3) != MAGIC:
            raise ValueError(f"{path}: not a SNP-major .bed")
        buf = np.empty(chunk_snps * bps, dtype=np.uint8)
        for s0 in range(0, num_snp, chunk_snps):
            s1 = min(s0 + chunk_snps, num_snp)
            view = buf[:(s1 - s0) * bps]
            if f.readinto(memoryview(view)) != view.size:
                raise ValueError(f"{path}: truncated")
            yield s0, s1, torch.from_numpy(view).to(device).view(s1 - s0, bps)


def load_packed(path: str, num_indiv: int, num_snp: int, device):
    """The whole .bed as one (M, ceil(N/4)) uint8 tensor on device."""
    return torch.cat([t.clone() for _, _, t in
                      read_packed(path, num_indiv, num_snp, device)])


def decode(packed: torch.Tensor, num_indiv: int) -> torch.Tensor:
    """(m, ceil(N/4)) packed bytes -> (m, N) int8 dosages, -1 = missing."""
    shifts = torch.arange(0, 8, 2, device=packed.device, dtype=torch.uint8)
    c = (((packed[:, :, None] >> shifts) & 3)
         .reshape(packed.shape[0], -1)[:, :num_indiv].to(torch.int8))
    return torch.where(c == 1, -1, torch.where(c == 0, 0, c - 1)).to(
        torch.int8)


def hwe_fills(sums: np.ndarray, nmiss: np.ndarray, n: int,
              seed: int) -> np.ndarray:
    """Integral HWE fills of one block's SNPs from the observed dosage
    sums and missing counts."""
    n_obs = n - nmiss
    p = np.divide(sums, n_obs, out=np.zeros_like(sums),
                  where=n_obs > 0) * 0.5
    r = np.random.RandomState(seed).random_sample(len(sums))
    hom = (1 - p) ** 2
    het = 2 * p * (1 - p)
    return np.where(r < hom, 0.0, np.where(r < hom + het, 1.0, 2.0))


def standardized(dos: torch.Tensor, seed: int, dtype) -> torch.Tensor:
    """(m, N) int8 dosages with missing calls -> standardized (m, N)."""
    n = dos.shape[1]
    miss = dos < 0
    g = dos.clamp(min=0).to(torch.float64)
    fills = hwe_fills(g.sum(1).cpu().numpy(), miss.sum(1).cpu().numpy(), n,
                      seed)
    g = torch.where(miss, torch.as_tensor(fills, device=g.device)[:, None],
                    g)
    mean = g.sum(1) / n
    var = mean * (1 - 0.5 * mean)
    d = torch.where(var > 0, 1 / torch.sqrt(var.clamp(min=1e-30)), 0.0)
    return (d[:, None] * (g - mean[:, None])).to(dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Math:
    """Matrix products and the working dtype of one precision."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        return _tf32(a) @ _tf32(b) if self.tf32 else a @ b


def block_stats(rows, annot, P, Y, math):
    """Per-bin stats of one block from each genotype component's rows:
    XXP (n_comp*K, N, b2), yXXy (n_comp*K, R)."""
    out_X, out_y = [], []
    for Xc in rows:
        U = math.mm(Xc, P)                          # (m, b2)
        V = math.mm(Xc, Y)                          # (m, R)
        for k in range(annot.shape[1]):
            rows = torch.nonzero(annot[:, k]).flatten()
            w = annot[rows, k][:, None]
            out_X.append(math.mm(Xc[rows].T, U[rows] * w))
            out_y.append((V[rows] ** 2 * w).sum(0))
    return torch.stack(out_X), torch.stack(out_y)


def normal_equations(XXP, yXXy, M, Z, Uz, C, Q, stoch, n, qlast, math):
    """(T (E+1, E+1), q (E+1, R)) of one sample from its stats."""
    E, B = XXP.shape[0], Z.shape[1]
    XXz = XXP[..., :B]
    flat = XXz.reshape(E, -1)
    raw = math.mm(flat, flat.T)
    if C is not None:
        Ct = torch.einsum("nc,enb->ecb", C, XXz)
        CtU = torch.einsum("nc,enb->ecb", C, XXP[..., B:])
        raw = (raw + torch.einsum("kcb,cd,ldb->kl", CtU, Q, Ct)
               - 2 * torch.einsum("kcb,cd,ldb->kl", Ct, Q, Ct))
    Mf = M.to(XXP.dtype)
    MM = Mf[:, None] * Mf[None, :]
    top = torch.where(MM != 0, raw / B / torch.where(MM == 0, 1.0, MM), 0.0)
    Ms = torch.where(Mf == 0, 1.0, Mf)
    tr = torch.where(stoch, (XXz * Z).sum((1, 2)) / (B * Ms),
                     torch.full_like(Mf, float(n)))
    ncov = 0
    if C is not None:
        tr = tr - (XXz * Uz).sum((1, 2)) / (B * Ms)
        ncov = C.shape[1]
    T = torch.zeros((E + 1, E + 1), dtype=torch.float64)
    T[:E, :E] = top.double().cpu()
    T[:E, E] = T[E, :E] = tr.double().cpu()
    T[E, E] = n - ncov
    q = torch.cat([torch.where(Mf[:, None] != 0, yXXy / Ms[:, None], 0.0),
                   qlast[None, :]]).double().cpu()
    return T.numpy(), q.numpy()


def estimate(prob: Problem, pheno: np.ndarray, device="cpu",
             precision: str = "float64", packed=None) -> np.ndarray:
    """sigma² (R, J+1, E+1) of each phenotype column of `pheno` (N, R),
    centered: rows 0..J-1 leave block j out, row J is the full sample.
    `packed` may hold the .bed already on device (load_packed)."""
    math = _Math(precision)
    dt, dev = math.dtype, torch.device(device)
    n, J, B = prob.num_indiv, prob.num_jack, prob.num_random_vec
    lay = prob.layout
    comps, E_geno, E = lay.components, lay.E_geno, lay.E

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    Z = np.random.RandomState(prob.seed).randn(n, B)
    Y = np.asarray(pheno, np.float64)
    C = Q = Uz = None
    if prob.cov is not None:
        C = np.asarray(prob.cov, np.float64)
        Q = np.linalg.pinv(C.T @ C)
        Uz = C @ (Q @ (C.T @ Z))
        Y = Y - C @ (Q @ (C.T @ Y))
    P = t(np.concatenate([Z, Uz], axis=1) if C is not None else Z)
    Zt, Yt = t(Z), t(Y)
    Uzt = t(Uz) if C is not None else None
    Ct = t(C) if C is not None else None
    Qt = t(Q) if C is not None else None
    env = t(prob.env) if prob.env is not None else None
    annot = t(prob.annot)
    qlast = (Yt * Yt).sum(0)
    if packed is None:
        packed = load_packed(prob.bed_path, n, prob.num_snp, dev)

    step = prob.num_snp // J
    bounds = [(j * step, (j + 1) * step if j < J - 1 else prob.num_snp)
              for j in range(J)]

    def stats(j):
        s, e = bounds[j]
        rows = prob.model.rows(lay, decode(packed[s:e], n), prob.seed, env,
                               dt)
        return block_stats(rows, annot[s:e], P, Yt, math)

    tot_X = tot_y = None
    for j in range(J):
        bX, by = stats(j)
        tot_X = bX if tot_X is None else tot_X + bX
        tot_y = by if tot_y is None else tot_y + by
    stoch = torch.as_tensor(lay.stochastic, device=dev)
    an_X = an_y = None
    if lay.num_analytic:
        an_X, an_y = prob.model.analytic_rows(env, P, Yt)
    len_bin = prob.annot.sum(0).astype(np.int64)
    m_full = np.concatenate([np.tile(len_bin, len(comps)),
                             np.ones(lay.num_analytic, np.int64)])

    def sample(X, y, counts):
        if an_X is not None:
            X = torch.cat([X, an_X])
            y = torch.cat([y, an_y])
        M = torch.as_tensor(counts, device=dev)
        return normal_equations(X, y, M, Zt, Uzt, Ct, Qt, stoch, n, qlast,
                                math)

    systems = []
    for j in range(J):
        s, e = bounds[j]
        bX, by = stats(j)
        counts = m_full.copy()
        counts[:E_geno] -= np.tile(prob.annot[s:e].sum(0), len(comps))
        systems.append(sample(tot_X - bX, tot_y - by, counts))
    systems.append(sample(tot_X, tot_y, m_full))
    R = Y.shape[1]
    sigma = np.zeros((R, J + 1, E + 1))
    for j, (T, q) in enumerate(systems):
        sigma[:, j, :] = np.linalg.solve(T, q).T
    return sigma


def pheno_variance(prob: Problem, pheno: np.ndarray) -> np.ndarray:
    """ỹ'ỹ / N of each phenotype column: the scale the benchmark measures
    a sigma² gap against."""
    Y = np.asarray(pheno, np.float64)
    if prob.cov is not None:
        C = np.asarray(prob.cov, np.float64)
        Y = Y - C @ (np.linalg.pinv(C.T @ C) @ (C.T @ Y))
    return (Y * Y).sum(0) / prob.num_indiv
