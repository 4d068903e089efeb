"""Fused per-block randomized-moment computation — the hot path.

Port of pyrhe_tpu/ops/moments.py for the kernel path (the reference's
`mm2_t` branch of `_moment_algebra`, `block_stats_pallas_core`,
`block_stats_pallas_acc_core` and `acc_scan_stats`), for additive (RHE,
GxE) and dominance (RHE-DOM) components, and GENIE's analytic NxE stats
(`nxe_stats`). For one jackknife block of m SNPs every statistic comes
from products over the decoded dosages g:

    GP  = g  @ [mask | P | env_e ⊙ P ...]      stage 1, ops/kernels.gp_matmul
    XXG = Yᵀ @ g                                stage 2, ops/kernels.ytg_matmul

Standardization S = D(g - mean ⊗ 1) folds into rank-1 corrections around
the products, and the leading mask column of stage 1 makes the column
sums, hence means and variances, free byproducts. The dominance encoding
is affine in (g, g²): enc = (mean + 1) ⊙ g − g², so dominance adds one g²
product per stage (`square=True`: G2P = g² @ C_all, XXG2 = Y2ᵀ @ g²); the
aliased core takes both of its stage-2 products in one launch
(ops/kernels.ytg_acc2_matmul).

Precision: dosages are exact in bf16, so only the probe side limits
accuracy. split=True (split2, the float32 mode on the card) splits the
probe-side operand into bf16 hi + lo halves stacked side by side (stage 1)
or on rows (stage 2) and sums the two halves of the f32 result;
split=False (the CPU) runs the products in f32. The working dtype is
float32.

Inputs follow the kernels' layout contract: N-indexed arrays are padded
to n_pad and plane-permuted (ops/kernels.plane_permutation), SNP rows are
padded to m_pad with zero annot rows; padded and filtered individuals are
zeroed by `valid_mask`.

The standard core and the aliased (acc) core share `_prepare` — stage 1,
the standardization scalars, the U rows and the stage-2 operands — so the
acc path's bit-identity with the standard path cannot drift.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import (gp_matmul, sum_halves, ytg_acc2_matmul, ytg_acc_matmul,
                      ytg_matmul)


def _colsum(x):
    """Accurate reduction (mul+reduce, not a product — see normal_eq._gram)."""
    return torch.sum(x, dim=0)


def _hilo(R32, dim):
    """split2 operand prep: hi/lo bf16 halves packed side by side, so the
    f32-accuracy path costs ONE product over a doubled operand."""
    hi = R32.to(torch.bfloat16)
    lo = (R32 - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=dim)


def _add_scale(mean):
    """Additive scale 1/sqrt(2p(1-p)) from the column mean (= 2p)."""
    var_add = mean * (1.0 - 0.5 * mean)
    return torch.where(var_add > 0,
                       torch.rsqrt(torch.clamp(var_add, min=1e-30)), 0.0)


def _dom_scales(mean, mean2):
    """Dominance-encoding scalars (reference rhe_dom.py:15-41): scale
    1/(2·maf·(1−maf)), alpha with enc = alpha·g − g², and the encoded
    column mean."""
    maf = mean / 2.0
    denom = 2.0 * maf * (1.0 - maf)
    d_dom = torch.where(denom > 0, 1.0 / torch.clamp(denom, min=1e-30), 0.0)
    alpha = mean + 1.0
    mean_enc = alpha * mean - mean2
    return d_dom, alpha, mean_enc


def _u_add(d_add, mean, GPr, s_r):
    """Standardized-X'P rows for an additive component via the rank-1
    fold (module docstring)."""
    return d_add[:, None] * (GPr - mean[:, None] * s_r[None, :])


def _u_dom(d_dom, alpha, mean_enc, GPr, G2Pr, s_r):
    """Standardized-X'P rows for a dominance component: the encoding is
    affine in (g, g²)."""
    return d_dom[:, None] * (alpha[:, None] * GPr - G2Pr
                             - mean_enc[:, None] * s_r[None, :])


def _stage1_cols(components, P, env, mask_col):
    """Stage-1 right operand [mask | P per env VARIANT]: the leading
    column makes column sums — hence means/variances — free byproducts of
    the first product. Returns (variants, C_all)."""
    variants = []
    for _, eidx in components:
        if eidx not in variants:
            variants.append(eidx)
    cols = [mask_col]
    for v in variants:
        cols.append(P if v is None else P * env[:, v][:, None].to(P.dtype))
    return variants, torch.cat(cols, dim=1)


def _component_stats(kind, U, annot_f, b2, d, mean_stat, alpha=None):
    """Per-component yXXy entry and stage-2 operands from the U rows.
    Returns (ys (K, T), Y_g (m, K*b2), Y_g2, rank1 (K*b2,)): Y_g rides the
    g product, Y_g2 (dominance only, else None) the g² one; rank1 is the
    standardization fold's correction row."""
    m, K = annot_f.shape
    Uy = U[:, b2:]
    ys = torch.sum((Uy * Uy)[:, None, :] * annot_f[:, :, None], dim=0)
    W = (U[:, None, :b2] * annot_f[:, :, None]).reshape(m, K * b2)
    Yd = d[:, None] * W
    rank1 = torch.sum(mean_stat[:, None] * Yd, dim=0)
    if kind == "add":
        return ys, Yd, None, rank1
    return ys, alpha[:, None] * Yd, -Yd, rank1


def _stage1(words, C_all, split, square=False):
    """GP = g @ C_all (g² @ C_all when square, f32), through ONE
    gp_matmul launch."""
    C32 = C_all.float()
    if split:
        out = gp_matmul(words, _hilo(C32, 1).contiguous(), square)
        W = C_all.shape[1]
        return out[:, :W] + out[:, W:]
    return gp_matmul(words, C32.contiguous(), square)


def _prep_yt(Y, split):
    """(m_pad, Q) stage-2 operand -> the kernels' (Qr, m_pad) Yt: hi/lo
    bf16 halves stacked on rows when split, else f32."""
    Yt = Y.float().T
    return (_hilo(Yt, 0) if split else Yt).contiguous()


def _check_components(components):
    """Fail loudly on a component no epilogue handles: an unknown kind, or
    an env-scaled dominance component (no model builds one; the dominance
    epilogue applies no env scale)."""
    for kind, eidx in components:
        if not (kind == "add" or (kind == "dom" and eidx is None)):
            raise ValueError(f"unsupported component {(kind, eidx)!r} in "
                             f"{components!r}: kinds are 'add' (any env) "
                             "and 'dom' (no env)")


class _Comp(NamedTuple):
    """One component's yXXy entry and stage-2 operands (_prepare)."""
    kind: str                   # "add" | "dom"
    ys: torch.Tensor            # (K, T)
    Y: torch.Tensor             # (m_pad, K*b2), rides the g product
    Y2: torch.Tensor | None     # (m_pad, K*b2), rides the g² one (dom)
    rank1: torch.Tensor         # (K*b2,)
    eidx: int | None            # env column scaling the stats, or None


def _prepare(words, annot_f, P_perm, env_perm, valid_mask, *, n_indiv,
             components, b2, split):
    """Stage 1 + standardization algebra + per-component stage-2
    operands, shared by both cores. Returns one _Comp per component."""
    _check_components(components)
    Bp = P_perm.shape[1]
    variants, C_all = _stage1_cols(components, P_perm, env_perm,
                                   valid_mask[:, None])
    csum = _colsum(C_all)
    GP = _stage1(words, C_all, split)                # (m_pad, 1 + Bp*V)
    mean = GP[:, 0] / n_indiv
    d_add = _add_scale(mean)
    if any(kind == "dom" for kind, _ in components):
        G2P = _stage1(words, C_all, split, square=True)
        d_dom, alpha, mean_enc = _dom_scales(mean, G2P[:, 0] / n_indiv)
    out = []
    for kind, eidx in components:
        v = variants.index(eidx)
        sl = slice(1 + v * Bp, 1 + (v + 1) * Bp)
        if kind == "add":
            U = _u_add(d_add, mean, GP[:, sl], csum[sl])
            stats = _component_stats("add", U, annot_f, b2, d_add, mean)
        else:
            U = _u_dom(d_dom, alpha, mean_enc, GP[:, sl], G2P[:, sl],
                       csum[sl])
            stats = _component_stats("dom", U, annot_f, b2, d_dom,
                                     mean_enc, alpha)
        out.append(_Comp(kind, *stats, eidx))
    return out


def block_stats_pallas_core(
    words,          # (m_pad, n_pad/16) int32 cleaned words, rows zero-padded
    annot_f,        # (m_pad, K) f32, zero rows for padded SNPs
    P_perm,         # (n_pad, Bp) f32 probes in plane-permuted order
    env_perm,       # (n_pad, num_env) plane-permuted, or None
    valid_mask,     # (n_pad,) 1.0 for kept individuals, 0.0 elsewhere
    *,
    n_indiv: int,
    components: tuple,   # (("add", env_idx|None), ...)
    b2: int,             # probe columns that participate in XXP (B or 2B)
    split: bool,
):
    """Per-block stats through the fused kernels. Returns
    (XXP (n_comp*K, N, b2), yXXy (n_comp*K, T), M (n_comp*K,)); XXP is a
    transposed view of a contiguous (n_comp*K, b2, N) tensor, the
    kernels' layout, with N in plane-permuted order (invisible downstream:
    every consumer contracts over individuals with equally-permuted
    arrays). Stage 2 is ONE ytg_matmul over all components' g-side
    columns, plus ONE square ytg_matmul over the stacked dominance
    columns when there are any."""
    m, K = annot_f.shape
    N = P_perm.shape[0]
    comps = _prepare(words, annot_f, P_perm, env_perm, valid_mask,
                     n_indiv=n_indiv, components=components, b2=b2,
                     split=split)
    YG = torch.cat([c.Y for c in comps], dim=1)         # (m, n_comp*K*b2)
    XXG = sum_halves(ytg_matmul(words, _prep_yt(YG, split)), split)
    dom_cols = [c.Y2 for c in comps if c.kind == "dom"]
    if dom_cols:
        XXG2 = sum_halves(ytg_matmul(
            words, _prep_yt(torch.cat(dom_cols, dim=1), split), True), split)
    q = K * b2
    parts = []
    dom_off = 0
    for i, c in enumerate(comps):
        part = XXG[i * q:(i + 1) * q]
        if c.kind == "dom":
            part = part + XXG2[dom_off * q:(dom_off + 1) * q]
            dom_off += 1
        part = part - c.rank1[:, None]
        if c.eidx is not None:
            part = part * env_perm[:, c.eidx][None, :]
        part = part * valid_mask[None, :]
        parts.append(part.reshape(K, b2, N))
    XXP = torch.cat(parts, dim=0).transpose(1, 2)
    yXXy = torch.cat([c.ys for c in comps], dim=0)
    M_blk = torch.sum(annot_f, dim=0).to(torch.int32)
    return XXP, yXXy, torch.cat([M_blk] * len(components))


def block_stats_pallas_acc_core(
    words, annot_f, P_perm, env_perm, valid_mask,
    tot_list,       # per-component (K*b2, n_pad) f32 totals, updated in place
    *,
    n_indiv: int,
    components: tuple,
    b2: int,
    split: bool,
):
    """Specialization of block_stats_pallas_core whose stage 2 adds into
    the running totals (ops/kernels.ytg_acc_matmul; ytg_acc2_matmul for
    dominance components, whose stats need the second, g² product): the
    per-block (Q, N) stats tensor is never materialized, the rank-1 /
    env-scale / mask transform and the totals update run in the kernel
    epilogue, one launch per component, each updating its own totals in
    place (GxE components pass their env column as the kernel's scale
    operand). Only usable where nothing needs the per-block stats:
    streaming pass 1. Bit-identical to the standard path plus
    `tot + XXP`: identical products, identical f32 transform order
    (rank1 − → ×scale → ×mask, with ×1.0 an IEEE identity for
    scale-free components; dominance: (XXG + XXG2) − rank1 → ×mask).

    Returns (tot_list, yXXy (n_comp*K, T))."""
    N = P_perm.shape[0]
    comps = _prepare(words, annot_f, P_perm, env_perm, valid_mask,
                     n_indiv=n_indiv, components=components, b2=b2,
                     split=split)
    ones_n = torch.ones((1, N), dtype=torch.float32, device=P_perm.device)
    mask_row = valid_mask[None, :].float().contiguous()
    for c, tot in zip(comps, tot_list):
        rank1 = c.rank1[:, None].float().contiguous()
        if c.kind == "dom":
            ytg_acc2_matmul(words, _prep_yt(c.Y, split),
                            _prep_yt(c.Y2, split), rank1, mask_row, tot,
                            split=split)
            continue
        scale = (ones_n if c.eidx is None
                 else env_perm[:, c.eidx][None, :].float().contiguous())
        ytg_acc_matmul(words, _prep_yt(c.Y, split), rank1, scale, mask_row,
                       tot, split=split)
    return tot_list, torch.cat([c.ys for c in comps], dim=0)


def acc_scan_stats(blocks, P, env, mask, totX, toty, *, K, components,
                   **acc_kw):
    """Accumulate every (words, annot) block of `blocks` into the totals
    through the aliased stage-2 kernel. totX is (n_comp*K, b2, N), the
    kernels' layout, and is updated in place through per-component
    (K*b2, N) views; returns (totX, toty)."""
    b2 = acc_kw["b2"]
    tots = [totX[c * K:(c + 1) * K].view(K * b2, -1)
            for c in range(len(components))]
    for words, annot in blocks:
        _, yXXy = block_stats_pallas_acc_core(
            words, annot, P, env, mask, tots, components=components,
            **acc_kw)
        toty = toty + yXXy
    return totX, toty


def nxe_stats(env, Z, Uzb, Y, b2, B):
    """Analytic hetero-noise (NxE) component statistics.

    The NxE pseudo-genotype is diag(env_e), so XXz = env_e² ⊙ z (and
    env_e² ⊙ Uzb with covariates) and yXXy = ‖env_e ⊙ y~‖²: O(N)
    elementwise work, no kernel. Inputs are (n_pad, ·) in the kernels'
    plane-permuted layout. Returns XXP (num_env, b2, N), the kernels'
    layout, so it concatenates onto the per-block stats, and yXXy
    (num_env, T)."""
    e2 = (env * env).T[:, None, :]                        # (num_env, 1, N)
    cols = [e2 * Z.T[None, :, :]]
    if b2 > B:
        cols.append(e2 * Uzb.T[None, :, :])
    XXP = torch.cat(cols, dim=1)                          # (num_env, b2, N)
    ey = env.T[:, :, None] * Y[None, :, :]                # (num_env, N, T)
    return XXP, torch.sum(ey * ey, dim=1)
