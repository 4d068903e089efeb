"""Fused per-block randomized-moment computation — the hot path.

Port of pyrhe_tpu/ops/moments.py for the kernel path (the reference's
`mm2_t` branch of `_moment_algebra`, `block_stats_pallas_core`,
`block_stats_pallas_acc_core` and `acc_scan_stats`), additive components
only. For one jackknife block of m SNPs every statistic comes from two
products over the decoded dosages g:

    GP  = g  @ [mask | P | env_e ⊙ P ...]      stage 1, ops/kernels.gp_matmul
    XXG = Yᵀ @ g                                stage 2, ops/kernels.ytg_matmul

Standardization S = D(g - mean ⊗ 1) folds into rank-1 corrections around
the products, and the leading mask column of stage 1 makes the column
sums, hence means and variances, free byproducts.

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

import torch

from .kernels import gp_matmul, ytg_acc_matmul, ytg_matmul


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


def _u_add(d_add, mean, GPr, s_r):
    """Standardized-X'P rows for an additive component via the rank-1
    fold (module docstring)."""
    return d_add[:, None] * (GPr - mean[:, None] * s_r[None, :])


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


def _component_stats(U, annot_f, b2, d, mean_stat):
    """Additive component's yXXy entry and stage-2 operand from the U rows.
    Returns (ys (K, T), Y (m, K*b2), rank1 (K*b2,)): rank1 is the
    standardization fold's correction row."""
    m, K = annot_f.shape
    Uy = U[:, b2:]
    ys = torch.sum((Uy * Uy)[:, None, :] * annot_f[:, :, None], dim=0)
    W = (U[:, None, :b2] * annot_f[:, :, None]).reshape(m, K * b2)
    Yd = d[:, None] * W
    rank1 = torch.sum(mean_stat[:, None] * Yd, dim=0)
    return ys, Yd, rank1


def _stage1(words, C_all, split):
    """GP = g @ C_all (f32), through ONE gp_matmul launch."""
    C32 = C_all.float()
    if split:
        out = gp_matmul(words, _hilo(C32, 1).contiguous())
        W = C_all.shape[1]
        return out[:, :W] + out[:, W:]
    return gp_matmul(words, C32.contiguous())


def _prep_yt(Y, split):
    """(m_pad, Q) stage-2 operand -> the kernels' (Qr, m_pad) Yt: hi/lo
    bf16 halves stacked on rows when split, else f32."""
    Yt = Y.float().T
    return (_hilo(Yt, 0) if split else Yt).contiguous()


def _check_components(components):
    if not all(kind == "add" for kind, _ in components):
        raise NotImplementedError(
            "dominance components (RHE-DOM) are not ported to "
            "pyrhe_tpu_torch yet (ROADMAP.md, Queue 1 item 10)")


def _prepare(words, annot_f, P_perm, env_perm, valid_mask, *, n_indiv,
             components, b2, split):
    """Stage 1 + standardization algebra + per-component stage-2
    operands, shared by both cores. Returns a list with one
    (ys (K, T), Y (m_pad, K*b2), rank1 (K*b2,), env_idx) per component."""
    _check_components(components)
    Bp = P_perm.shape[1]
    variants, C_all = _stage1_cols(components, P_perm, env_perm,
                                   valid_mask[:, None])
    csum = _colsum(C_all)
    GP = _stage1(words, C_all, split)                # (m_pad, 1 + Bp*V)
    mean = GP[:, 0] / n_indiv
    d_add = _add_scale(mean)
    out = []
    for _, eidx in components:
        v = variants.index(eidx)
        sl = slice(1 + v * Bp, 1 + (v + 1) * Bp)
        U = _u_add(d_add, mean, GP[:, sl], csum[sl])
        out.append((*_component_stats(U, annot_f, b2, d_add, mean), eidx))
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
    arrays). Stage 2 is ONE ytg_matmul over all components' columns."""
    m, K = annot_f.shape
    N = P_perm.shape[0]
    comps = _prepare(words, annot_f, P_perm, env_perm, valid_mask,
                     n_indiv=n_indiv, components=components, b2=b2,
                     split=split)
    YG = torch.cat([Y for _, Y, _, _ in comps], dim=1)    # (m, n_comp*K*b2)
    XXG = ytg_matmul(words, _prep_yt(YG, split))
    if split:
        Q = YG.shape[1]
        XXG = XXG[:Q] + XXG[Q:]
    q = K * b2
    parts = []
    for i, (_, _, rank1, eidx) in enumerate(comps):
        part = XXG[i * q:(i + 1) * q] - rank1[:, None]
        if eidx is not None:
            part = part * env_perm[:, eidx][None, :]
        part = part * valid_mask[None, :]
        parts.append(part.reshape(K, b2, N))
    XXP = torch.cat(parts, dim=0).transpose(1, 2)
    yXXy = torch.cat([ys for ys, _, _, _ in comps], dim=0)
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
    the running totals (ops/kernels.ytg_acc_matmul): the per-block (Q, N)
    stats tensor is never materialized, the rank-1 / env-scale / mask
    transform and the totals update run in the kernel epilogue, one launch
    per component, each updating its own totals in place (GxE components
    pass their env column as the kernel's scale operand). Only usable
    where nothing needs the per-block stats: streaming pass 1.
    Bit-identical to the standard path plus `tot + XXP`: identical
    products, identical f32 transform order (rank1 − → ×scale → ×mask,
    with ×1.0 an IEEE identity for scale-free components).

    Returns (tot_list, yXXy (n_comp*K, T))."""
    N = P_perm.shape[0]
    comps = _prepare(words, annot_f, P_perm, env_perm, valid_mask,
                     n_indiv=n_indiv, components=components, b2=b2,
                     split=split)
    ones_n = torch.ones((1, N), dtype=torch.float32, device=P_perm.device)
    mask_row = valid_mask[None, :].float().contiguous()
    for (_, Y, rank1, eidx), tot in zip(comps, tot_list):
        scale = (ones_n if eidx is None
                 else env_perm[:, eidx][None, :].float().contiguous())
        ytg_acc_matmul(words, _prep_yt(Y, split),
                       rank1[:, None].float().contiguous(), scale, mask_row,
                       tot, split=split)
    return tot_list, torch.cat([ys for ys, _, _, _ in comps], dim=0)


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
