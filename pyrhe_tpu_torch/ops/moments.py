"""Fused per-block randomized-moment computation — the hot path.

Port of pyrhe_tpu/ops/moments.py: the kernel path (the reference's
`mm2_t` branch of `_moment_algebra`, `block_stats_pallas_core`,
`block_stats_pallas_acc_core` and `acc_scan_stats`), the exact path
(`block_stats_core`) and `_mm` (`mm`), for additive (RHE, GxE) and
dominance (RHE-DOM) components, and GENIE's analytic NxE stats
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

Precision modes (`mode`; the engine resolves the reference's mm_mode):
dosages are exact in bf16, so only the probe side limits accuracy.
  - "split2": the probe-side operand split into bf16 hi + lo halves
    stacked side by side (stage 1) or on rows (stage 2), the two halves of
    the f32 result summed — the float32 mode on the card;
  - "bf16": the probe side cast to bf16 once, one pass (~1e-3 relative);
  - "f32": f32 operands unsplit — the CPU's stand-in for split2, where the
    kernels run as their plain versions;
  - "exact": no kernel. `block_stats_core` (the reference's non-Pallas
    block_stats_core) decodes g in the working dtype (ops/decode.py) and
    runs both products as torch.matmul in that dtype — float64 runs this
    mode. The algebra after the products is shared, in the working dtype.

Inputs follow the kernels' layout contract: N-indexed arrays are padded
to n_pad and plane-permuted (ops/kernels.plane_permutation), SNP rows are
padded to m_pad with zero annot rows; padded and filtered individuals are
zeroed by `valid_mask`.

The kernel cores (standard and aliased acc) and the exact core share
`_prepare` — stage 1, the standardization scalars, the U rows and the
stage-2 operands — and the standard and exact cores share
`_block_stats`, stage 2 and its epilogue, so the acc path's bit-identity
with the standard path cannot drift.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .decode import decode_words
from .kernels import (gp_matmul, sum_halves, ytg_acc2_matmul, ytg_acc_matmul,
                      ytg_matmul)

KERNEL_MODES = ("split2", "bf16", "f32")


def mm(a, b, mm_mode, out_dtype):
    """a @ b with dosage-exact mixed precision (reference ops/moments._mm):
    `a` holds small integers, exact in bf16; `b` is the probe side.
    "exact" multiplies in out_dtype; "bf16" rounds both operands to bf16
    and accumulates in f32; "split2" splits b into bf16 hi + lo and sums
    the two f32 products. torch.matmul throughout (the reference runs
    these as jnp.dot outside any Pallas kernel)."""
    if mm_mode == "exact":
        return a.to(out_dtype) @ b.to(out_dtype)
    a32 = a.to(torch.bfloat16).float()
    if mm_mode == "bf16":
        return (a32 @ b.to(torch.bfloat16).float()).to(out_dtype)
    if mm_mode == "split2":
        hi = b.to(torch.bfloat16)
        lo = (b - hi.to(b.dtype)).to(torch.bfloat16)
        return (a32 @ hi.float() + a32 @ lo.float()).to(out_dtype)
    raise ValueError(f"unknown mm_mode {mm_mode!r}")


def _colsum(x):
    """Column sums of x (n, W), each column reduced alone as one contiguous
    vector, so a column's sum is the same bits whatever W is: a trait
    merged into a multi-trait pass (pyrhe_tpu_torch.sweep_phenotypes) gets
    the stats of its run alone. Accurate reduction (mul+reduce, not a
    product — see normal_eq._gram)."""
    return torch.stack([col.sum() for col in x.T.contiguous()])


def stage1_colsum(components, P_perm, env_perm, valid_mask):
    """Column sums over individuals of the stage-1 operand [mask | P per
    env variant] (_stage1_cols): the same for every block of a run, so the
    engine computes them once and passes them to the cores as `csum`."""
    return _colsum(_stage1_cols(components, P_perm, env_perm,
                                valid_mask[:, None])[1])


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
    # one reduction per trait, so an entry does not depend on how many
    # traits ride the pass (as _colsum)
    ys = (torch.stack([torch.sum((u * u)[:, None] * annot_f, dim=0)
                       for u in Uy.unbind(1)], dim=1) if Uy.shape[1]
          else torch.zeros((K, 0), dtype=U.dtype, device=U.device))
    W = (U[:, None, :b2] * annot_f[:, :, None]).reshape(m, K * b2)
    Yd = d[:, None] * W
    rank1 = torch.sum(mean_stat[:, None] * Yd, dim=0)
    if kind == "add":
        return ys, Yd, None, rank1
    return ys, alpha[:, None] * Yd, -Yd, rank1


def _stage1(words, C_all, mode, square=False):
    """GP = g @ C_all (g² @ C_all when square, f32), through ONE
    gp_matmul launch on the mode's probe-side operand."""
    C32 = C_all.float()
    if mode == "split2":
        out = gp_matmul(words, _hilo(C32, 1).contiguous(), square)
        W = C_all.shape[1]
        return out[:, :W] + out[:, W:]
    if mode == "bf16":
        return gp_matmul(words, C32.to(torch.bfloat16).contiguous(), square)
    return gp_matmul(words, C32.contiguous(), square)


def _prep_yt(Y, mode):
    """(m_pad, Q) stage-2 operand -> the kernels' (Qr, m_pad) Yt: hi/lo
    bf16 halves stacked on rows (split2), bf16 (bf16), else f32."""
    Yt = Y.float().T
    if mode == "split2":
        return _hilo(Yt, 0).contiguous()
    if mode == "bf16":
        return Yt.to(torch.bfloat16).contiguous()
    return Yt.contiguous()


def _kernel_products(words, mode):
    """(gp, ytg) through the kernels: gp(C, square) -> (m_pad, W) f32,
    ytg(Y, square) -> (Q, n_pad) f32 from an (m_pad, Q) operand."""
    def gp(C, square=False):
        return _stage1(words, C, mode, square)

    def ytg(Y, square=False):
        return sum_halves(ytg_matmul(words, _prep_yt(Y, mode), square),
                          mode == "split2")
    return gp, ytg


def _exact_products(words, dtype):
    """(gp, ytg) as torch.matmul on g decoded in dtype (mode "exact"); g²
    is formed once, on first use."""
    g = {False: decode_words(words, dtype=dtype)}

    def dos(square):
        if square not in g:
            g[True] = g[False] * g[False]
        return g[square]

    def gp(C, square=False):
        return dos(square) @ C

    def ytg(Y, square=False):
        return Y.T @ dos(square)
    return gp, ytg


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


def _prepare(gp, annot_f, P_perm, env_perm, valid_mask, *, n_indiv,
             components, b2, csum=None):
    """Stage 1 (through gp, see _kernel_products) + standardization
    algebra + per-component stage-2 operands, shared by every core. csum:
    stage1_colsum of the same operands, computed here when not given.
    Returns one _Comp per component."""
    _check_components(components)
    Bp = P_perm.shape[1]
    variants, C_all = _stage1_cols(components, P_perm, env_perm,
                                   valid_mask[:, None])
    if csum is None:
        csum = _colsum(C_all)
    GP = gp(C_all)                                   # (m_pad, 1 + Bp*V)
    mean = GP[:, 0] / n_indiv
    d_add = _add_scale(mean)
    if any(kind == "dom" for kind, _ in components):
        G2P = gp(C_all, square=True)
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


def _block_stats(gp, ytg, annot_f, P_perm, env_perm, valid_mask, *,
                 n_indiv, components, b2, csum=None):
    """The standard core over the products gp and ytg (_kernel_products or
    _exact_products): stage 1, the algebra, ONE stage-2 product over all
    components' g-side columns plus ONE square product over the stacked
    dominance columns when there are any, and the epilogue."""
    m, K = annot_f.shape
    N = P_perm.shape[0]
    comps = _prepare(gp, annot_f, P_perm, env_perm, valid_mask,
                     n_indiv=n_indiv, components=components, b2=b2,
                     csum=csum)
    XXG = ytg(torch.cat([c.Y for c in comps], dim=1))   # (n_comp*K*b2, N)
    dom_cols = [c.Y2 for c in comps if c.kind == "dom"]
    if dom_cols:
        XXG2 = ytg(torch.cat(dom_cols, dim=1), True)
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
    mode: str,           # "split2" | "bf16" | "f32" (KERNEL_MODES)
    csum=None,           # stage1_colsum of the operands, or None
):
    """Per-block stats through the fused kernels, in float32. Returns
    (XXP (n_comp*K, N, b2), yXXy (n_comp*K, T), M (n_comp*K,)); XXP is a
    transposed view of a contiguous (n_comp*K, b2, N) tensor, the
    kernels' layout, with N in plane-permuted order (invisible downstream:
    every consumer contracts over individuals with equally-permuted
    arrays)."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"mode {mode!r} is not a kernel mode {KERNEL_MODES}")
    return _block_stats(*_kernel_products(words, mode), annot_f, P_perm,
                        env_perm, valid_mask, n_indiv=n_indiv,
                        components=components, b2=b2, csum=csum)


def block_stats_core(words, annot_f, P_perm, env_perm, valid_mask, *,
                     n_indiv: int, components: tuple, b2: int, csum=None):
    """block_stats_pallas_core in mode "exact" (the reference's non-Pallas
    block_stats_core): g decoded in P_perm's dtype (the working dtype,
    float64 or float32) and both products as torch.matmul in it; the same
    layout, algebra and returns."""
    return _block_stats(*_exact_products(words, P_perm.dtype), annot_f,
                        P_perm, env_perm, valid_mask, n_indiv=n_indiv,
                        components=components, b2=b2, csum=csum)


def block_stats_pallas_acc_core(
    words, annot_f, P_perm, env_perm, valid_mask,
    tot_list,       # per-component (K*b2, n_pad) f32 totals, updated in place
    *,
    n_indiv: int,
    components: tuple,
    b2: int,
    mode: str,
    csum=None,
):
    """Specialization of block_stats_pallas_core whose stage 2 adds into
    the running totals (ops/kernels.ytg_acc_matmul; ytg_acc2_matmul for
    dominance components, whose stats need the second, g² product): the
    per-block (Q, N) stats tensor is never materialized, the rank-1 /
    env-scale / mask transform and the totals update run in the kernel
    epilogue, one launch per component, each updating its own totals in
    place (GxE components pass their env column as the kernel's scale
    operand). Only usable where nothing needs the per-block stats
    (streaming pass 1 and the uncached blocks of a hybrid pass 1), and
    only in a kernel mode: the totals are f32. Bit-identical to the
    standard path plus `tot + XXP`: identical products, identical f32
    transform order (rank1 − → ×scale → ×mask, with ×1.0 an IEEE
    identity for scale-free components; dominance: (XXG + XXG2) − rank1 →
    ×mask).

    Returns (tot_list, yXXy (n_comp*K, T))."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"mode {mode!r} is not a kernel mode {KERNEL_MODES}")
    N = P_perm.shape[0]
    comps = _prepare(_kernel_products(words, mode)[0], annot_f, P_perm,
                     env_perm, valid_mask, n_indiv=n_indiv,
                     components=components, b2=b2, csum=csum)
    split = mode == "split2"
    ones_n = torch.ones((1, N), dtype=torch.float32, device=P_perm.device)
    mask_row = valid_mask[None, :].float().contiguous()
    for c, tot in zip(comps, tot_list):
        rank1 = c.rank1[:, None].float().contiguous()
        if c.kind == "dom":
            ytg_acc2_matmul(words, _prep_yt(c.Y, mode), _prep_yt(c.Y2, mode),
                            rank1, mask_row, tot, split=split)
            continue
        scale = (ones_n if c.eidx is None
                 else env_perm[:, c.eidx][None, :].float().contiguous())
        ytg_acc_matmul(words, _prep_yt(c.Y, mode), rank1, scale, mask_row,
                       tot, split=split)
    return tot_list, torch.cat([c.ys for c in comps], dim=0)


def acc_scan_stats(blocks, P, env, mask, totX, toty, *, K, components,
                   timed=None, **acc_kw):
    """Accumulate every (words, annot) block of `blocks` into the totals
    through the aliased stage-2 kernel. totX is (n_comp*K, b2, N), the
    kernels' layout, and is updated in place through per-component
    (K*b2, N) views; toty is updated in place too, before the next block
    is asked for (a checkpoint reads both then); returns (totX, toty).
    Each block's work runs inside timed(), a context per block (the
    engine's `pyrhe.block_stats` span and device timer), when given."""
    b2 = acc_kw["b2"]
    tots = [totX[c * K:(c + 1) * K].view(K * b2, -1)
            for c in range(len(components))]
    for words, annot in blocks:
        with timed() if timed is not None else contextlib.nullcontext():
            _, yXXy = block_stats_pallas_acc_core(
                words, annot, P, env, mask, tots, components=components,
                **acc_kw)
            toty.add_(yXXy)
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
