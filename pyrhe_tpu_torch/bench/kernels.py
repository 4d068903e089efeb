"""Each CUDA kernel of the port against its plain version and its library
call, at one jackknife block of the main path, on one card.

    python -m pyrhe_tpu_torch.bench.kernels

Times the six kernel variants (gp_matmul and ytg_matmul, each also with
square=True, ytg_acc_matmul, ytg_acc2_matmul) at the shapes one block of
chip_smoke.py's cohort gives them: m_pad 1024 SNP rows, n_pad 100,352
individuals, stage 1 W = 22 probe columns, stage 2 Q = 160 rows (K = 8
bins x b2 = 20), in the two operand layouts the card's main paths run:
split2 (the float32 mode: bf16 hi/lo halves, 44 columns / 320 rows) and
bf16 (the bfloat16 mode: 22 columns / 160 rows). Per variant and layout:
the kernel's median time, its quartiles and count (cold L2, launches
hidden; bench/timing.event_ms, the timer of chip_smoke.py phase 3), the
plain version's (decode to a dense f32 tile + torch.matmul), the library
call's (torch.matmul on the tile decoded beforehand, f32 operands, TF32
off; both products for ytg_acc2), the bound (the larger of the bytes the
call must move, each input read once and each output written once, over
3.35 TB/s and its flops over 989 TF/s bf16, H100 SXM at 700 W) with what
sets it, the share of the bound, and the largest difference from the
plain version. Prints ONE JSON line, with the card's name and power limit.

Under `sample_contract`, pass 2's kernel at the jackknife samples of the
benchmark's two cells (`genie.cached`: E = 24 + 2 NxE rows, B = 10;
`rhe_k50.streaming`: E = 8, B = 50; 4 covariates, n_pad 100,352, f32, a
left-out block): its median over 20 cold-L2 launches and quartiles, its
plain version's, the library call's (the multiply+reduce it replaced:
tot - drop, the NxE rows, three Grams, the covariate projection and the
two border products, one row at a time), float64 GEMMs of the same sums
on flattened operands formed beforehand (`gemm_f64_ms`, 20 cold-L2
launches), the bound (the bytes read once over 3.35 TB/s) and the largest
error against float64 sums of the same stats, over the sum of the terms'
magnitudes, of the f32 launch and of a float64 launch at the same shapes
(held within 1e-5 and 1e-13: the tool raises past them).

The kernels need the card: on the CPU every wrapper runs its plain
version, so the tool has no CPU mode and raises without a card.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import kernels as K
from ..ops.moments import _hilo
from .timing import (bound, card, event_ms, median_ms, nbytes, require_card,
                     summary)

# One jackknife block of the cohort (N = M = 100,000, J = 100): rows,
# individuals, stage-1 probe columns, stage-2 rows (split).
M_PAD, N_PAD, W, QR = 1024, 100352, 22, 320
M_REAL = 1000                    # SNP rows of the block; the rest padding
RTOL = 1e-4                      # f32 summation order over ~1e5 / ~1e3 terms
LAYOUTS = ("split2", "bf16")


def random_words(gen, m_pad: int, n_pad: int, m_real: int, dev):
    """Cleaned int32 words: codes 00/10/11 only, rows >= m_real zero."""
    codes = torch.tensor([0, 2, 3], device=dev)[
        torch.randint(0, 3, (m_pad, n_pad // 16, 16), device=dev,
                      generator=gen)]
    shifts = torch.arange(0, 32, 2, device=dev)
    words = (codes << shifts).sum(dim=2).to(torch.int32)
    words[m_real:] = 0
    return words.contiguous()


def max_abs_err(name: str, got, ref) -> float:
    """Largest |got - ref|; raises AssertionError outside rtol RTOL."""
    err = (got - ref).abs().max().item()
    atol = RTOL * ref.abs().max().item()
    if not torch.allclose(got, ref, rtol=RTOL, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err:.3e}, atol {atol:.3e})")
    return err


def operands(dev, seed: int = 0) -> dict:
    """The block's words, the decoded tiles (g, g²) of the library call,
    and per layout the stage-1 C and stage-2 Yt operands, made from a
    torch.Generator seeded with seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = random_words(gen, M_PAD, N_PAD, M_REAL, dev)
    C = torch.randn(N_PAD, W, device=dev, generator=gen)
    Q = QR // 2
    Yt = torch.randn(2, Q, M_PAD, device=dev, generator=gen)
    Yt[:, :, M_REAL:] = 0.0
    return {
        "words": words,
        "dense": {sq: K.decode_words(words, sq) for sq in (False, True)},
        "C": {"split2": _hilo(C, 1).contiguous(),
              "bf16": C.to(torch.bfloat16)},
        "Yt": {"split2": [_hilo(y, 0).contiguous() for y in Yt],
               "bf16": [y.to(torch.bfloat16).contiguous() for y in Yt]},
        "rank1": torch.randn(Q, 1, device=dev, generator=gen),
        "scale": torch.ones(1, N_PAD, device=dev),
        "mask": (torch.rand(1, N_PAD, device=dev, generator=gen)
                 < 0.9).float(),
        "tot": torch.randn(Q, N_PAD, device=dev, generator=gen),
    }


def variants(ops: dict, layout: str) -> dict:
    """name -> (kernel call, plain call, library call, bytes moved, flops,
    operand dtype) of each kernel variant in one operand layout. The acc
    variants' kernel and plain calls take the totals to update (default:
    a buffer of their own)."""
    w, dense = ops["words"], ops["dense"]
    C, (Y1, Y2) = ops["C"][layout], ops["Yt"][layout]
    split = layout == "split2"
    r1, sc, mk, tot = ops["rank1"], ops["scale"], ops["mask"], ops["tot"]
    Cf, Y1f, Y2f = C.float(), Y1.float(), Y2.float()
    out = {}
    for sq in (False, True):
        sfx = "_square" if sq else ""
        out["gp_matmul" + sfx] = (
            lambda sq=sq: K.gp_matmul(w, C, sq),
            lambda sq=sq: K.gp_plain(w, C, sq),
            lambda sq=sq: dense[sq] @ Cf,
            nbytes(w, C) + M_PAD * C.shape[1] * 4,
            2 * M_PAD * N_PAD * C.shape[1])
        out["ytg_matmul" + sfx] = (
            lambda sq=sq: K.ytg_matmul(w, Y1, sq),
            lambda sq=sq: K.ytg_plain(w, Y1, sq),
            lambda sq=sq: Y1f @ dense[sq],
            nbytes(w, Y1) + Y1.shape[0] * N_PAD * 4,
            2 * Y1.shape[0] * M_PAD * N_PAD)
    # the acc kernels update their totals in place: timed on a buffer of
    # their own, checked on fresh copies of tot
    buf = tot.clone()
    out["ytg_acc_matmul"] = (
        lambda t=buf: K.ytg_acc_matmul(w, Y1, r1, sc, mk, t, split=split),
        lambda t=buf: K.ytg_acc_plain(w, Y1, r1, sc, mk, t, split),
        lambda: Y1f @ dense[False],
        nbytes(w, Y1, r1, sc, mk, tot, tot),
        2 * Y1.shape[0] * M_PAD * N_PAD)
    out["ytg_acc2_matmul"] = (
        lambda t=buf: K.ytg_acc2_matmul(w, Y1, Y2, r1, mk, t, split=split),
        lambda t=buf: K.ytg_acc2_plain(w, Y1, Y2, r1, mk, t, split),
        lambda: (Y1f @ dense[False], Y2f @ dense[True]),
        nbytes(w, Y1, Y2, r1, mk, tot, tot),
        4 * Y1.shape[0] * M_PAD * N_PAD)
    return {name: (*v, Y1.dtype) for name, v in out.items()}


def measure(dev, reps: int = 20) -> list[dict]:
    """One row per kernel variant of the block stats and layout (module
    docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = operands(dev)
    rows = []
    for layout in LAYOUTS:
        for name, (kern, plain, lib, nb, flops, dtype) in variants(
                ops, layout).items():
            fresh = ({"t": ops["tot"].clone()} if "acc" in name else {})
            got = kern(**fresh)
            fresh = ({"t": ops["tot"].clone()} if "acc" in name else {})
            err = max_abs_err(f"{name} {layout}", got, plain(**fresh))
            s = summary(event_ms(kern, reps))
            bound_ms, by = bound(nb, flops, dtype)
            rows.append({
                "name": name, "layout": layout, "ms": s["median"],
                "ms_q1": s["q1"], "ms_q3": s["q3"], "samples": s["n"],
                "plain_ms": median_ms(plain, reps=5),
                "library_ms": median_ms(lib, reps=10),
                "bound_ms": bound_ms, "bound_by": by,
                "bound_pct": 100 * bound_ms / s["median"],
                "max_abs_err": err})
    return rows


# One jackknife sample of each benchmark cell: (E_geno, NxE rows, B, ncov)
SAMPLE_SHAPES = {"genie.cached": (24, 2, 10, 4),
                 "rhe_k50.streaming": (8, 0, 50, 4)}


def replaced_contractions(tot, drop, nxe, Ct, Q, Zt, Ut, B):
    """The multiply+reduce path sample_contract replaced (one sample's
    leave-one-out stats, the NxE rows, the Grams G1, G2 and G3 one row at a
    time over an (F, N, B) product, the projection C Q C^T XXz and the two
    border products), on the same inputs: the library call of its row."""
    X = torch.cat([tot - drop, nxe]) if nxe is not None else tot - drop
    X = X.transpose(1, 2)                                   # (E, N, b2)
    XXz, XXUz = X[:, :, :B], X[:, :, B:]
    C, Z, U = Ct.T, Zt.T, Ut.T

    def gram(A, Bm):
        return torch.stack([torch.sum(a[None] * Bm, dim=(1, 2)) for a in A])

    t = torch.stack([torch.sum(C[:, :, None] * x[:, None, :], dim=0)
                     for x in XXz])
    UXXz = torch.einsum("nc,ecb->enb", C, torch.einsum("cd,edb->ecb", Q, t))
    return (gram(XXz, XXz), gram(UXXz, XXz), gram(XXUz, UXXz),
            torch.sum(XXz * Z[None], dim=(1, 2)),
            torch.sum(XXz * U[None], dim=(1, 2)))


# test_cuda_sample_contract_matches_plain's limits on the error over the
# sum of the terms' magnitudes: runs of at most 256 f32 terms; f64
SC_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def sample_contract_err(ops, B: int) -> float:
    """The kernel's largest error on ops (tot, drop, nxe, Ct, Zt, Ut)
    against float64 sums of the same stats (X = tot - drop rounded in their
    dtype), over the sum of the terms' magnitudes; raises AssertionError
    past SC_TOL of the stats' dtype."""
    got = K.sample_contract(*ops, B=B)
    tot, drop, nxe, Ct, Zt, Ut = ops
    X = (tot - drop).double()
    d = lambda t: None if t is None else t.double()
    a = lambda t: None if t is None else t.double().abs()
    want = K.sample_contract_plain(X, None, d(nxe), d(Ct), d(Zt), d(Ut), B)
    mags = K.sample_contract_plain(X.abs(), None, a(nxe), a(Ct), a(Zt),
                                   a(Ut), B)
    err = max(((g - w).abs() / m).max().item()
              for g, w, m in zip(got, want, mags))
    if not err <= SC_TOL[tot.dtype]:
        raise AssertionError(f"sample_contract {tot.dtype} {tuple(tot.shape)}"
                             f": error {err:.3e} of the terms' magnitudes, "
                             f"limit {SC_TOL[tot.dtype]:.0e}")
    return err


def gemm_f64(X, Ct, Zt, Ut, B: int):
    """The kernel's sums as float64 library GEMMs on flattened operands
    formed beforehand from X = cat(tot - drop, nxe) (E, b2, N): G1 over
    (E, B·N), C^T X over (E·b2, N) (P and R), the borders as
    matrix-vector products; the strictest library yardstick."""
    E, b2, N = X.shape
    Xz = X[:, :B].contiguous().view(E, B * N)
    Xall, C64 = X.view(E * b2, N), Ct.double()
    z64, u64 = Zt.double().view(B * N), Ut.double().view(B * N)
    return lambda: (Xz @ Xz.T, Xall @ C64.T, Xz @ z64, Xz @ u64)


def measure_sample_contract(dev, reps: int = 20) -> list[dict]:
    """One row per cell of SAMPLE_SHAPES (module docstring); raises
    AssertionError where the kernel's float32 or float64 launch is outside
    SC_TOL."""
    rows = []
    for cell, (E_geno, num_nxe, B, ncov) in SAMPLE_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(E_geno + B)

        def rand(*shape):
            return torch.randn(*shape, device=dev, generator=gen)

        ops = (rand(E_geno, 2 * B, N_PAD), rand(E_geno, 2 * B, N_PAD),
               rand(num_nxe, 2 * B, N_PAD) if num_nxe else None,
               rand(ncov, N_PAD), rand(B, N_PAD), rand(B, N_PAD))
        Q = torch.linalg.pinv(ops[3] @ ops[3].T)
        err = sample_contract_err(ops, B)
        ops64 = tuple(None if t is None else t.double() for t in ops)
        err64 = sample_contract_err(ops64, B)
        X = ops[0] - ops[1]
        X64 = (torch.cat([X, ops[2]]) if num_nxe else X).double()
        del ops64, X
        gemm = summary(event_ms(gemm_f64(X64, *ops[3:], B), reps))
        del X64
        s = summary(event_ms(lambda: K.sample_contract(*ops, B=B), reps))
        nb = nbytes(*(t for t in ops if t is not None))
        bound_ms, by = bound(nb, 0, torch.float32)
        rows.append({
            "name": "sample_contract", "cell": cell,
            "shape": {"E": E_geno + num_nxe, "B": B, "ncov": ncov,
                      "n_pad": N_PAD},
            "ms": s["median"], "ms_q1": s["q1"], "ms_q3": s["q3"],
            "samples": s["n"],
            "plain_ms": median_ms(lambda: K.sample_contract_plain(
                *ops, B), reps=5),
            "library_ms": median_ms(lambda: replaced_contractions(
                *ops[:4], Q, *ops[4:], B), reps=5),
            "gemm_f64_ms": gemm["median"],
            "bytes_read": nb, "bound_ms": bound_ms, "bound_by": by,
            "bound_pct": 100 * bound_ms / s["median"],
            "max_rel_err": err, "max_rel_err_f64": err64})
        del ops
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda) | cuda; raises without a card")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    if dev.type != "cuda":
        raise RuntimeError("bench.kernels times the CUDA kernels: on the "
                           "CPU every wrapper runs its plain version")
    print(json.dumps({
        "tool": "kernels", "device": card(dev),
        "shape": {"m_pad": M_PAD, "n_pad": N_PAD, "W": W, "Q": QR // 2},
        "kernels": measure(dev),
        "sample_contract": measure_sample_contract(dev)}))


if __name__ == "__main__":
    main()
