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
    """One row per kernel variant and layout (module docstring)."""
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
        "kernels": measure(dev)}))


if __name__ == "__main__":
    main()
