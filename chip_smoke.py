#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (pyrhe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each printed as it runs; any failure raises and the script exits
non-zero without printing a result:

1. environment: a CUDA card must be present; prints its name and power
   limit (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the CUDA kernels (csrc/rhe_kernels.cu) with nvcc, timed,
   with the compiler's register / shared-memory report;
3. kernels vs plain: each of the six kernels (gp, ytg, each also with
   square=True, ytg_acc, ytg_acc2) against its plain PyTorch version on the
   card at the main paths' shapes (m_pad 1024, n_pad 100352, stage-1 width
   22 / 44 split, stage-2 rows 320 split: K = 8 bins x b2 = 20 probe
   columns of one component), f32 unsplit, split2 and bf16 unsplit (the
   operands of mm_mode bf16: stage-1 width 22, stage-2 rows 160); ytg_acc
   must equal ytg plus the tensor transform bitwise, ytg_acc2 two ytg
   calls (g, g²) plus the transform; gp, ytg and ytg² must repeat bitwise,
   and their error against a float64 product is printed beside the plain
   f32 product's.
   Median times of the kernel, its plain version and the library
   yardstick (torch.matmul on the tile decoded beforehand, f32 operands,
   TF32 off: the product alone for ytg_acc, both products for ytg_acc2),
   and each kernel's bound, for split2 and (`bf16_*` keys) bf16: the
   larger of its bytes (inputs read once, outputs written once) over 3.35
   TB/s and its flops over the peak for the operand type (989 TF/s bf16
   on the tensor cores, 67 TF/s f32), H100 SXM at 700 W. gp is timed
   again on a C built as the main path builds it (mask column + probes,
   ops/moments._stage1_cols; `ms_main_path_c`) and on GENIE's (mask
   column + three env variants of the probes, 128 split columns;
   `ms_genie_c`), ytg and ytg² at RHE-DOM's 640 split rows (the g-side
   columns of both components; `ms_main_path_rows`), ytg at GENIE's 960
   (`ms_genie_rows`), and ytg_acc with a 0/1 environment row as its scale
   (checked bitwise against ytg + transform; `ms_env_scale`);
4. the three main paths at a biobank cohort's size, on one synthesized
   cohort (pyrhe_tpu_torch/cohort.py, which profile_run shares):
   N = 100,000 individuals x M = 100,000 SNPs (a 2.5 GB .bed), 8 bins,
   4 covariates, 2 environments, J = 100, B = 10. Each path (RHE: RHE(...)
   and StreamingRHE(...); RHE-DOM: RHE_DOM(...) and StreamingRHE_DOM(...);
   GENIE G+GxE+NxE: GENIE(...) and StreamingGENIE(...)) runs cached and
   streaming with the launch counts set to 0 just before and read just
   after, then through the CLI with --streaming; per path: the cached run
   kept its stats cache (12.8 GB for RHE-DOM, 19.3 GB for GENIE), the
   streaming run served all of pass 2 from the host block cache
   (host_cache_gb -1, auto), cached == streaming bitwise, every sigma^2,
   SE and h2 finite, total h2 within 3 SE of the simulated truth (the
   cohort has no dominance, GxE or NxE effect: GENIE's total h2_gxe
   within 3 SE of 0), every kernel of the path launched, the CLI's
   sigma^2 equal to the streaming model's;
5. the other modes on that cohort: RHE in float64 (mm_mode exact, no
   kernel launch) and bf16 (the kernels with unsplit bf16 operands),
   cached and streaming, and RHE-DOM in bf16, cached and streaming, with
   the launch counts set to 0 before the bf16 runs and read after them
   (every kernel launched); cached == streaming bitwise in each; sigma^2
   and h2 of phase 4's float32 RHE within the split2 envelope (3e-4) of
   float64, bf16's within the bf16 envelope (3e-2 sigma^2, 2e-2 h2);
   RHE-DOM with cache_blocks=40 (hybrid) bitwise equal to phase 4's cached
   and streaming runs; RHE streaming with the host cache off bitwise equal
   to phase 4's (on); the H2D time of one staged block from pinned and
   from pageable memory;
6. cross-check on the example dataset (N = 5000, M = 10000): RHE (1 bin),
   RHE-DOM (8 bins) and GENIE G+GxE+NxE (8 bins, one environment) on the
   card (bf16 split2) against the port on the CPU (f32), the reference
   implementation's published RHE run and the RHE-DOM and GENIE golden
   outputs in example/outputs; then GENIE's CLI with --trace on the card,
   whose .MN must equal the reference implementation's byte for byte and
   whose .tr must match it within tests/test_golden_example.py's
   tolerances;
7. the exports on the example dataset in float64, the card against the
   CPU port: get_XtXz and its jackknife files, simulate_pheno and the
   estimate after it; then one CLI run on the card with --profile_dir,
   whose trace must hold the kernels' device events.

The last two lines are a JSON object of per-kernel results and the
{"ok": true, "device": ...} line.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Phase-3 shapes: one jackknife block of the phase-4 runs.
M_PAD, N_PAD, W, QR = 1024, 100352, 22, 320
GENIE_COMPS = (("add", None), ("add", 0), ("add", 1))   # G + 2 GxE
RTOL = 1e-4                      # f32 summation order over ~1e5 / ~1e3 terms
# Reference implementation's run on the example dataset (values and SEs),
# as in tests/test_golden_example.py REFERENCE_RUN.
REFERENCE_RUN = {
    "sigma2_g0": (0.19463871297400007, 0.028870559402243593),
    "sigma2_e": (0.8097914438786151, 0.0288719996107502),
    "h2_g0": (0.19378023613299408, 0.028743496038605126),
}
SPLIT2_RTOL = 3e-4               # tests/test_engine_vs_oracle.py envelope
BF16_RTOL_SIG, BF16_RTOL_H2 = 3e-2, 2e-2   # its bf16 envelope
# Published H100 SXM peaks at 700 W (bytes/s, flop/s by operand type).
HBM_BPS, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
SPIN_CYCLES = 4_000_000          # ~2 ms of the card's clock
REPLACES = {
    "gp_matmul": "pyrhe_tpu/ops/kernels.py:476",
    "gp_matmul_square": "pyrhe_tpu/ops/kernels.py:476",
    "ytg_matmul": "pyrhe_tpu/ops/kernels.py:524",
    "ytg_matmul_square": "pyrhe_tpu/ops/kernels.py:524",
    "ytg_acc_matmul": "pyrhe_tpu/ops/kernels.py:407",
    "ytg_acc2_matmul": "pyrhe_tpu/ops/kernels.py:346",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("[1 env] nvidia-smi name, power.limit:")
    print(smi.splitlines()[0])
    log(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build():
    from pyrhe_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    log(f"[2 build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.2f} s")


def _median_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of fn (CUDA events around it). Before
    each call a 128 MB write evicts the 50 MB L2 (the main path's other
    kernels leave it cold) and the card spins ~2 ms (torch.cuda._sleep)
    while the host enqueues the call, so the events time the device work
    and not the Python launch overhead."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _random_words(gen, m_pad, n_pad, m_real, dev):
    """Cleaned int32 words: codes 00/10/11 only, rows >= m_real zero."""
    import torch
    codes = torch.tensor([0, 2, 3], device=dev)[
        torch.randint(0, 3, (m_pad, n_pad // 16, 16), device=dev,
                      generator=gen)]
    shifts = torch.arange(0, 32, 2, device=dev)
    words = (codes << shifts).sum(dim=2).to(torch.int32)
    words[m_real:] = 0
    return words.contiguous()


def _close(name, got, ref):
    import torch
    err = (got - ref).abs().max().item()
    atol = RTOL * ref.abs().max().item()
    if not torch.allclose(got, ref, rtol=RTOL, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err:.3e}, atol {atol:.3e})")
    return err


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes, flops, dtype):
    """(bound ms, what sets it): the larger of nbytes over the memory rate
    and flops over the peak for the operand dtype."""
    import torch
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels():
    import torch
    from pyrhe_tpu_torch.ops import kernels as K
    from pyrhe_tpu_torch.ops.moments import _hilo, _stage1_cols

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    words = _random_words(gen, M_PAD, N_PAD, 1000, dev)
    # the yardstick's operands, decoded beforehand (not timed)
    dense = {sq: K.decode_words(words, sq) for sq in (False, True)}
    C = torch.randn(N_PAD, W, device=dev, generator=gen)
    Yt = torch.randn(QR, M_PAD, device=dev, generator=gen)
    Yt[:, 1000:] = 0.0
    Q = QR // 2
    Yh = _hilo(Yt[:Q], 0).contiguous()                   # (320, m) bf16
    Yb = Yt[:Q].to(torch.bfloat16).contiguous()          # (160, m) bf16
    res = {}

    def record(name, case, err, ms, plain_ms, library_ms, nbytes, flops,
               dtype, **extra):
        """Errors over every case; times and bound of the split case (the
        float32 main path on the card) and, under bf16_* keys, of the
        unsplit bf16 case (the bf16 main path)."""
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        bound_ms, by = _bound(nbytes, flops, dtype)
        got = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms,
                   **extra)
        if case == "split":
            r.update(got)
        elif case == "bf16":
            r.update({f"bf16_{k}": v for k, v in got.items()},
                     bf16_max_abs_err=err)
        return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.1f} us ({by}, "
                f"{100 * bound_ms / ms:.2f} % of it)")

    words_b = _nbytes(words)
    for square in (False, True):
        name = "gp_matmul_square" if square else "gp_matmul"
        for case, Cop in (("f32", C), ("split", _hilo(C, 1).contiguous()),
                          ("bf16", C.to(torch.bfloat16))):
            split = case == "split"
            got = K.gp_matmul(words, Cop, square)
            if not torch.equal(got, K.gp_matmul(words, Cop, square)):
                raise AssertionError(f"{name} {case}: two launches differ "
                                     "(must be deterministic)")
            ref = K.gp_plain(words, Cop, square)
            err = _close(f"{name} {case}", got, ref)
            # against float64: the kernel and the plain f32 product
            r64 = dense[square].double() @ C.double()
            e64 = {}
            for who, x in (("kernel", got), ("plain", ref)):
                x = x[:, :W] + x[:, W:] if split else x
                e64[who] = (x.double() - r64).abs().max().item()
            rel = r64.abs().max().item()
            ms = _median_ms(lambda: K.gp_matmul(words, Cop, square))
            pms = _median_ms(lambda: K.gp_plain(words, Cop, square), reps=5)
            Cf = Cop.float()
            lms = _median_ms(lambda: dense[square] @ Cf, reps=10)
            line = record(name, case, err, ms, pms, lms,
                          words_b + _nbytes(Cop, got),
                          2 * M_PAD * N_PAD * Cop.shape[1], Cop.dtype,
                          err_vs_f64=e64["kernel"])
            log(f"[3 kernels] {name} {case} C {tuple(Cop.shape)} "
                f"{Cop.dtype}: max abs err vs plain {err:.3e}; vs float64 "
                f"kernel {e64['kernel']:.3e}, plain f32 {e64['plain']:.3e} "
                f"(max |ref| {rel:.3e}); bitwise repeatable; {line}")

    # gp on the main path's C: [valid mask | Z | Uzb | y] (1 + 21 columns)
    perm = torch.as_tensor(K.plane_permutation(N_PAD), device=dev)
    mask_col = (perm < 100_000).float()[:, None]
    P = torch.randn(N_PAD, 21, device=dev, generator=gen) * mask_col
    _, C_main = _stage1_cols((("add", None),), P, None, mask_col)
    C_main = _hilo(C_main, 1).contiguous()
    for square in (False, True):
        name = "gp_matmul_square" if square else "gp_matmul"
        got = K.gp_matmul(words, C_main, square)
        err = _close(f"{name} main-path C", got,
                     K.gp_plain(words, C_main, square))
        ms = _median_ms(lambda: K.gp_matmul(words, C_main, square))
        res[name]["ms_main_path_c"] = ms
        log(f"[3 kernels] {name} on the main path's C {tuple(C_main.shape)}"
            f" {C_main.dtype}: max abs err vs plain {err:.3e}; kernel "
            f"{ms:.4f} ms")
    # gp on GENIE's C: the mask column and the probes scaled by each env
    # variant (1 + 21 x 3 = 64 columns, 128 split)
    env = (torch.rand(N_PAD, 2, device=dev, generator=gen) < 0.5).float()
    env = env * mask_col
    _, C_genie = _stage1_cols(GENIE_COMPS, P, env, mask_col)
    C_genie = _hilo(C_genie, 1).contiguous()
    err = _close("gp_matmul GENIE C", K.gp_matmul(words, C_genie),
                 K.gp_plain(words, C_genie))
    ms = _median_ms(lambda: K.gp_matmul(words, C_genie))
    res["gp_matmul"]["ms_genie_c"] = ms
    bound_ms, by = _bound(words_b + _nbytes(C_genie) + M_PAD * C_genie.shape[1]
                          * 4, 2 * M_PAD * N_PAD * C_genie.shape[1],
                          C_genie.dtype)
    log(f"[3 kernels] gp_matmul on GENIE's C {tuple(C_genie.shape)} "
        f"{C_genie.dtype}: max abs err vs plain {err:.3e}; kernel "
        f"{ms:.4f} ms, bound {bound_ms * 1e3:.1f} us ({by}, "
        f"{100 * bound_ms / ms:.2f} % of it)")

    # RHE-DOM's stage 2 over g on the main path: both components' g-side
    # columns, 2 x 160 output rows, 640 split rows
    Y640 = torch.randn(QR, M_PAD, device=dev, generator=gen)
    Y640[:, 1000:] = 0.0
    Y640 = _hilo(Y640, 0).contiguous()
    for square in (False, True):
        name = "ytg_matmul_square" if square else "ytg_matmul"
        for case, Yop in (("f32", Yt), ("split", Yh), ("bf16", Yb)):
            split = case == "split"
            got = K.ytg_matmul(words, Yop, square)
            if not torch.equal(got, K.ytg_matmul(words, Yop, square)):
                raise AssertionError(f"{name} {case}: two launches differ "
                                     "(must be deterministic)")
            ref = K.ytg_plain(words, Yop, square)
            err = _close(f"{name} {case}", got, ref)
            # against float64 of the f32 Yt: the kernel and the plain f32
            # product (split: the two halves summed)
            r64 = (Yt if case == "f32" else Yt[:Q]).double() @ dense[
                square].double()
            e64 = {who: (K.sum_halves(x, split).double() - r64).abs().max()
                   .item() for who, x in (("kernel", got), ("plain", ref))}
            rel = r64.abs().max().item()
            del r64
            ms = _median_ms(lambda: K.ytg_matmul(words, Yop, square))
            pms = _median_ms(lambda: K.ytg_plain(words, Yop, square), reps=5)
            Yf = Yop.float()
            lms = _median_ms(lambda: Yf @ dense[square], reps=10)
            line = record(name, case, err, ms, pms, lms,
                          words_b + _nbytes(Yop, got),
                          2 * Yop.shape[0] * M_PAD * N_PAD, Yop.dtype,
                          err_vs_f64=e64["kernel"])
            log(f"[3 kernels] {name} {case} Yt {tuple(Yop.shape)} "
                f"{Yop.dtype}: max abs err vs plain {err:.3e}; vs float64 "
                f"kernel {e64['kernel']:.3e}, plain f32 {e64['plain']:.3e} "
                f"(max |ref| {rel:.3e}); bitwise repeatable; {line}")
        _close(f"{name} Yt {tuple(Y640.shape)}",
               K.ytg_matmul(words, Y640, square),
               K.ytg_plain(words, Y640, square))
        ms = _median_ms(lambda: K.ytg_matmul(words, Y640, square))
        res[name]["ms_main_path_rows"] = ms
        log(f"[3 kernels] {name} at the RHE-DOM main path's "
            f"{Y640.shape[0]} split rows: kernel {ms:.4f} ms")
    # GENIE's stage 2 over g: G and two GxE components, 3 x 160 rows
    Y960 = torch.randn(3 * Q, M_PAD, device=dev, generator=gen)
    Y960[:, 1000:] = 0.0
    Y960 = _hilo(Y960, 0).contiguous()
    err = _close(f"ytg_matmul Yt {tuple(Y960.shape)}",
                 K.ytg_matmul(words, Y960), K.ytg_plain(words, Y960))
    ms = _median_ms(lambda: K.ytg_matmul(words, Y960))
    res["ytg_matmul"]["ms_genie_rows"] = ms
    bound_ms, by = _bound(words_b + _nbytes(Y960) + Y960.shape[0] * N_PAD * 4,
                          2 * Y960.shape[0] * M_PAD * N_PAD, Y960.dtype)
    log(f"[3 kernels] ytg_matmul at the GENIE main path's {Y960.shape[0]} "
        f"split rows: max abs err vs plain {err:.3e}; kernel {ms:.4f} ms, "
        f"bound {bound_ms * 1e3:.1f} us ({by}, {100 * bound_ms / ms:.2f} % "
        "of it)")

    mask = (torch.rand(1, N_PAD, device=dev, generator=gen) < 0.9).float()
    env_row = env[:, 0][None, :].contiguous()    # a GxE component's scale
    for case, Yop in (("f32", Yt[:Q].contiguous()), ("split", Yh),
                      ("bf16", Yb)):
        split = case == "split"
        rank1 = torch.randn(Q, 1, device=dev, generator=gen)
        err = 0.0
        for scale in (env_row, torch.ones(1, N_PAD, device=dev),
                      torch.randn(1, N_PAD, device=dev, generator=gen)):
            tot0 = torch.randn(Q, N_PAD, device=dev, generator=gen)
            got = K.ytg_acc_matmul(words, Yop, rank1, scale, mask,
                                   tot0.clone(), split=split)
            a = K.ytg_matmul(words, Yop)
            if split:
                a = a[:Q] + a[Q:]
            expect = tot0 + ((a - rank1) * scale) * mask
            if not torch.equal(got, expect):
                bad = (got != expect).sum().item()
                raise AssertionError(
                    f"ytg_acc_matmul {case}: {bad} elements differ from "
                    "ytg_matmul + transform (must be bitwise equal)")
            ref = K.ytg_acc_plain(words, Yop, rank1, scale, mask,
                                  tot0.clone(), split)
            err = max(err, _close(f"ytg_acc_matmul {case}", got, ref))
        tot = tot0.clone()
        ms = _median_ms(lambda: K.ytg_acc_matmul(
            words, Yop, rank1, scale, mask, tot, split=split))
        pms = _median_ms(lambda: K.ytg_acc_plain(
            words, Yop, rank1, scale, mask, tot, split), reps=5)
        Yf = Yop.float()
        lms = _median_ms(lambda: Yf @ dense[False], reps=10)
        line = record("ytg_acc_matmul", case, err, ms, pms, lms,
                      words_b + _nbytes(Yop, rank1, scale, mask, tot, tot),
                      2 * Yop.shape[0] * M_PAD * N_PAD, Yop.dtype)
        log(f"[3 kernels] ytg_acc_matmul {case} Yt "
            f"{tuple(Yop.shape)} {Yop.dtype}: bitwise == ytg + transform "
            f"(scales: env row, ones, random); max abs err vs plain "
            f"{err:.3e}; {line}")
    ms = _median_ms(lambda: K.ytg_acc_matmul(
        words, Yh, rank1, env_row, mask, tot, split=True))
    res["ytg_acc_matmul"]["ms_env_scale"] = ms
    log(f"[3 kernels] ytg_acc_matmul split=True with a 0/1 env row as "
        f"scale: kernel {ms:.4f} ms")

    Yt2 = torch.randn(Q, M_PAD, device=dev, generator=gen)
    Yt2[:, 1000:] = 0.0
    for case, Y1, Y2 in (("f32", Yt[:Q].contiguous(), Yt2),
                         ("split", Yh, _hilo(Yt2, 0).contiguous()),
                         ("bf16", Yb, Yt2.to(torch.bfloat16))):
        split = case == "split"
        rank1 = torch.randn(Q, 1, device=dev, generator=gen)
        tot0 = torch.randn(Q, N_PAD, device=dev, generator=gen)
        got = K.ytg_acc2_matmul(words, Y1, Y2, rank1, mask, tot0.clone(),
                                split=split)
        a1 = K.sum_halves(K.ytg_matmul(words, Y1), split)
        a2 = K.sum_halves(K.ytg_matmul(words, Y2, square=True), split)
        expect = tot0 + ((a1 + a2) - rank1) * mask
        if not torch.equal(got, expect):
            bad = (got != expect).sum().item()
            raise AssertionError(
                f"ytg_acc2_matmul {case}: {bad} elements differ from two "
                "ytg_matmul calls + transform (must be bitwise equal)")
        ref = K.ytg_acc2_plain(words, Y1, Y2, rank1, mask, tot0.clone(),
                               split)
        err = _close(f"ytg_acc2_matmul {case}", got, ref)
        tot = tot0.clone()
        ms = _median_ms(lambda: K.ytg_acc2_matmul(
            words, Y1, Y2, rank1, mask, tot, split=split))
        pms = _median_ms(lambda: K.ytg_acc2_plain(
            words, Y1, Y2, rank1, mask, tot, split), reps=5)
        Y1f, Y2f = Y1.float(), Y2.float()
        lms = _median_ms(lambda: (Y1f @ dense[False], Y2f @ dense[True]),
                         reps=10)
        line = record("ytg_acc2_matmul", case, err, ms, pms, lms,
                      words_b + _nbytes(Y1, Y2, rank1, mask, tot, tot),
                      4 * Y1.shape[0] * M_PAD * N_PAD, Y1.dtype)
        log(f"[3 kernels] ytg_acc2_matmul {case} Yt1, Yt2 "
            f"{tuple(Y1.shape)} {Y1.dtype}: bitwise == two ytg + transform;"
            f" max abs err vs plain {err:.3e}; {line}")
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def _make_cohort(d):
    from pyrhe_tpu_torch import cohort
    t0 = time.perf_counter()
    prefix = cohort.make(os.path.join(d, "cohort"))
    log(f"[4 main] synthesized N={cohort.N} M={cohort.M} "
        f"({os.path.getsize(prefix + '.bed') / 1e9:.2f} GB .bed) in "
        f"{time.perf_counter() - t0:.1f} s")
    return prefix


def _run_model(cls, prefix, **kw):
    import torch
    from pyrhe_tpu_torch import cohort
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cohort.model(cls, prefix, **kw)
    t_load = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = model(trait=0)
    t_call = time.perf_counter() - t1
    pt = dict(model.engine.phase_times)
    pt["load_s"] = t_load
    pt["solve_s"] = t_call - pt["pass1_s"] - pt["pass2_s"]
    pt["total_s"] = t_load + t_call
    pt["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return model, res, pt


def _fmt_phases(pt):
    return ", ".join(f"{k} {v:.3f}" for k, v in pt.items())


def _drive_path(prefix, label, model, cls_c, cls_s, kernels, kw, checks):
    """One main path, cached and streaming, with the launch counts set to
    0 just before and read just after; then its CLI --streaming run. kw:
    the models' extra arguments; checks: (name, index into h2_total,
    simulated truth) of each heritability held within 3 SE of its truth.
    Returns (the launch counts, {"cached" | "streaming": (T_all, q_all,
    sigma_ests_total, h2_total)}); the streaming run takes the host block
    cache (host_cache_gb -1, auto) and must serve all of pass 2 from
    it."""
    import torch
    from pyrhe_tpu_torch import cohort
    from pyrhe_tpu_torch.ops import kernels as K
    from parse_output import parse_output_file

    K.reset_launch_counts()
    cached, res_c, pt_c = _run_model(cls_c, prefix, **kw)
    streaming, res_s, pt_s = _run_model(cls_s, prefix, **kw)
    launches = dict(K.launches)
    tag = f"[4 main {label}]"
    if cached.engine.cfg.streaming:
        raise AssertionError(f"{label}: the cached run switched to streaming")
    log(f"{tag} cached phases (s): {_fmt_phases(pt_c)}")
    log(f"{tag} streaming phases (s): {_fmt_phases(pt_s)}")
    log(f"{tag} launches in the two runs: {launches}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched by the {label} "
                                 "path")
    if pt_s.get("host_cache_hits") != cohort.JACK:
        raise AssertionError(f"{label}: streaming pass 2 took "
                             f"{pt_s.get('host_cache_hits')} blocks from the "
                             f"host cache, not all {cohort.JACK}")
    out = {key: (m.engine.T_all, m.engine.q_all,
                 np.asarray(r["sigma_ests_total"]), np.asarray(r["h2_total"]))
           for key, m, r in (("cached", cached, res_c),
                             ("streaming", streaming, res_s))}
    eq_T = np.array_equal(cached.engine.T_all, streaming.engine.T_all)
    eq_q = np.array_equal(cached.engine.q_all, streaming.engine.q_all)
    if not (eq_T and eq_q):
        raise AssertionError(f"{label}: cached != streaming (T equal {eq_T}, "
                             f"q equal {eq_q})")
    for key in ("sigma_ests_total", "sig_errs", "h2_total", "h2_errs"):
        if not np.all(np.isfinite(res_c[key])):
            raise AssertionError(f"{label}: non-finite {key}: {res_c[key]}")
    log(f"{tag} cached == streaming bitwise (T_all, q_all); E = "
        f"{cached.engine.E} estimates")
    for name, i, truth in checks:
        h2, se = float(res_c["h2_total"][i]), float(res_c["h2_errs"][i])
        log(f"{tag} {name} {h2:.5f} SE {se:.5f}, simulated truth {truth}")
        if abs(h2 - truth) > 3 * se:
            raise AssertionError(f"{label}: {name} {h2} is more than 3 SE "
                                 f"from {truth}")
    del cached, streaming
    torch.cuda.empty_cache()

    report = os.path.join(os.path.dirname(prefix),
                          f"cli_{model}_streaming.txt")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "pyrhe_tpu_torch.cli", "--model", model,
         *cohort.cli_args(prefix, **kw), "--streaming", "-o", report,
         "--suppress"], check=True, cwd=ROOT)
    got = parse_output_file(report)
    cli_sigma = [g["value"] for key in ("sigma2_g", "sigma2_gxe",
                                        "sigma2_nxe") for g in got[key]] + [
        got["sigma2_e"]["value"]]
    if cli_sigma != [float(v) for v in res_s["sigma_ests_total"]]:
        raise AssertionError(f"{label}: CLI sigma {cli_sigma} != "
                             f"{cls_s.__name__} "
                             f"{list(res_s['sigma_ests_total'])}")
    log(f"{tag} CLI --model {model} --streaming run: "
        f"{time.perf_counter() - t0:.1f} s wall (new process, kernels "
        f"already built); sigma equal to {cls_s.__name__}'s")
    return launches, out


def phase_main(d):
    """The three main paths on one synthesized cohort; returns (the
    cohort's prefix, each kernel's launches summed over the paths' runs,
    {path label: _drive_path's results})."""
    from pyrhe_tpu_torch import (GENIE, RHE, RHE_DOM, StreamingGENIE,
                                 StreamingRHE, StreamingRHE_DOM, cohort)
    from pyrhe_tpu_torch.ops import kernels as K
    prefix = _make_cohort(d)
    total = dict.fromkeys(K.KERNELS, 0)
    additive = ("gp_matmul", "ytg_matmul", "ytg_acc_matmul")
    truth = sum(cohort.SIGMA)
    total_h2 = [("total h2", -1, truth)]
    # GENIE's h2_total ends [total h2, total h2_g, total h2_gxe]
    genie_h2 = [("total h2", -3, truth), ("total h2_gxe", -1, 0.0)]
    results = {}
    # (label, --model, cached class, streaming class, kernels it launches,
    #  extra model arguments, heritability checks)
    for path in (("RHE", "rhe", RHE, StreamingRHE, additive, {}, total_h2),
                 ("RHE-DOM", "rhe_dom", RHE_DOM, StreamingRHE_DOM,
                  K.KERNELS, {}, total_h2),
                 ("GENIE", "genie", GENIE, StreamingGENIE, additive,
                  cohort.genie_kw(prefix), genie_h2)):
        launches, results[path[0]] = _drive_path(prefix, *path)
        for name, n in launches.items():
            total[name] += n
    return prefix, total, results


def _assert_same(label, got, want):
    """(T_all, q_all) pairs bitwise equal."""
    for name, a, b in (("T_all", got[0], want[0]), ("q_all", got[1], want[1])):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: {name} differs (max abs "
                                 f"{np.abs(a - b).max():.3e})")


def _envelope(label, got, want, rtol_sig, rtol_h2):
    """sigma^2 and h2 (each bin's and the total) of got within rtol of
    want's (the envelope check of tests/test_engine_vs_oracle.py); returns
    the two gaps relative to the largest entry."""
    (_, _, sig, h2), (_, _, sig0, h20) = got, want
    gaps = []
    for what, a, b, rtol in (("sigma^2", sig, sig0, rtol_sig),
                             ("h2", h2, h20, rtol_h2)):
        atol = rtol * np.abs(b).max()
        if not np.all(np.abs(a - b) <= atol + rtol * np.abs(b)):
            raise AssertionError(f"{label}: {what} {a} vs {b} outside rtol "
                                 f"{rtol}")
        gaps.append(np.abs(a - b).max() / np.abs(b).max())
    return gaps


def _h2d_ms(nbytes, pin):
    """Median ms of one host-to-device copy of nbytes from a pinned or a
    pageable host buffer (CUDA events around the copy)."""
    import torch
    host = torch.ones(nbytes, dtype=torch.uint8, pin_memory=pin)
    times = []
    for _ in range(12):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        host.to("cuda", non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[2:])


def phase_modes(prefix, phase4):
    """5. The other working dtypes and the caches on the phase-4 cohort:
    RHE in float64 (mm_mode exact: no kernel launch) and bf16 (the kernels
    with unsplit bf16 operands), cached and streaming, bitwise equal and
    inside their envelopes of the float64 run; RHE-DOM bf16 cached and
    streaming (ytg_acc2 with unsplit bf16 operands); RHE-DOM with
    cache_blocks=40 (hybrid) and RHE streaming with the host cache off,
    bitwise equal to phase 4's runs; a pinned against a pageable copy of
    one staged block. Returns the bf16 path's launch counts."""
    import torch
    from pyrhe_tpu_torch import RHE, RHE_DOM, StreamingRHE, StreamingRHE_DOM
    from pyrhe_tpu_torch.ops import kernels as K
    tag = "[5 modes]"

    def run(cls, **kw):
        model, res, pt = _run_model(cls, prefix, **kw)
        out = (model.engine.T_all, model.engine.q_all,
               np.asarray(res["sigma_ests_total"]),
               np.asarray(res["h2_total"]))
        cfg = ", ".join(f"{k}={v}" for k, v in kw.items())
        log(f"{tag} {cls.__name__}({cfg}) phases (s): {_fmt_phases(pt)}")
        del model
        torch.cuda.empty_cache()
        return out, pt

    K.reset_launch_counts()
    f64 = {s: run(cls, dtype="float64")[0]
           for s, cls in ((False, RHE), (True, StreamingRHE))}
    if any(K.launches.values()):
        raise AssertionError(f"float64 launched kernels: {K.launches}")
    _assert_same("RHE float64 streaming vs cached", f64[True], f64[False])
    K.reset_launch_counts()
    bf16 = {s: run(cls, dtype="bfloat16")[0]
            for s, cls in ((False, RHE), (True, StreamingRHE))}
    dom = {s: run(cls, dtype="bfloat16")[0]
           for s, cls in ((False, RHE_DOM), (True, StreamingRHE_DOM))}
    launches = dict(K.launches)
    log(f"{tag} launches in the four bf16 runs: {launches}")
    for name in K.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched by the bf16 "
                                 "path")
    _assert_same("RHE bf16 streaming vs cached", bf16[True], bf16[False])
    _assert_same("RHE-DOM bf16 streaming vs cached", dom[True], dom[False])
    g32 = _envelope("RHE float32 vs float64", phase4["RHE"]["cached"],
                    f64[False], SPLIT2_RTOL, SPLIT2_RTOL)
    gbf = _envelope("RHE bf16 vs float64", bf16[False], f64[False],
                    BF16_RTOL_SIG, BF16_RTOL_H2)
    log(f"{tag} cached == streaming bitwise in float64 (RHE) and bf16 (RHE, "
        f"RHE-DOM); max |sigma^2| gap to float64, of max |sigma^2|: float32 "
        f"split2 {g32[0]:.3e} (envelope {SPLIT2_RTOL}), bf16 {gbf[0]:.3e} "
        f"({BF16_RTOL_SIG}); h2 gap float32 {g32[1]:.3e}, bf16 "
        f"{gbf[1]:.3e}; total h2 float64 {f64[False][3][-1]:.5f}, float32 "
        f"{phase4['RHE']['cached'][3][-1]:.5f}, bf16 "
        f"{bf16[False][3][-1]:.5f}")

    hybrid, _ = run(RHE_DOM, cache_blocks=40)
    for key in ("cached", "streaming"):
        _assert_same(f"RHE-DOM cache_blocks=40 vs phase 4 {key}", hybrid,
                     phase4["RHE-DOM"][key])
    off, pt = run(StreamingRHE, host_cache_gb=0)
    if pt.get("host_cache_hits"):
        raise AssertionError("host_cache_gb=0 still served blocks from RAM")
    _assert_same("RHE streaming host cache off vs on", off,
                 phase4["RHE"]["streaming"])
    log(f"{tag} RHE-DOM cache_blocks=40 (hybrid) == phase 4 cached == "
        "streaming bitwise; RHE streaming host cache off == on bitwise")
    nbytes = 1024 * 100352 // 4        # one staged block's words
    pinned, pageable = _h2d_ms(nbytes, True), _h2d_ms(nbytes, False)
    log(f"{tag} H2D of one staged block ({nbytes / 1e6:.1f} MB): pinned "
        f"{pinned:.4f} ms ({nbytes / pinned / 1e6:.1f} GB/s), pageable "
        f"{pageable:.4f} ms ({nbytes / pageable / 1e6:.1f} GB/s)")
    return launches


def phase_exports(d, prefix):
    """7. The exports on the example dataset (N = 5000, M = 10000, one bin,
    no covariates, J = 10, B = 10) in float64, the card against the CPU
    port: get_XtXz (results
    and every .jack_j file at rtol 1e-10) and simulate_pheno (betas equal,
    y at rtol 1e-10, the re-estimated sigma^2 at rtol 1e-8); then one CLI
    run on the card with --profile_dir, whose Chrome trace must hold the
    kernels' device activity."""
    from pyrhe_tpu_torch import RHE, Logger
    tag = "[7 exports]"
    t0 = time.perf_counter()
    out = {}
    for device in ("cuda", "cpu"):
        kw = dict(geno_file=prefix, annot_file=os.path.join(
            d, "single.annot"), pheno_file=prefix + ".pheno",
            num_jack=10, num_random_vec=10,
            seed=42, dtype="float64", device=device,
            log=Logger(suppress=True, debug_mode=False))
        xtxz = RHE(**kw).get_XtXz(os.path.join(d, f"xtxz_{device}"))
        sim = RHE(**kw)
        y, betas = sim.simulate_pheno([0.3])
        out[device] = (xtxz, y, betas, sim.estimate(0)[1])
    (x, y, b, st), (x0, y0, b0, st0) = out["cuda"], out["cpu"]
    checks = [("get_XtXz", x, x0, 1e-10), ("simulate_pheno y", y, y0, 1e-10),
              ("sigma^2 after simulate_pheno", st, st0, 1e-8)]
    for j in range(10):
        checks.append((f"jack_{j}.txt.bin", *(
            np.fromfile(os.path.join(d, f"xtxz_{dev}.jack_{j}.txt.bin"))
            for dev in ("cuda", "cpu")), 1e-10))
    for name, a, b_, rtol in checks:
        if a.shape != b_.shape or not np.allclose(
                a, b_, rtol=rtol, atol=rtol * np.abs(b_).max()):
            raise AssertionError(f"{name}: card vs CPU differ beyond rtol "
                                 f"{rtol}")
    if not np.array_equal(b, b0):
        raise AssertionError("simulate_pheno betas: card vs CPU differ")
    log(f"{tag} get_XtXz ({x.shape}, 10 jackknife files) and simulate_pheno"
        f" on the card == CPU float64 (rtol 1e-10; sigma^2 after it "
        f"{st[0]:.8f} vs {st0[0]:.8f}): {time.perf_counter() - t0:.1f} s")

    prof = os.path.join(d, "prof")
    report = os.path.join(d, "cli_profile.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.cli", "-g", prefix,
                    "-annot", os.path.join(d, "single.annot"), "-p",
                    prefix + ".pheno", "-c", prefix + ".cov", "-k", "10",
                    "-jn", "10", "-s", "42", "--profile_dir", prof, "-o",
                    report, "--suppress"], check=True, cwd=ROOT)
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    with open(report) as f:
        said = f"Profiler trace written to {prof}" in f.read()
    kernels = [k for k in ("gp_kernel", "ytg_kernel") if k in trace]
    if not said or len(kernels) != 2:
        raise AssertionError(f"--profile_dir: report line {said}, kernels "
                             f"in the trace {kernels}")
    log(f"{tag} CLI --profile_dir on the card: {len(trace) / 1e6:.1f} MB "
        f"Chrome trace with {', '.join(kernels)} device events, "
        f"{time.perf_counter() - t0:.1f} s wall")


def _example(d):
    """The example dataset (example/make_example.py's seeds)."""
    from pyrhe_tpu_torch.io import synth
    cwd = os.getcwd()
    os.chdir(d)
    try:
        synth.make_dataset("test", 5000, 10000, seed=42, missing_rate=0.005)
        a1 = synth.make_annot("single.annot", 10000, 1, seed=42)
        synth.make_annot("multi.annot", 10000, 8, seed=43)
        cov = synth.make_cov_file("test.cov", 5000, num_cov=5, seed=42)
        env = synth.make_env_file("test.env", 5000, num_env=1, seed=42)
        synth.simulate_pheno_file("test", "test", [0.2], a1, seed=44,
                                  cov=cov, env=env, sigma_gxe=0.05)
    finally:
        os.chdir(cwd)
    return os.path.join(d, "test")


def _example_runs(cls, prefix, annot, **kw):
    """({device: report}, {device: report text}) of one model on the
    example dataset (the example configs' settings; kw overrides them), on
    the card and on the CPU."""
    from pyrhe_tpu_torch import Logger
    out, text = {}, {}
    for device in ("cuda", "cpu"):
        args = dict(dict(num_jack=100, num_random_vec=10, seed=42), **kw)
        model = cls(geno_file=prefix, annot_file=annot,
                    pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
                    device=device, log=Logger(suppress=True,
                                              debug_mode=False), **args)
        out[device] = model(trait=0)
        text[device] = "".join(model.log.msgs)
    return out, text


def _check_envelope(label, out):
    """sigma^2 on the card within the split2 envelope of the CPU run's.
    Returns (max gap, atol)."""
    s_gpu = np.asarray(out["cuda"]["sigma_ests_total"])
    s_cpu = np.asarray(out["cpu"]["sigma_ests_total"])
    atol = SPLIT2_RTOL * np.abs(s_cpu).max()
    gap = np.abs(s_gpu - s_cpu)
    if not np.all(gap <= atol + SPLIT2_RTOL * np.abs(s_cpu)):
        raise AssertionError(f"{label} sigma cuda {s_gpu} vs cpu {s_cpu} "
                             f"outside the split2 envelope (rtol "
                             f"{SPLIT2_RTOL}, atol {atol:.3e})")
    return gap.max(), atol


# One estimate line of a report: Sigma^2_g/gxe/nxe/e, h2_g/gxe/nxe, Total
# h2 (and _g, _gxe), Enrichment g, each with its SE (RHE-DOM writes
# "h2_g[i] : value : SE").
ESTIMATE = re.compile(r"^(Sigma\^2_\w+(?:\[\d+\])?|h2_\w+\[\d+\]|Total h2\w*|"
                      r"Enrichment g\[\d+\]) : ([-\d.e]+) +(?:SE ?)?: ?"
                      r"([\d.e-]+)$", re.M)


def _estimates(text):
    """{name: (value, SE)} of every estimate line of a report's text."""
    return {name: (float(v), float(se))
            for name, v, se in ESTIMATE.findall(text)}


def _check_report_overlap(label, ours, path):
    """The same estimate names as the report at path, each within SE
    overlap of it."""
    with open(path) as f:
        gold = _estimates(f.read())
    if sorted(ours) != sorted(gold):
        raise AssertionError(f"{label}: estimates {sorted(ours)} vs "
                             f"{sorted(gold)} in {path}")
    for name, (v, se) in ours.items():
        gv, gse = gold[name]
        if abs(v - gv) > se + gse:
            raise AssertionError(f"{label} {name} = {v} (SE {se}) outside "
                                 f"SE overlap with {gv} (SE {gse}) of "
                                 f"{path}")


def phase_small(d):
    from pyrhe_tpu_torch import RHE, RHE_DOM
    prefix = _example(d)
    out, _ = _example_runs(RHE, prefix, os.path.join(d, "single.annot"))
    vals = {}
    for device, r in out.items():
        vals[device] = {
            "sigma2_g0": (r["sigma_ests_total"][0], r["sig_errs"][0]),
            "sigma2_e": (r["sigma_ests_total"][1], r["sig_errs"][1]),
            "h2_g0": (r["h2_total"][0], r["h2_errs"][0])}
        for key, (ref, ref_se) in REFERENCE_RUN.items():
            v, se = vals[device][key]
            if abs(v - ref) > 1e-3 or abs(se - ref_se) > 1e-3:
                raise AssertionError(f"{device} {key} = {v} (SE {se}) vs "
                                     f"reference run {ref} (SE {ref_se})")
    for key in REFERENCE_RUN:
        g, c = vals["cuda"][key][0], vals["cpu"][key][0]
        if abs(g - c) > SPLIT2_RTOL * abs(c):
            raise AssertionError(f"{key}: cuda {g} vs cpu {c} outside the "
                                 f"split2 envelope rtol {SPLIT2_RTOL}")
    log("[6 small] RHE example N=5000 M=10000: " + "; ".join(
        f"{k} cuda {vals['cuda'][k][0]:.8f} cpu {vals['cpu'][k][0]:.8f} "
        f"ref {REFERENCE_RUN[k][0]:.8f}" for k in REFERENCE_RUN))

    out, text = _example_runs(RHE_DOM, prefix,
                              os.path.join(d, "multi.annot"))
    gap, atol = _check_envelope("RHE-DOM", out)
    s_gpu = out["cuda"]["sigma_ests_total"]
    s_cpu = out["cpu"]["sigma_ests_total"]
    goldens = [os.path.join(ROOT, "example", "outputs", *sub,
                            "no_streaming_bin_8.txt")
               for sub in (("rhe_dom",), ("reference", "rhe_dom"))]
    for device, t in text.items():
        for path in goldens:
            _check_report_overlap(f"RHE-DOM {device}", _estimates(t), path)
    log(f"[6 small] RHE-DOM example, 8 bins: max |sigma cuda - cpu| "
        f"{gap:.3e} (atol {atol:.3e}); sigma2_e cuda {s_gpu[-1]:.8f} "
        f"cpu {s_cpu[-1]:.8f}; both within SE overlap of "
        + " and ".join(os.path.relpath(p, ROOT) for p in goldens))
    _small_genie(d, prefix)


def _small_genie(d, prefix):
    """GENIE G+GxE+NxE on the example with 8 bins, as
    example/configs/genie/no_streaming_bin_8.txt sets it (B = 20, J = 100,
    seed 42): card against CPU and both goldens; then that config through
    the CLI on the card with --trace, against the reference's trace
    files."""
    from pyrhe_tpu_torch import GENIE
    name = "no_streaming_bin_8"
    out, text = _example_runs(GENIE, prefix, os.path.join(d, "multi.annot"),
                              env_file=prefix + ".env",
                              genie_model="G+GxE+NxE", num_random_vec=20)
    gap, atol = _check_envelope("GENIE", out)
    goldens = [os.path.join(ROOT, "example", "outputs", *sub, f"{name}.txt")
               for sub in (("genie",), ("reference", "genie"))]
    est = {device: _estimates(t) for device, t in text.items()}
    for device in est:
        for path in goldens:
            _check_report_overlap(f"GENIE {device}", est[device], path)
    log(f"[6 small] GENIE G+GxE+NxE example, 8 bins, {len(est['cuda'])} "
        f"estimates: max |sigma cuda - cpu| {gap:.3e} (atol {atol:.3e}); "
        f"Sigma^2_nxe[0] cuda {est['cuda']['Sigma^2_nxe[0]'][0]:.8f} cpu "
        f"{est['cpu']['Sigma^2_nxe[0]'][0]:.8f}; both within SE overlap of "
        + " and ".join(os.path.relpath(p, ROOT) for p in goldens))

    with open(os.path.join(ROOT, "example", "configs", "genie",
                           f"{name}.txt")) as f:
        cfg_text = f.read()
    report = os.path.join(d, "cli_genie_trace.txt")
    cfg = os.path.join(d, "genie_trace.txt")
    with open(cfg, "w") as f:
        f.write(cfg_text.replace(f"output = outputs/genie/{name}.txt",
                                 f"output = {report}")
                .replace("trace = no", "trace = yes"))
    tdir = os.path.join(d, "trace")
    os.makedirs(tdir)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.cli", "--config",
                    cfg, "--trace_dir", tdir, "--device", "cuda",
                    "--suppress"], check=True, cwd=d,
                   env={**os.environ, "PYTHONPATH": ROOT})
    with open(report) as f:
        cli_est = _estimates(f.read())
    if cli_est != est["cuda"]:
        raise AssertionError("GENIE CLI --config on the card reports other "
                             "estimates than GENIE(...) on the card")
    ref_dir = os.path.join(ROOT, "example", "outputs", "reference", "trace",
                           "genie", name)
    _check_trace(tdir, ref_dir)
    log(f"[6 small] GENIE CLI --config {name} --trace on the card: "
        f"{time.perf_counter() - t0:.1f} s wall; estimates equal to "
        f"GENIE(...)'s; .MN byte-identical to, .tr within rtol 2e-3 / atol "
        f"0.5 of {os.path.relpath(ref_dir, ROOT)}; .all.tr written")


def _read_tr(path):
    """(header, LD sums per row, jackknife SNP count per row) of a .tr."""
    with open(path) as f:
        header = f.readline().strip()
        rows = [line.strip().split(",") for line in f if line.strip()]
    return (header, np.array([[float(x) for x in r[:-1]] for r in rows]),
            [int(float(r[-1])) for r in rows])


def _check_trace(tdir, ref_dir):
    """tests/test_golden_example.py's trace contract: .MN byte-identical;
    .tr header and SNP counts exact, LD sums within rtol 2e-3, atol 0.5."""
    stem = "run_test.pheno"
    with open(os.path.join(tdir, stem + ".MN")) as a, open(
            os.path.join(ref_dir, stem + ".MN")) as b:
        if a.read() != b.read():
            raise AssertionError(f"{stem}.MN differs from {ref_dir}'s")
    got_h, got_v, got_n = _read_tr(os.path.join(tdir, stem + ".tr"))
    ref_h, ref_v, ref_n = _read_tr(os.path.join(ref_dir, stem + ".tr"))
    if got_h != ref_h or got_n != ref_n or got_v.shape != ref_v.shape:
        raise AssertionError(f"{stem}.tr header, counts or shape differ "
                             f"from {ref_dir}'s")
    if not np.allclose(got_v, ref_v, rtol=2e-3, atol=0.5):
        raise AssertionError(f"{stem}.tr LD sums differ from {ref_dir}'s by "
                             f"up to {np.abs(got_v - ref_v).max():.3e}")
    if not os.path.exists(os.path.join(tdir, stem + ".all.tr")):
        raise AssertionError(f"GENIE wrote no {stem}.all.tr")


def main():
    t_start = time.perf_counter()
    phase_env()
    import torch
    from pyrhe_tpu_torch.ops import kernels as K
    phase_build()
    kres = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_") as d:
        prefix, launches, phase4 = phase_main(d)
        for name, n in phase_modes(prefix, phase4).items():
            launches[name] += n
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_ex_") as d:
        phase_small(d)
        phase_exports(d, os.path.join(d, "test"))
    src = os.path.relpath(K._SRC, ROOT)
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": REPLACES[name], "launches": launches[name],
        **kres[name]} for name in K.KERNELS]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
