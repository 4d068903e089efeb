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
   and each kernel's bound, for split2 and (`bf16_*` keys) bf16, all
   from pyrhe_tpu_torch.bench.kernels.measure (the rows of `python -m
   pyrhe_tpu_torch.bench.kernels`, the same timer): the
   larger of its bytes (inputs read once, outputs written once) over 3.35
   TB/s and its flops over the peak for the operand type (989 TF/s bf16
   on the tensor cores, 67 TF/s f32), H100 SXM at 700 W. gp is timed
   again on a C built as the main path builds it (mask column + probes,
   ops/moments._stage1_cols; `ms_main_path_c`) and on GENIE's (mask
   column + three env variants of the probes, 128 split columns;
   `ms_genie_c`) and on phase 9's merged sweep group's (mask column +
   probes + 10 traits, 62 split columns; `ms_sweep_c`), ytg and ytg² at
   RHE-DOM's 640 split rows (the g-side columns of both components;
   `ms_main_path_rows`), ytg at GENIE's 960
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
6. cross-check on the example dataset (N = 5000, M = 10000, written by
   pyrhe_tpu_torch.make_example): RHE (1 bin),
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
   whose trace must hold the kernels' device events;
8. checkpoint/resume and the sharded path on the phase-4 cohort:
   checkpointed streaming RHE (checkpoint_every 10) crashed at its 5th
   commit, resumed from block 50 (totals.npz's own next_j), bitwise equal to
   phase 4's streaming run, then a done-resume that reads no block and
   launches nothing; RHE-DOM cache_blocks=40 (hybrid; 10 when the temp disk
   lacks room for 40 block files of 128 MB) crashed mid pass 2 and RHE
   float64 streaming crashed mid pass 1, each resumed bitwise equal to
   phase 5's run; Engine.run_sharded() at world size 1 through an NCCL
   process group in this process for RHE cached and streaming and GENIE
   streaming, bitwise equal to phase 4's sequential runs, and a sharded
   checkpointed run crashed and resumed; with two or more cards, the CLI
   in two NCCL ranks under torchrun. Prints the commits, the seconds of
   snapshot I/O and the bytes on disk;
9. the phenotype sweep (pyrhe_tpu_torch.sweep_phenotypes) on the phase-4
   cohort: 13 phenotype files made from its phenotype (10 complete ones
   of known h2, 2 sharing one NA set, 1 with another) through run_sweep
   in this process, cached, with the launch counts set to 0 before and
   read after: 3 genome passes, each peak within 10 % of phase 4's cached
   RHE; the merged traits equal to StreamingRHE runs of two of the files
   alone (rtol 1e-6, the gap printed), every complete file's h2 within 3
   SE of its truth, every report parsed; `python -m
   pyrhe_tpu_torch.sweep_phenotypes --streaming` (in a process of its own,
   beside those runs) equal to it bitwise; the host seconds of grouping,
   merging and reading. Then, on the example dataset of phase 6, `python
   -m` runs of
   utils.generate_annot, simulate_pheno and utils.add_cov_pheno, and RHE
   on the card re-estimating the simulated sigma^2 within 3 SE;
10. the measurement tools (pyrhe_tpu_torch.bench), each run as `python -m`
   in a process of its own on the card, on the phase-4 cohort where they
   read data: matvec (narrow and wide; then with BENCH_DOM=1), kernels,
   e2e RHE cached and streaming with --repeats 2, host_read at 1, 2, 4 and
   8 threads, staging at 1 and 4 streams from pinned and pageable memory.
   Each tool's JSON line is printed and must name this card, hold only
   finite positive numbers (sigma^2 aside) and no mfu_pct or share of a
   bound over 100; matvec's acc body must equal its standard body bitwise,
   e2e's sigma^2 must equal phase 4's runs bitwise in every repeat, and
   every repeat's samples must be there;
11. the example workflow on the card: the example dataset written by
   `python -m pyrhe_tpu_torch.make_example` in a process of its own, then
   each of the 12 shipped configs (example/configs/{rhe,rhe_dom,genie}/
   {no_streaming,streaming}_bin_{1,8}.txt) through
   pyrhe_tpu_torch.cli.cli_entry in this process, on the card, from the
   data directory, each config's output redirected into it, with the
   launch counts set to 0 before the runs and read after them: every
   estimate within SE overlap and 3e-4·max(1, |golden|) of
   example/outputs/<model>/<name>.txt and within SE overlap of the
   reference implementation's output (example/outputs/reference; GENIE
   streaming against its cached run, as the reference's StreamingGENIE
   deadlocks), each streaming report equal to its no_streaming twin's on
   every printed estimate and SE, all six kernels launched; then the
   two-trait test.pheno.multi through rhe/no_streaming_bin_1 on the card
   and on the CPU: two traits each, sigma^2 and h2 on the card within the
   split2 envelope (3e-4) of the CPU's. Prints each run's wall time and
   the phase's.

The last two lines are a JSON object of per-kernel results (launches:
the counted runs of phases 4, 5, 8, 9 and 11) and the
{"ok": true, "device": ...} line.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

GENIE_COMPS = (("add", None), ("add", 0), ("add", 1))   # G + 2 GxE
# Reference implementation's run on the example dataset (values and SEs),
# as in tests/test_golden_example.py REFERENCE_RUN.
REFERENCE_RUN = {
    "sigma2_g0": (0.19463871297400007, 0.028870559402243593),
    "sigma2_e": (0.8097914438786151, 0.0288719996107502),
    "h2_g0": (0.19378023613299408, 0.028743496038605126),
}
SPLIT2_RTOL = 3e-4               # tests/test_engine_vs_oracle.py envelope
BF16_RTOL_SIG, BF16_RTOL_H2 = 3e-2, 2e-2   # its bf16 envelope
# Phase 9: the complete phenotype files' genetic shares a_f (truth total
# h2 0.4 a_f on the phase-4 cohort), hence T = 10 traits in one pass.
SWEEP_A = np.linspace(0.25, 1.0, 10)
SWEEP_T = len(SWEEP_A)
SWEEP_RTOL = 1e-6                # merged trait vs the file run alone
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


def phase_kernels():
    import torch
    # the timer, bounds and shapes of python -m pyrhe_tpu_torch.bench.kernels
    from pyrhe_tpu_torch.bench.kernels import (M_PAD, N_PAD, QR, W,
                                               max_abs_err, measure,
                                               random_words)
    from pyrhe_tpu_torch.bench.timing import bound, median_ms, nbytes
    from pyrhe_tpu_torch.ops import kernels as K
    from pyrhe_tpu_torch.ops.moments import _hilo, _stage1_cols

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    words = random_words(gen, M_PAD, N_PAD, 1000, dev)
    # the yardstick's operands, decoded beforehand (not timed)
    dense = {sq: K.decode_words(words, sq) for sq in (False, True)}
    C = torch.randn(N_PAD, W, device=dev, generator=gen)
    Yt = torch.randn(QR, M_PAD, device=dev, generator=gen)
    Yt[:, 1000:] = 0.0
    Q = QR // 2
    Yh = _hilo(Yt[:Q], 0).contiguous()                   # (320, m) bf16
    Yb = Yt[:Q].to(torch.bfloat16).contiguous()          # (160, m) bf16
    res = {}

    def record(name, case, err, **extra):
        """Errors over every case; extra keys of the split case (the
        float32 main path on the card) and, under bf16_* keys, of the
        unsplit bf16 case (the bf16 main path). Their times come from
        bench.kernels.measure at the end of the phase."""
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if case == "split":
            r.update(extra)
        elif case == "bf16":
            r.update({f"bf16_{k}": v for k, v in extra.items()},
                     bf16_max_abs_err=err)

    words_b = nbytes(words)
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
            err = max_abs_err(f"{name} {case}", got, ref)
            # against float64: the kernel and the plain f32 product
            r64 = dense[square].double() @ C.double()
            e64 = {}
            for who, x in (("kernel", got), ("plain", ref)):
                x = x[:, :W] + x[:, W:] if split else x
                e64[who] = (x.double() - r64).abs().max().item()
            rel = r64.abs().max().item()
            record(name, case, err, err_vs_f64=e64["kernel"])
            log(f"[3 kernels] {name} {case} C {tuple(Cop.shape)} "
                f"{Cop.dtype}: max abs err vs plain {err:.3e}; vs float64 "
                f"kernel {e64['kernel']:.3e}, plain f32 {e64['plain']:.3e} "
                f"(max |ref| {rel:.3e}); bitwise repeatable")

    # gp on the main path's C: [valid mask | Z | Uzb | y] (1 + 21 columns)
    perm = torch.as_tensor(K.plane_permutation(N_PAD), device=dev)
    mask_col = (perm < 100_000).float()[:, None]
    P = torch.randn(N_PAD, 21, device=dev, generator=gen) * mask_col
    _, C_main = _stage1_cols((("add", None),), P, None, mask_col)
    C_main = _hilo(C_main, 1).contiguous()
    for square in (False, True):
        name = "gp_matmul_square" if square else "gp_matmul"
        got = K.gp_matmul(words, C_main, square)
        err = max_abs_err(f"{name} main-path C", got,
                          K.gp_plain(words, C_main, square))
        ms = median_ms(lambda: K.gp_matmul(words, C_main, square))
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
    err = max_abs_err("gp_matmul GENIE C", K.gp_matmul(words, C_genie),
                      K.gp_plain(words, C_genie))
    ms = median_ms(lambda: K.gp_matmul(words, C_genie))
    res["gp_matmul"]["ms_genie_c"] = ms
    bound_ms, by = bound(words_b + nbytes(C_genie) + M_PAD * C_genie.shape[1]
                         * 4, 2 * M_PAD * N_PAD * C_genie.shape[1],
                         C_genie.dtype)
    log(f"[3 kernels] gp_matmul on GENIE's C {tuple(C_genie.shape)} "
        f"{C_genie.dtype}: max abs err vs plain {err:.3e}; kernel "
        f"{ms:.4f} ms, bound {bound_ms * 1e3:.1f} us ({by}, "
        f"{100 * bound_ms / ms:.2f} % of it)")
    # gp on phase 9's merged sweep group: [mask | Z | Uzb | 10 traits]
    P_sweep = torch.randn(N_PAD, 20 + SWEEP_T, device=dev,
                          generator=gen) * mask_col
    _, C_sweep = _stage1_cols((("add", None),), P_sweep, None, mask_col)
    # a column's result at the merged width against the width of a
    # single-trait run (mask, 20 probe columns, one trait), halves summed
    # as ops/moments._stage1 sums them
    def gp_split2(C):
        out = K.gp_matmul(words, _hilo(C, 1).contiguous())
        return out[:, :C.shape[1]] + out[:, C.shape[1]:]
    same = torch.equal(gp_split2(C_sweep)[:, :22],
                       gp_split2(C_sweep[:, :22]))
    C_sweep = _hilo(C_sweep, 1).contiguous()
    err = max_abs_err("gp_matmul sweep C", K.gp_matmul(words, C_sweep),
                      K.gp_plain(words, C_sweep))
    ms = median_ms(lambda: K.gp_matmul(words, C_sweep))
    res["gp_matmul"]["ms_sweep_c"] = ms
    bound_ms, by = bound(words_b + nbytes(C_sweep) + M_PAD * C_sweep.shape[1]
                         * 4, 2 * M_PAD * N_PAD * C_sweep.shape[1],
                         C_sweep.dtype)
    log(f"[3 kernels] gp_matmul on the {SWEEP_T}-trait sweep group's C "
        f"{tuple(C_sweep.shape)} {C_sweep.dtype}: max abs err vs plain "
        f"{err:.3e}; kernel {ms:.4f} ms, bound {bound_ms * 1e3:.1f} us "
        f"({by}, {100 * bound_ms / ms:.2f} % of it); its first 22 columns "
        f"bitwise equal to gp at 44 split columns: {same}")

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
            err = max_abs_err(f"{name} {case}", got, ref)
            # against float64 of the f32 Yt: the kernel and the plain f32
            # product (split: the two halves summed)
            r64 = (Yt if case == "f32" else Yt[:Q]).double() @ dense[
                square].double()
            e64 = {who: (K.sum_halves(x, split).double() - r64).abs().max()
                   .item() for who, x in (("kernel", got), ("plain", ref))}
            rel = r64.abs().max().item()
            del r64
            record(name, case, err, err_vs_f64=e64["kernel"])
            log(f"[3 kernels] {name} {case} Yt {tuple(Yop.shape)} "
                f"{Yop.dtype}: max abs err vs plain {err:.3e}; vs float64 "
                f"kernel {e64['kernel']:.3e}, plain f32 {e64['plain']:.3e} "
                f"(max |ref| {rel:.3e}); bitwise repeatable")
        max_abs_err(f"{name} Yt {tuple(Y640.shape)}",
                    K.ytg_matmul(words, Y640, square),
                    K.ytg_plain(words, Y640, square))
        ms = median_ms(lambda: K.ytg_matmul(words, Y640, square))
        res[name]["ms_main_path_rows"] = ms
        log(f"[3 kernels] {name} at the RHE-DOM main path's "
            f"{Y640.shape[0]} split rows: kernel {ms:.4f} ms")
    # GENIE's stage 2 over g: G and two GxE components, 3 x 160 rows
    Y960 = torch.randn(3 * Q, M_PAD, device=dev, generator=gen)
    Y960[:, 1000:] = 0.0
    Y960 = _hilo(Y960, 0).contiguous()
    err = max_abs_err(f"ytg_matmul Yt {tuple(Y960.shape)}",
                      K.ytg_matmul(words, Y960), K.ytg_plain(words, Y960))
    ms = median_ms(lambda: K.ytg_matmul(words, Y960))
    res["ytg_matmul"]["ms_genie_rows"] = ms
    bound_ms, by = bound(words_b + nbytes(Y960) + Y960.shape[0] * N_PAD * 4,
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
            err = max(err, max_abs_err(f"ytg_acc_matmul {case}", got, ref))
        record("ytg_acc_matmul", case, err)
        log(f"[3 kernels] ytg_acc_matmul {case} Yt "
            f"{tuple(Yop.shape)} {Yop.dtype}: bitwise == ytg + transform "
            f"(scales: env row, ones, random); max abs err vs plain "
            f"{err:.3e}")
    tot = tot0.clone()
    ms = median_ms(lambda: K.ytg_acc_matmul(
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
        err = max_abs_err(f"ytg_acc2_matmul {case}", got, ref)
        record("ytg_acc2_matmul", case, err)
        log(f"[3 kernels] ytg_acc2_matmul {case} Yt1, Yt2 "
            f"{tuple(Y1.shape)} {Y1.dtype}: bitwise == two ytg + transform;"
            f" max abs err vs plain {err:.3e}")
    del dense
    torch.cuda.empty_cache()

    # the split2 and bf16 times and bounds: python -m
    # pyrhe_tpu_torch.bench.kernels's rows, from the same function
    for row in measure(dev):
        pre = "" if row["layout"] == "split2" else "bf16_"
        res[row["name"]].update(
            {pre + k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
            **{pre + "bound_share": row["bound_pct"] / 100})
        log(f"[3 kernels] {row['name']} {row['layout']}: kernel "
            f"{row['ms']:.4f} ms (quartiles {row['ms_q1']:.4f}-"
            f"{row['ms_q3']:.4f}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms'] * 1e3:.1f} "
            f"us ({row['bound_by']}, {row['bound_pct']:.2f} % of it)")
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
    sigma_ests_total, h2_total), "cached_peak_gb": the cached run's peak
    device memory}); the streaming run takes the host block
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
    out["cached_peak_gb"] = pt_c["peak_gb"]
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
    one staged block. Returns the bf16 path's launch counts and {"f64
    streaming" | "dom hybrid": (T_all, q_all, sigma, h2)}."""
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
    return launches, {"f64 streaming": f64[True], "dom hybrid": hybrid}


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


@contextlib.contextmanager
def _crashing(n_allowed=None, phase_at=None):
    """Every Checkpoint of this process raises "simulated crash" at its
    commit after n_allowed successful ones, or at the commit of (phase,
    next_j) phase_at; the body must crash."""
    from pyrhe_tpu_torch.core.checkpoint import Checkpoint
    real = Checkpoint.commit
    seen = [0]

    def commit(self, phase, next_j):
        if (phase, next_j) == phase_at or (n_allowed is not None
                                            and seen[0] >= n_allowed):
            raise RuntimeError("simulated crash")
        seen[0] += 1
        real(self, phase, next_j)

    Checkpoint.commit = commit
    try:
        yield
    except RuntimeError as e:
        if "simulated crash" not in str(e):
            raise
    else:
        raise AssertionError("the checkpointed run did not crash")
    finally:
        Checkpoint.commit = real


@contextlib.contextmanager
def _snapshot_io():
    """Wall seconds and count of every checkpoint save and commit of this
    process inside the body: {"s": seconds, "commits": n}."""
    from pyrhe_tpu_torch.core.checkpoint import Checkpoint
    out = {"s": 0.0, "commits": 0}
    names = ("save_totals", "save_assemble", "save_results", "commit")
    real = {n: getattr(Checkpoint, n) for n in names}

    def timed(n):
        def call(self, *a):
            t0 = time.perf_counter()
            try:
                return real[n](self, *a)
            finally:
                out["s"] += time.perf_counter() - t0
                out["commits"] += n == "commit"
        return call

    for n in names:
        setattr(Checkpoint, n, timed(n))
    try:
        yield out
    finally:
        for n in names:
            setattr(Checkpoint, n, real[n])


def _du(path) -> int:
    """Bytes of the files under path."""
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def _spy_loads(eng):
    """The block indices eng reads, in order."""
    loaded = []
    orig = eng._load_block

    def spy(j):
        loaded.append(j)
        return orig(j)

    eng._load_block = spy
    return loaded


def _results(model, res=None):
    """(T_all, q_all, sigma, h2) of a model that ran; res its report."""
    eng = model.engine
    if res is None:
        return eng.T_all, eng.q_all
    return (eng.T_all, eng.q_all, np.asarray(res["sigma_ests_total"]),
            np.asarray(res["h2_total"]))


def _assert_same4(label, got, want):
    """(T_all, q_all, sigma, h2) bitwise equal."""
    _assert_same(label, got, want)
    for name, a, b in (("sigma^2", got[2], want[2]), ("h2", got[3], want[3])):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: {name} {a} != {b}")


class _Launches:
    """Launch counts summed over the runs of phase 8, each run's set to 0
    just before it and read just after."""

    def __init__(self):
        from pyrhe_tpu_torch.ops import kernels as K
        self.K = K
        self.total = dict.fromkeys(K.KERNELS, 0)

    def run(self, label, fn, kernels=()):
        """fn() with the counts set to 0 before and read after (also when
        fn raises: a crashed run's launches count too); every kernel in
        kernels must have launched. Returns (fn(), counts)."""
        self.K.reset_launch_counts()
        try:
            out = fn()
        finally:
            counts = dict(self.K.launches)
            for name, n in counts.items():
                self.total[name] += n
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched "
                                 f"({counts})")
        return out, counts


def phase_checkpoint(d, prefix, phase4, phase5):
    """8. Checkpoint/resume and the sharded path on the card, at the phase-4
    cohort: (a) checkpointed streaming RHE (checkpoint_every 10) crashed at
    its 5th commit, resumed from totals.npz's block 50 and bitwise equal to
    phase 4's streaming run, then a done-resume that reads no block; (b)
    RHE-DOM cache_blocks=40 (hybrid; 10 when the temp disk lacks room for
    40 block files) crashed mid pass 2 and resumed, bitwise equal to phase
    5's hybrid run (phase 4's cached one at 10), and RHE float64 streaming
    crashed mid pass 1 and resumed, bitwise equal to phase 5's; (c)
    Engine.run_sharded() at world size 1 through an NCCL process group in
    this process for RHE cached and streaming and GENIE streaming, each
    bitwise equal to phase 4's sequential run with every kernel of its path
    launched, and a sharded checkpointed run crashed and resumed; (d) with
    two or more cards, the CLI in two NCCL ranks under torchrun within the
    split2 envelope of phase 4's streaming RHE. Returns the phase's launch
    counts."""
    import shutil

    import torch
    from pyrhe_tpu_torch import (RHE, RHE_DOM, StreamingGENIE, StreamingRHE,
                                 cohort)
    from pyrhe_tpu_torch.ops import kernels as K
    from pyrhe_tpu_torch.parallel import distributed
    tag = "[8 ckpt]"
    count = _Launches()
    additive = ("gp_matmul", "ytg_matmul", "ytg_acc_matmul")
    every = dict(checkpoint_every=10)

    # (a) streaming RHE: crash at the 5th commit (pass 1, block 50)
    ck = os.path.join(d, "ck_rhe")
    t0 = time.perf_counter()
    with _snapshot_io() as io, _crashing(n_allowed=4):
        count.run("(a) crash", lambda: cohort.model(
            StreamingRHE, prefix, checkpoint_dir=ck, **every)(trait=0))
    t_crash, on_disk = time.perf_counter() - t0, _du(ck)
    model = cohort.model(StreamingRHE, prefix, checkpoint_dir=ck, **every)
    loaded = _spy_loads(model.engine)
    with _snapshot_io() as io2:
        res, _ = count.run("(a) resume", lambda: model(trait=0), additive)
    if loaded[:50] != list(range(50, 100)):
        raise AssertionError(f"(a) resumed pass 1 read {loaded[:50]}, not "
                             "blocks 50..99")
    _assert_same4("(a) resumed streaming RHE vs phase 4", _results(model, res),
                  phase4["RHE"]["streaming"])
    pt = model.engine.phase_times
    done = cohort.model(StreamingRHE, prefix, checkpoint_dir=ck, **every)
    loaded = _spy_loads(done.engine)
    res, counts = count.run("(a) done-resume", lambda: done(trait=0))
    if loaded or any(counts.values()):
        raise AssertionError(f"(a) done-resume read blocks {loaded}, "
                             f"launched {counts}")
    _assert_same4("(a) done-resume vs phase 4", _results(done, res),
                  phase4["RHE"]["streaming"])
    log(f"{tag} (a) StreamingRHE checkpoint_every 10: crash at the 5th "
        f"commit after {t_crash:.1f} s ({io['commits']} commits, snapshot "
        f"I/O {io['s']:.3f} s, {io['s'] / max(io['commits'], 1):.3f} s a "
        f"commit; {on_disk / 1e6:.1f} MB on disk); resume from block 50: "
        f"pass 1 {pt['pass1_s']:.3f} s, pass 2 {pt['pass2_s']:.3f} s, "
        f"snapshot I/O {io2['s']:.3f} s over {io2['commits']} commits, "
        f"{_du(ck) / 1e6:.1f} MB on disk; T, q, sigma^2, h2 == phase 4 "
        "streaming bitwise; done-resume: no block read, no launch, equal")
    shutil.rmtree(ck)

    # (b) RHE-DOM hybrid crashed mid pass 2 at sample 30, RHE float64
    # streaming crashed mid pass 1 at block 30
    per_block = 2 * 8 * 20 * 100352 * 4
    keep = 40 if shutil.disk_usage(d).free > 2 * 40 * per_block else 10
    want = (phase5["dom hybrid"] if keep == 40
            else phase4["RHE-DOM"]["cached"])
    for label, cls, kw, crash, first, want, kernels in (
            (f"RHE-DOM cache_blocks={keep}", RHE_DOM, dict(cache_blocks=keep),
             dict(phase_at=("assemble", 30)), 30, want, K.KERNELS[:4]),
            ("RHE float64 streaming", StreamingRHE, dict(dtype="float64"),
             dict(n_allowed=2), 30, phase5["f64 streaming"], ())):
        ck = os.path.join(d, "ck_b")
        t0 = time.perf_counter()
        with _snapshot_io() as io, _crashing(**crash):
            count.run(f"(b) {label} crash", lambda: cohort.model(
                cls, prefix, checkpoint_dir=ck, **every, **kw)(trait=0))
        t_crash, on_disk = time.perf_counter() - t0, _du(ck)
        model = cohort.model(cls, prefix, checkpoint_dir=ck, **every, **kw)
        loaded = _spy_loads(model.engine)
        t0 = time.perf_counter()
        res, _ = count.run(f"(b) {label} resume", lambda: model(trait=0),
                           kernels)
        t_res = time.perf_counter() - t0
        expect = list(range(max(first, kw.get("cache_blocks", 0)), 100))
        if loaded[:len(expect)] != expect:
            raise AssertionError(f"(b) {label}: resume read {loaded[:5]}.., "
                                 f"not {expect[:5]}..")
        _assert_same4(f"(b) resumed {label}", _results(model, res), want)
        log(f"{tag} (b) {label}: crash after {t_crash:.1f} s ({io['commits']}"
            f" commits, snapshot I/O {io['s']:.3f} s, {on_disk / 1e9:.2f} GB "
            f"on disk); resumed from {first} in {t_res:.1f} s, bitwise == "
            + ("phase 5" if want is not phase4["RHE-DOM"]["cached"]
               else "phase 4 cached"))
        del model
        shutil.rmtree(ck)
        torch.cuda.empty_cache()

    # (c) the sharded path at world size 1 through NCCL, in this process
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                             "LOCAL_RANK", "MASTER_ADDR",
                                             "MASTER_PORT")}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    distributed.initialize("cuda", timeout_s=300)
    try:
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the process group is not NCCL")
        for label, cls, key, kw, kernels in (
                ("RHE", RHE, "cached", {}, additive[:2]),
                ("RHE", StreamingRHE, "streaming", {}, additive),
                ("GENIE", StreamingGENIE, "streaming",
                 cohort.genie_kw(prefix), additive)):
            model = cohort.model(cls, prefix, **kw)
            t0 = time.perf_counter()
            _, counts = count.run(f"(c) {label} {key}",
                                  model.engine.run_sharded, kernels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _assert_same(f"(c) sharded {label} {key} vs phase 4",
                         _results(model), phase4[label][key])
            pt = model.engine.phase_times
            log(f"{tag} (c) run_sharded world 1 (NCCL) {cls.__name__}: "
                f"{wall:.3f} s (pass 1 {pt['pass1_s']:.3f}, pass 2 "
                f"{pt['pass2_s']:.3f}); T, q == phase 4 {key} bitwise; "
                f"launches {counts}")
            del model
            torch.cuda.empty_cache()
        ck = os.path.join(d, "ck_c")
        with _crashing(n_allowed=2):
            count.run("(c) sharded crash", lambda: cohort.model(
                StreamingRHE, prefix, checkpoint_dir=ck,
                **every).engine.run_sharded())
        model = cohort.model(StreamingRHE, prefix, checkpoint_dir=ck, **every)
        loaded = _spy_loads(model.engine)
        count.run("(c) sharded resume", model.engine.run_sharded, additive)
        if loaded[:70] != list(range(30, 100)):
            raise AssertionError(f"(c) sharded resume read {loaded[:5]}..")
        _assert_same("(c) sharded resumed vs phase 4", _results(model),
                     phase4["RHE"]["streaming"])
        if not os.path.isdir(os.path.join(ck, "shard_0_of_1")):
            raise AssertionError("(c) no per-rank checkpoint directory")
        log(f"{tag} (c) sharded StreamingRHE crashed at its 3rd commit, "
            "resumed from block 30 (shard_0_of_1): == phase 4 bitwise")
        del model
        shutil.rmtree(ck)
    finally:
        distributed.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (d) two NCCL ranks: needs two cards
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"{tag} (d) two NCCL ranks under torchrun: not run, {n_cards} "
            "CUDA card visible (each rank needs a card of its own)")
        return count.total
    from parse_output import parse_output_file
    report = os.path.join(d, "cli_rhe_torchrun.txt")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "pyrhe_tpu_torch.cli",
         *cohort.cli_args(prefix), "--streaming", "-o", report,
         "--suppress"], check=True, cwd=ROOT, timeout=600)
    got = parse_output_file(report)
    sig = np.array([g["value"] for g in got["sigma2_g"]]
                   + [got["sigma2_e"]["value"]])
    want = phase4["RHE"]["streaming"][2]
    atol = SPLIT2_RTOL * np.abs(want).max()
    if not np.all(np.abs(sig - want) <= atol + SPLIT2_RTOL * np.abs(want)):
        raise AssertionError(f"(d) two ranks sigma {sig} vs {want}")
    log(f"{tag} (d) CLI in two NCCL ranks (torchrun): "
        f"{time.perf_counter() - t0:.1f} s wall; sigma^2 within the split2 "
        f"envelope of phase 4 (max gap {np.abs(sig - want).max():.3e})")
    return count.total


@contextlib.contextmanager
def _wrapped(obj, name, wrap):
    """obj.name replaced by wrap(the original) inside the body."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def _timed(seconds, key):
    """A wrap for _wrapped: each call's wall seconds add to seconds[key],
    and seconds[key + "_n"] counts the calls."""
    def wrap(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[key] = seconds.get(key, 0.0) + (time.perf_counter()
                                                        - t0)
                seconds[key + "_n"] = seconds.get(key + "_n", 0) + 1
        return call
    return wrap


def _sweep_files(prefix, d):
    """Phase 9's 13 phenotype files, made from the cohort's phenotype y by
    a seeded numpy generator: p00..p09 complete, y_f = sqrt(a_f) y +
    sqrt(1 - a_f) e_f with a_f from SWEEP_A (y has variance ~1 and h2 0.4,
    so y_f's total h2 is 0.4 a_f); q0 and q1 with the same 50 NA rows; r0
    with 50 other NA rows. Returns their directory."""
    from pyrhe_tpu_torch.io.readers import read_pheno
    y = read_pheno(prefix + ".pheno")[0][:, 0]
    n = y.size
    rng = np.random.default_rng(2026)
    rows = rng.choice(n, 100, replace=False).tolist()
    pdir = os.path.join(d, "phenos")
    os.makedirs(pdir)

    def write(name, a, na=frozenset()):
        v = np.sqrt(a) * y + np.sqrt(1.0 - a) * rng.standard_normal(n)
        with open(os.path.join(pdir, name + ".pheno"), "w") as f:
            f.write("FID IID pheno\n")
            f.writelines(f"{i} 1 NA\n" if i in na else f"{i} 1 {v[i]:.6g}\n"
                         for i in range(n))

    for f, a in enumerate(SWEEP_A):
        write(f"p{f:02d}", a)
    write("q0", 0.5, frozenset(rows[:50]))
    write("q1", 0.75, frozenset(rows[:50]))
    write("r0", 0.5, frozenset(rows[50:]))
    return pdir


def phase_sweep(d, prefix, phase4):
    """9. The phenotype sweep on the phase-4 cohort: 13 files (_sweep_files)
    through run_sweep in this process, cached, with the launch counts set
    to 0 before and read after and Engine.precompute counted: exactly 3
    genome passes (10 merged complete traits, the 2 files of one NA set,
    the file of another), each pass's peak device memory within 10 % of
    phase 4's cached RHE; then StreamingRHE alone on the last complete
    file (the merged pass's 10th trait column) and on q0 (their counts
    read too), each within rtol 1e-6 of its merged trait (sigma^2, SE, h2;
    the largest gap printed); every complete file's total h2
    within 3 SE of 0.4 a_f; every report parsing to the summary's sigma^2;
    `python -m pyrhe_tpu_torch.sweep_phenotypes --streaming` over the same
    files equal to the cached sweep bitwise. Prints the host seconds of
    grouping, merging and the load's re-read, each pass's wall, peak and gp
    split width, and the first file's runtime beside the others' mean.
    Returns (the launch counts, the phase's seconds)."""
    import torch
    from pyrhe_tpu_torch import Logger, StreamingRHE, cohort
    from pyrhe_tpu_torch import sweep_phenotypes as sweep
    from pyrhe_tpu_torch.core import data as core_data
    from pyrhe_tpu_torch.core.engine import Engine
    from pyrhe_tpu_torch.ops import kernels as K
    from parse_output import parse_output_file
    tag = "[9 sweep]"
    t_start = time.perf_counter()
    log(f"{tag} device memory allocated before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    pdir = _sweep_files(prefix, d)
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(pdir))
    log(f"{tag} wrote {len(names)} phenotype files of {cohort.N} rows in "
        f"{time.perf_counter() - t_start:.2f} s")
    common = ["-g", prefix, "-annot", prefix + ".annot", "-c",
              prefix + ".cov", "--pheno_glob", os.path.join(pdir, "*.pheno"),
              "-k", str(cohort.PROBES), "-jn", str(cohort.JACK), "--seed",
              str(cohort.SEED)]
    host, passes = {}, []

    def counted(fn):                      # Engine.precompute
        def call(self):
            passes.append({"T": self.T_traits,
                           "width": 2 * (1 + self.static.P.shape[1])})
            return fn(self)
        return call

    def measured(fn):                     # Engine.run_precompute_and_assemble
        def call(self):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(self)
            torch.cuda.synchronize()
            passes[-1].update(
                wall=time.perf_counter() - t0,
                pass1=self.phase_times["pass1_s"],
                pass2=self.phase_times["pass2_s"],
                peak=torch.cuda.max_memory_allocated() / 1e9)
            return out
        return call

    out_c = os.path.join(d, "sweep_cached")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _wrapped(sweep, "group_pheno_files", _timed(host, "group")), \
            _wrapped(sweep, "merge_pheno_files", _timed(host, "merge")), \
            _wrapped(core_data, "read_pheno", _timed(host, "load_read")), \
            _wrapped(Engine, "precompute", counted), \
            _wrapped(Engine, "run_precompute_and_assemble", measured):
        summary = sweep.run_sweep(sweep.build_parser().parse_args(
            [*common, "-o", out_c]))
    t_sweep = time.perf_counter() - t0
    launches = {"sweep": dict(K.launches)}
    if [p["T"] for p in passes] != [SWEEP_T, 2, 1]:
        raise AssertionError(f"{len(names)} files ran {len(passes)} genome "
                             f"passes of {[p['T'] for p in passes]} traits, "
                             f"not 3 of [{SWEEP_T}, 2, 1]")
    if sorted(summary) != names:
        raise AssertionError(f"summary keys {sorted(summary)} != {names}")
    log(f"{tag} run_sweep (cached, in process): {len(names)} files -> "
        f"{len(passes)} genome passes (Engine.precompute ran "
        f"{len(passes)} times), {t_sweep:.3f} s wall; launches "
        f"{launches['sweep']}")
    limit = 1.1 * phase4["RHE"]["cached_peak_gb"]
    for i, p in enumerate(passes):
        log(f"{tag} pass {i + 1}: {p['T']} trait(s), gp C split width "
            f"{p['width']}; both passes {p['wall']:.3f} s (pass 1 "
            f"{p['pass1']:.3f}, pass 2 {p['pass2']:.3f}); peak device memory "
            f"{p['peak']:.3f} GB (phase 4 cached RHE "
            f"{phase4['RHE']['cached_peak_gb']:.3f} GB)")
        if p["peak"] > limit:
            raise AssertionError(f"pass {i + 1} peaked at {p['peak']:.3f} GB,"
                                 f" over {limit:.3f} GB")
    first = summary["p00"]["runtime"]
    others = [summary[f"p{f:02d}"]["runtime"] for f in range(1, SWEEP_T)]
    log(f"{tag} merged group: first file's runtime {first:.3f} s (with the "
        f"shared genome pass), the other {len(others)} files' mean "
        f"{statistics.mean(others):.4f} s (max {max(others):.4f} s)")
    log(f"{tag} host I/O: group_pheno_files {host['group']:.3f} s "
        f"({len(names)} files read), merge_pheno_files {host['merge']:.3f} s "
        f"({host['merge_n']} groups written), the load's read_pheno "
        f"{host['load_read']:.3f} s ({host['load_read_n']} files)")
    for name in ("gp_matmul", "ytg_matmul"):
        if launches["sweep"][name] <= 0:
            raise AssertionError(f"{name} was never launched by the sweep")

    # the CLI's streaming sweep runs in a process of its own while this
    # one runs the solo comparisons and the checks (they share the card and
    # the host, so its walls are not the sweep's own: those are above)
    out_s = os.path.join(d, "sweep_streaming")
    t0 = time.perf_counter()
    cli = subprocess.Popen([sys.executable, "-m",
                            "pyrhe_tpu_torch.sweep_phenotypes", *common, "-o",
                            out_s, "--streaming"], cwd=ROOT)
    try:
        # StreamingRHE alone on files of the merged and of the NA-set group
        K.reset_launch_counts()
        gap = 0.0
        solo = (f"p{SWEEP_T - 1:02d}", "q0")
        for name in solo:
            model = StreamingRHE(
                geno_file=prefix, annot_file=prefix + ".annot",
                pheno_file=os.path.join(pdir, name + ".pheno"),
                cov_file=prefix + ".cov", num_jack=cohort.JACK,
                num_random_vec=cohort.PROBES, seed=cohort.SEED, device="cuda",
                log=Logger(suppress=True, debug_mode=False))
            res = model(trait=0)
            del model
            for field in ("sigma_ests_total", "sig_errs", "h2_total"):
                a = np.asarray(summary[name][field])
                b = np.asarray(res[field])
                scale = np.abs(b).max()
                if not np.allclose(a, b, rtol=SWEEP_RTOL,
                                   atol=SWEEP_RTOL * scale):
                    raise AssertionError(f"{name} {field}: merged {a} vs "
                                         f"alone {b} beyond rtol "
                                         f"{SWEEP_RTOL}")
                gap = max(gap, np.abs(a - b).max() / scale)
        launches["solo"] = dict(K.launches)
        if launches["solo"]["ytg_acc_matmul"] <= 0:
            raise AssertionError("ytg_acc_matmul was never launched by the "
                                 "streaming solo runs")
        log(f"{tag} StreamingRHE alone on {', '.join(solo)}: sigma^2, SE, h2 "
            f"== merged within rtol {SWEEP_RTOL}; largest gap {gap:.3e} "
            f"of max |value| ({'exactly 0' if gap == 0 else 'not 0'}); "
            f"launches {launches['solo']}")

        truth = sum(cohort.SIGMA)
        h2s = []
        for f, a in enumerate(SWEEP_A):
            r = summary[f"p{f:02d}"]
            h2, se = r["h2_total"][-1], r["h2_errs"][-1]
            h2s.append(f"{h2:.4f}/{truth * a:.4f}")
            if abs(h2 - truth * a) > 3 * se:
                raise AssertionError(f"p{f:02d}: total h2 {h2} (SE {se}) "
                                     f"more than 3 SE from {truth * a}")
        log(f"{tag} complete files' total h2 / truth 0.4 a_f, each within 3 "
            "SE: " + ", ".join(h2s))
        for name, r in summary.items():
            got = parse_output_file(os.path.join(out_c, name + ".txt"))
            sig = [g["value"] for g in got["sigma2_g"]] + [
                got["sigma2_e"]["value"]]
            if not np.allclose(sig, r["sigma_ests_total"], rtol=1e-9,
                               atol=0):
                raise AssertionError(f"{name}.txt: sigma^2 {sig} != "
                                     f"summary's {r['sigma_ests_total']}")
        rc = cli.wait(timeout=900)
    finally:
        if cli.poll() is None:            # a check failed: stop the CLI
            cli.kill()
            cli.wait()
    if rc != 0:
        raise subprocess.CalledProcessError(rc, cli.args)
    t_cli = time.perf_counter() - t0
    got = {}
    for out in (out_c, out_s):
        with open(os.path.join(out, "summary.json")) as f:
            got[out] = json.load(f)
    for name, r in got[out_c].items():
        for field, v in r.items():
            if field != "runtime" and got[out_s][name][field] != v:
                raise AssertionError(f"--streaming {name} {field} "
                                     f"{got[out_s][name][field]} != cached "
                                     f"{v}")
    t_phase = time.perf_counter() - t_start
    log(f"{tag} python -m pyrhe_tpu_torch.sweep_phenotypes --streaming: "
        f"{t_cli:.1f} s wall (new process, beside the solo runs); every "
        f"trait's results == the cached sweep's bitwise; every report "
        f"parses to the summary's sigma^2; sweep on the cohort "
        f"{t_phase:.1f} s")
    total = {name: launches["sweep"][name] + launches["solo"][name]
             for name in K.KERNELS}
    return total, t_phase


def phase_utilities(d, prefix):
    """9 (utilities). On the example dataset of phase 6, each as `python -m`
    in a process of its own: utils.generate_annot (8 bins, one-hot),
    simulate_pheno (sigma 0.3 over single.annot, 2 replicates) and
    utils.add_cov_pheno over its output (the standardized covariates
    added); then RHE on the card re-estimates sigma^2 of the first
    replicate within 3 SE of 0.3. Returns the seconds taken."""
    from pyrhe_tpu_torch import RHE, Logger
    from pyrhe_tpu_torch.io.readers import read_cov
    tag = "[9 sweep]"
    t_start = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": ROOT}

    def run(module, *args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"pyrhe_tpu_torch.{module}",
                            *args], check=True, cwd=d, env=env,
                           capture_output=True, text=True)
        log(f"{tag} python -m pyrhe_tpu_torch.{module}: "
            f"{r.stdout.strip().splitlines()[-1]} "
            f"({time.perf_counter() - t0:.1f} s)")

    annot = os.path.join(d, "generated.annot")
    run("utils.generate_annot", "-g", prefix, "-b", "8", "-o", annot,
        "--seed", "1")
    a = np.loadtxt(annot, dtype=np.int64, ndmin=2)
    if a.shape != (10000, 8) or not np.all(a.sum(axis=1) == 1):
        raise AssertionError(f"generate_annot wrote a {a.shape} table that "
                             "is not one-hot over 8 bins")
    sim = os.path.join(d, "sim")
    run("simulate_pheno", "-g", prefix, "-annot",
        os.path.join(d, "single.annot"), "--sigma", "0.3", "--replicates",
        "2", "--seed", "3", "-o", sim)
    run("utils.add_cov_pheno", "--pheno_dir", sim, "--cov", prefix + ".cov")
    y = np.loadtxt(os.path.join(sim, "0.phen"), skiprows=1, usecols=2)
    y_cov = np.loadtxt(os.path.join(sim, "0_with_cov.phen"), skiprows=1,
                       usecols=2)
    cov, _ = read_cov(prefix + ".cov", std=True)
    if not np.allclose(y_cov, y + cov.sum(axis=1), rtol=0, atol=1e-6):
        raise AssertionError("add_cov_pheno: 0_with_cov.phen is not 0.phen "
                             "plus the standardized covariates")
    # the estimator takes no intercept column, so the shift that
    # standardizing adds to the covariate effect would stay in the
    # residual: the replicate is re-estimated without it
    model = RHE(geno_file=prefix, annot_file=os.path.join(d, "single.annot"),
                pheno_file=os.path.join(sim, "0.phen"), num_jack=100,
                num_random_vec=10, seed=42, device="cuda",
                log=Logger(suppress=True, debug_mode=False))
    res = model(trait=0)
    sig, se = float(res["sigma_ests_total"][0]), float(res["sig_errs"][0])
    if abs(sig - 0.3) > 3 * se:
        raise AssertionError(f"simulated sigma 0.3 re-estimated as {sig} "
                             f"(SE {se}): more than 3 SE away")
    t = time.perf_counter() - t_start
    log(f"{tag} RHE on the card, replicate 0: sigma^2_g {sig:.5f} (SE "
        f"{se:.5f}) vs simulated 0.3; utilities {t:.1f} s")
    return t


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


def _estimate_lines(text):
    """[(name, value, SE)] of every estimate line of a report, in the order
    printed (RHE prints h2 and Total h2 twice: non-overlapping, then
    overlapping bins)."""
    return [(n, float(v), float(se)) for n, v, se in ESTIMATE.findall(text)]


def _estimates(text):
    """{name: (value, SE)} of every estimate line of a report's text."""
    return {name: (v, se) for name, v, se in _estimate_lines(text)}


def _check_report(label, ours, path, rtol=None):
    """ours against the report at path: the same estimate lines in the same
    order, each within SE overlap (the reference's is_within_range) and,
    when rtol is given, within rtol·max(1, |value there|)."""
    with open(path) as f:
        gold = _estimate_lines(f.read())
    if [g[0] for g in ours] != [g[0] for g in gold]:
        raise AssertionError(f"{label}: estimate lines {[g[0] for g in ours]}"
                             f" vs {[g[0] for g in gold]} in {path}")
    for (name, v, se), (_, gv, gse) in zip(ours, gold):
        if abs(v - gv) > se + gse:
            raise AssertionError(f"{label} {name} = {v} (SE {se}) outside SE "
                                 f"overlap with {gv} (SE {gse}) of {path}")
        if rtol is not None and abs(v - gv) > rtol * max(1.0, abs(gv)):
            raise AssertionError(f"{label} {name} = {v} vs {gv} of {path}: "
                                 f"more than {rtol}·max(1, |{gv}|) apart")


def phase_small(d):
    from pyrhe_tpu_torch import RHE, RHE_DOM, make_example
    prefix = make_example.main(d)
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
            _check_report(f"RHE-DOM {device}", _estimate_lines(t),
                          path)
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
            _check_report(f"GENIE {device}", _estimate_lines(text[device]),
                          path)
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


def _bench(module, *args, env=None):
    """`python -m pyrhe_tpu_torch.bench.<module> args` on the card: its last
    line as JSON, printed, after the checks every tool's line must pass
    (the card's name; every number finite and positive, the sigma
    estimates and the config's cache split aside; every mfu_pct and share
    of a bound at most 100)."""
    import torch
    from pyrhe_tpu_torch.bench.timing import finite_positive
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", f"pyrhe_tpu_torch.bench.{module}", *args],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, **(env or {})})
    if res.returncode != 0:
        raise RuntimeError(f"bench.{module} {' '.join(args)} exited "
                           f"{res.returncode}:\n{res.stderr[-3000:]}")
    line = res.stdout.strip().splitlines()[-1]
    log(f"[10 bench] {module} {' '.join(args)} "
        f"{' '.join(f'{k}={v}' for k, v in (env or {}).items())} "
        f"({time.perf_counter() - t0:.1f} s wall): {line}")
    out = json.loads(line)
    if out["device"]["name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench.{module}: device {out['device']} is not "
                             f"{torch.cuda.get_device_name(0)}")
    bad = finite_positive(out, skip=("sigma", "cache_blocks",
                                     "max_abs_err"))
    if bad:
        raise AssertionError(f"bench.{module}: not finite and positive: "
                             f"{bad}")

    def shares(obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                if k in ("mfu_pct", "bound_pct"):
                    yield k, v
                else:
                    yield from shares(v)
        elif isinstance(obj, list):
            for v in obj:
                yield from shares(v)
    over = [(k, v) for k, v in shares(out) if v > 100]
    if over:
        raise AssertionError(f"bench.{module}: shares over 100 %: {over}")
    return out


def phase_bench(prefix, phase4):
    """10. The measurement tools (pyrhe_tpu_torch.bench), each in a process
    of its own on the card, on the phase-4 cohort where they read data:
    matvec (narrow and wide; then with a dominance component), kernels,
    e2e RHE cached and streaming with 2 repeats (sigma^2 bitwise equal to
    phase 4's runs of the same cohort, dtype and seed), host_read at 1, 2,
    4 and 8 threads, staging at 1 and 4 streams from pinned and pageable
    memory. Returns the phase's seconds."""
    from pyrhe_tpu_torch import cohort
    from pyrhe_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    for env in ({}, {"BENCH_DOM": "1"}):
        out = _bench("matvec", env=env)
        for cfg in (out, out["wide"]):
            if cfg["acc_equals_standard"] is not True:
                raise AssertionError(f"matvec {cfg['config']}: acc body != "
                                     "standard body")
    out = _bench("kernels")
    got = sorted((r["name"], r["layout"]) for r in out["kernels"])
    if got != sorted((n, lay) for n in K.KERNELS
                     for lay in ("split2", "bf16")):
        raise AssertionError(f"bench.kernels timed {got}")
    repeats = 2
    cohort_args = ["--prefix", prefix, "--cov", prefix + ".cov", "-N",
                   str(cohort.N), "-M", str(cohort.M), "-k",
                   str(cohort.PROBES), "-jn", str(cohort.JACK), "--seed",
                   str(cohort.SEED), "--repeats", str(repeats)]
    for key, flags in (("cached", []), ("streaming", ["--streaming"])):
        out = _bench("e2e", *cohort_args, *flags)
        want = [float(x) for x in phase4["RHE"][key][2]]
        if out["sigma"] != want or not out["sigma_repeats_equal"]:
            raise AssertionError(f"e2e RHE {key}: sigma {out['sigma']} "
                                 f"(repeats equal: "
                                 f"{out['sigma_repeats_equal']}) != phase "
                                 f"4's {want}")
        counts = [s["n"] for s in (*out["phases_s"].values(),
                                   *out["engine_phases_s"].values(),
                                   out["peak_gb"])]
        counts += [len(v) for v in out["samples_s"].values()]
        if set(counts) != {repeats}:
            raise AssertionError(f"e2e RHE {key}: sample counts {counts}, "
                                 f"not {repeats}")
        hits = out["engine_phases_s"].get("host_cache_hits")
        if key == "streaming" and hits["median"] != cohort.JACK:
            raise AssertionError(f"e2e streaming: {hits} host cache hits")
        log(f"[10 bench] e2e RHE {key}: sigma^2 bitwise equal to phase 4's "
            f"in each of {repeats} repeats")
    out = _bench("host_read", "--prefix", prefix, "--threads", "1,2,4,8",
                 "--span_gb", "0.25")
    if [r["threads"] for r in out["rows"]] != [1, 2, 4, 8]:
        raise AssertionError(f"host_read rows {out['rows']}")
    out = _bench("staging", "--streams", "1,4")
    if sorted((r["memory"], r["streams"]) for r in out["rows"]) != [
            ("pageable", 1), ("pageable", 4), ("pinned", 1), ("pinned", 4)]:
        raise AssertionError(f"staging rows {out['rows']}")
    dt = time.perf_counter() - t0
    log(f"[10 bench] {dt:.1f} s (7 tools, each in a process of its own)")
    return dt


EXAMPLE_CONFIGS = tuple((model, f"{mode}_bin_{b}")
                        for model in ("rhe", "rhe_dom", "genie")
                        for mode in ("no_streaming", "streaming")
                        for b in (1, 8))


def _run_config(d, model, name, tag="", *flags, **overrides):
    """example configs/<model>/<name>.txt (copied into d) through
    pyrhe_tpu_torch.cli.cli_entry in this process, from d, with its output
    redirected into d and any other key replaced by overrides. Returns
    (report text, wall seconds)."""
    from pyrhe_tpu_torch.cli import cli_entry
    out = os.path.join(d, f"out_{model}_{name}{tag}.txt")
    with open(os.path.join(d, "configs", model, f"{name}.txt")) as f:
        lines = f.read().splitlines()
    settings = {"output": out, **overrides}
    for key, value in settings.items():
        hits = [i for i, line in enumerate(lines)
                if line.startswith(f"{key} =")]
        if len(hits) != 1:
            raise AssertionError(f"{model}/{name}: {len(hits)} '{key} =' "
                                 "lines")
        lines[hits[0]] = f"{key} = {value}"
    cfg = os.path.join(d, "configs", model, f"{name}{tag}.run.txt")
    with open(cfg, "w") as f:
        f.write("\n".join(lines) + "\n")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        cli_entry(["--config", cfg, "--suppress", *flags])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    with open(out) as f:
        return f.read(), wall


def _trait_sections(text):
    """{trait: [(name, value, SE)]} of a multi-trait report."""
    parts = text.split("OUTPUT FOR TRAIT ")[1:]
    return {int(p.split(":")[0]): _estimate_lines(p) for p in parts}


def phase_example(d):
    """11. The example workflow on the card: the dataset written by `python
    -m pyrhe_tpu_torch.make_example` in a process of its own, then every
    shipped config (example/configs/{rhe,rhe_dom,genie}/
    {no_streaming,streaming}_bin_{1,8}.txt) through cli_entry on the card,
    from the data directory, with the launch counts set to 0 before the
    runs and read after them: (a) every estimate within SE overlap and
    3e-4·max(1, |golden|) of example/outputs/<model>/<name>.txt, (b) within
    SE overlap of the reference implementation's output (GENIE streaming
    against its cached run: the reference's StreamingGENIE deadlocks), (c)
    each streaming report equal to its no_streaming twin on every printed
    estimate and SE, (d) all six kernels launched; then (e) the two-trait
    test.pheno.multi through rhe/no_streaming_bin_1 on the card and with
    --device cpu: two traits each, every sigma^2 and h2 on the card within
    the split2 envelope (3e-4) of the CPU's. Returns (launches, seconds)."""
    import shutil
    from pyrhe_tpu_torch.ops import kernels as K
    from pyrhe_tpu_torch.parallel import distributed
    tag = "[11 example]"
    if distributed.env_world_size() > 1:
        raise RuntimeError(f"{tag} the environment names a torch.distributed "
                           "job; cli_entry would join it")
    t_start = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pyrhe_tpu_torch.make_example",
                    "--out", d], check=True, cwd=d, capture_output=True,
                   env={**os.environ, "PYTHONPATH": ROOT})
    log(f"{tag} python -m pyrhe_tpu_torch.make_example: "
        f"{time.perf_counter() - t_start:.1f} s wall, files "
        f"{sorted(os.listdir(d))}")
    shutil.copytree(os.path.join(ROOT, "example", "configs"),
                    os.path.join(d, "configs"))
    outputs = os.path.join(ROOT, "example", "outputs")
    raw, walls = {}, {}
    K.reset_launch_counts()
    for model, name in EXAMPLE_CONFIGS:
        label = f"{model}/{name}"
        text, walls[label] = _run_config(d, model, name)
        raw[label] = ESTIMATE.findall(text)
        ours = _estimate_lines(text)
        if not ours:
            raise AssertionError(f"{tag} {label}: no estimate in the report")
        golden = os.path.join(outputs, model, f"{name}.txt")
        _check_report(label, ours, golden, rtol=SPLIT2_RTOL)
        ref = f"no_{name.removeprefix('no_')}" if model == "genie" else name
        reference = os.path.join(outputs, "reference", model, f"{ref}.txt")
        _check_report(label, ours, reference)
        log(f"{tag} {label}: {walls[label]:.2f} s wall, {len(ours)} "
            f"estimates within SE overlap and {SPLIT2_RTOL}·max(1, |golden|) "
            f"of {os.path.relpath(golden, ROOT)} and within SE overlap of "
            f"{os.path.relpath(reference, ROOT)}")
    for model, name in EXAMPLE_CONFIGS:
        if name.startswith("streaming"):
            twin = f"{model}/no_{name}"
            if raw[f"{model}/{name}"] != raw[twin]:
                raise AssertionError(f"{tag} {model}/{name}: the report "
                                     f"differs from {twin}'s")
    log(f"{tag} (c) each streaming report equals its no_streaming twin's on "
        "every printed estimate and SE (6 pairs)")

    multi = {}
    text, walls["rhe two traits, cuda"] = _run_config(
        d, "rhe", "no_streaming_bin_1", "_multi",
        phenotype="test.pheno.multi")
    multi["cuda"] = _trait_sections(text)
    launches = dict(K.launches)
    missing = [k for k in K.KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag} {missing} never launched ({launches})")
    text, walls["rhe two traits, cpu"] = _run_config(
        d, "rhe", "no_streaming_bin_1", "_multi_cpu", "--device", "cpu",
        phenotype="test.pheno.multi")
    multi["cpu"] = _trait_sections(text)
    gaps = []
    for device, traits in multi.items():
        if sorted(traits) != [0, 1]:
            raise AssertionError(f"{tag} two-trait run on {device} reports "
                                 f"traits {sorted(traits)}")
    for t in (0, 1):
        got, want = multi["cuda"][t], multi["cpu"][t]
        if [g[0] for g in got] != [w[0] for w in want]:
            raise AssertionError(f"{tag} trait {t}: estimate lines differ "
                                 "between the card and the CPU")
        pick = [i for i, w in enumerate(want)
                if w[0].startswith(("Sigma^2", "h2_", "Total h2"))]
        g = np.array([got[i][1] for i in pick])
        c = np.array([want[i][1] for i in pick])
        atol = SPLIT2_RTOL * np.abs(c).max()
        if not np.all(np.abs(g - c) <= atol + SPLIT2_RTOL * np.abs(c)):
            raise AssertionError(f"{tag} trait {t}: sigma^2 / h2 on the card "
                                 f"{g} vs CPU {c}, outside the split2 "
                                 f"envelope (rtol {SPLIT2_RTOL}, atol "
                                 f"{atol:.3e})")
        gaps.append(np.abs(g - c).max())
    log(f"{tag} (e) test.pheno.multi: 2 traits on the card "
        f"({walls['rhe two traits, cuda']:.2f} s wall) and on the CPU "
        f"({walls['rhe two traits, cpu']:.2f} s); max |card - CPU| over "
        f"sigma^2 and h2 {max(gaps):.3e}")
    dt = time.perf_counter() - t_start
    log(f"{tag} (d) launches in the 12 configs and the two-trait card run: "
        f"{launches}")
    cfg_s = sum(walls[f"{m}/{n}"] for m, n in EXAMPLE_CONFIGS)
    log(f"{tag} {dt:.1f} s (the 12 configs {cfg_s:.1f} s of it)")
    return launches, dt


def main():
    t_start = time.perf_counter()
    phase_env()
    import torch
    from pyrhe_tpu_torch.ops import kernels as K
    phase_build()
    kres = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_") as d:
        prefix, launches, phase4 = phase_main(d)
        launches5, phase5 = phase_modes(prefix, phase4)
        for name, n in launches5.items():
            launches[name] += n
        t8 = time.perf_counter()
        launches8 = phase_checkpoint(d, prefix, phase4, phase5)
        log(f"[8 ckpt] {time.perf_counter() - t8:.1f} s; launches in the "
            f"phase's runs: {launches8}")
        for name, n in launches8.items():
            launches[name] += n
        launches9, t9 = phase_sweep(d, prefix, phase4)
        for name, n in launches9.items():
            launches[name] += n
        with tempfile.TemporaryDirectory(prefix="rhe_smoke_ex_") as d_ex:
            phase_small(d_ex)
            phase_exports(d_ex, os.path.join(d_ex, "test"))
            t9 += phase_utilities(d_ex, os.path.join(d_ex, "test"))
        log(f"[9 sweep] {t9:.1f} s (the sweep on the cohort and the "
            f"utilities); launches in the phase's counted runs: {launches9}")
        phase_bench(prefix, phase4)
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_example_") as d_11:
        launches11, _ = phase_example(d_11)
    for name, n in launches11.items():
        launches[name] += n
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
