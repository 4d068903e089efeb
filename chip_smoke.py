#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (pyrhe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each printed as it runs; any failure raises and the script exits
non-zero without printing a result:

1. environment: a CUDA card must be present; prints its name and power
   limit (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the CUDA kernels (csrc/rhe_kernels.cu) with nvcc, timed,
   with the compiler's register / shared-memory report;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes (m_pad 1024, n_pad 100352, stage-1 width
   22 / 44 split, stage-2 rows 320), split and unsplit; ytg_acc must equal
   ytg plus the tensor transform bitwise; median times of both;
4. main path at a biobank cohort's size: N = 100,000 individuals x
   M = 100,000 SNPs (a 2.5 GB .bed), 8 bins, 4 covariates, J = 100, B = 10,
   through RHE(...) cached and StreamingRHE(...), and through the CLI with
   --streaming; cached == streaming bitwise, total h2 within 3 SE of the
   simulated truth, every kernel launched;
5. cross-check on the example dataset (N = 5000, M = 10000): the card
   (bf16 split2) against the port on the CPU (f32) and the reference
   implementation's published run.

The last two lines are a JSON object of per-kernel results and the
{"ok": true, "device": ...} line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Phase-3 shapes: one jackknife block of the phase-4 run.
M_PAD, N_PAD, W, QR = 1024, 100352, 22, 320
RTOL = 1e-4                      # f32 summation order over ~1e5 / ~1e3 terms
# Phase-4 cohort.
N_BIG, M_BIG, BINS, NCOV, J_BIG, B_BIG = 100_000, 100_000, 8, 4, 100, 10
SIGMA = [0.05] * BINS            # per-bin h2; truth total 0.4
# Reference implementation's run on the example dataset (values and SEs),
# as in tests/test_golden_example.py REFERENCE_RUN.
REFERENCE_RUN = {
    "sigma2_g0": (0.19463871297400007, 0.028870559402243593),
    "sigma2_e": (0.8097914438786151, 0.0288719996107502),
    "h2_g0": (0.19378023613299408, 0.028743496038605126),
}
SPLIT2_RTOL = 3e-4               # tests/test_engine_vs_oracle.py envelope
REPLACES = {
    "gp_matmul": "pyrhe_tpu/ops/kernels.py:476",
    "ytg_matmul": "pyrhe_tpu/ops/kernels.py:524",
    "ytg_acc_matmul": "pyrhe_tpu/ops/kernels.py:407",
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
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
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


def phase_kernels():
    import torch
    from pyrhe_tpu_torch.ops import kernels as K
    from pyrhe_tpu_torch.ops.moments import _hilo

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    words = _random_words(gen, M_PAD, N_PAD, 1000, dev)
    C = torch.randn(N_PAD, W, device=dev, generator=gen)
    Yt = torch.randn(QR, M_PAD, device=dev, generator=gen)
    Yt[:, 1000:] = 0.0
    Q = QR // 2
    Yh = _hilo(Yt[:Q], 0).contiguous()                   # (320, m) bf16
    res = {}

    def record(name, split, err, ms, plain_ms):
        """Errors over every case; times of the split (bf16) case, which
        is what the main path runs on the card."""
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if split:
            r.update(ms=ms, plain_ms=plain_ms)

    for split, Cop in ((False, C), (True, _hilo(C, 1).contiguous())):
        got = K.gp_matmul(words, Cop)
        ref = K.gp_plain(words, Cop)
        err = _close(f"gp_matmul split={split}", got, ref)
        ms = _median_ms(lambda: K.gp_matmul(words, Cop))
        pms = _median_ms(lambda: K.gp_plain(words, Cop), reps=5)
        record("gp_matmul", split, err, ms, pms)
        log(f"[3 kernels] gp_matmul split={split} C {tuple(Cop.shape)} "
            f"{Cop.dtype}: max abs err {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")

    for split, Yop in ((False, Yt), (True, Yh)):
        got = K.ytg_matmul(words, Yop)
        ref = K.ytg_plain(words, Yop)
        err = _close(f"ytg_matmul split={split}", got, ref)
        ms = _median_ms(lambda: K.ytg_matmul(words, Yop))
        pms = _median_ms(lambda: K.ytg_plain(words, Yop), reps=5)
        record("ytg_matmul", split, err, ms, pms)
        log(f"[3 kernels] ytg_matmul split={split} Yt {tuple(Yop.shape)} "
            f"{Yop.dtype}: max abs err {err:.3e}; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")

    mask = (torch.rand(1, N_PAD, device=dev, generator=gen) < 0.9).float()
    for split, Yop in ((False, Yt[:Q].contiguous()), (True, Yh)):
        rank1 = torch.randn(Q, 1, device=dev, generator=gen)
        err = 0.0
        for scale in (torch.ones(1, N_PAD, device=dev),
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
                    f"ytg_acc_matmul split={split}: {bad} elements differ "
                    "from ytg_matmul + transform (must be bitwise equal)")
            ref = K.ytg_acc_plain(words, Yop, rank1, scale, mask,
                                  tot0.clone(), split)
            err = max(err, _close(f"ytg_acc_matmul split={split}", got,
                                  ref))
        tot = tot0.clone()
        ms = _median_ms(lambda: K.ytg_acc_matmul(
            words, Yop, rank1, scale, mask, tot, split=split))
        pms = _median_ms(lambda: K.ytg_acc_plain(
            words, Yop, rank1, scale, mask, tot, split), reps=5)
        record("ytg_acc_matmul", split, err, ms, pms)
        log(f"[3 kernels] ytg_acc_matmul split={split} Yt "
            f"{tuple(Yop.shape)} {Yop.dtype}: bitwise == ytg + transform; "
            f"max abs err vs plain {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms")
    torch.cuda.synchronize()
    return res


def _make_cohort(d):
    from pyrhe_tpu_torch.io import synth
    prefix = os.path.join(d, "cohort")
    t0 = time.perf_counter()
    synth.make_dataset_fast(prefix, N_BIG, M_BIG, SIGMA, seed=11,
                            missing_rate=0.01)
    synth.make_cov_file(prefix + ".cov", N_BIG, num_cov=NCOV, seed=11)
    log(f"[4 main] synthesized N={N_BIG} M={M_BIG} "
        f"({os.path.getsize(prefix + '.bed') / 1e9:.2f} GB .bed) in "
        f"{time.perf_counter() - t0:.1f} s")
    return prefix


def _run_model(cls, prefix):
    import torch
    from pyrhe_tpu_torch import Logger
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cls(geno_file=prefix, annot_file=prefix + ".annot",
                pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
                num_jack=J_BIG, num_random_vec=B_BIG, seed=5, device="cuda",
                log=Logger(suppress=True, debug_mode=False))
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


def phase_main(d):
    from pyrhe_tpu_torch import RHE, StreamingRHE
    from pyrhe_tpu_torch.ops import kernels as K
    from parse_output import parse_output_file

    prefix = _make_cohort(d)
    K.reset_launch_counts()
    cached, res_c, pt_c = _run_model(RHE, prefix)
    streaming, res_s, pt_s = _run_model(StreamingRHE, prefix)
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    if cached.engine.cfg.streaming:
        raise AssertionError("the cached run switched to streaming")
    log(f"[4 main] cached phases (s): {_fmt_phases(pt_c)}")
    log(f"[4 main] streaming phases (s): {_fmt_phases(pt_s)}")
    log(f"[4 main] launches in the two runs: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched by the main path")
    eq_T = np.array_equal(cached.engine.T_all, streaming.engine.T_all)
    eq_q = np.array_equal(cached.engine.q_all, streaming.engine.q_all)
    if not (eq_T and eq_q):
        raise AssertionError(f"cached != streaming (T equal {eq_T}, "
                             f"q equal {eq_q})")
    for key in ("sigma_ests_total", "sig_errs", "h2_total", "h2_errs"):
        if not np.all(np.isfinite(res_c[key])):
            raise AssertionError(f"non-finite {key}: {res_c[key]}")
    h2, se = float(res_c["h2_total"][-1]), float(res_c["h2_errs"][-1])
    truth = sum(SIGMA)
    log(f"[4 main] total h2 {h2:.5f} SE {se:.5f}, simulated truth {truth}; "
        f"cached == streaming bitwise (T_all, q_all)")
    if abs(h2 - truth) > 3 * se:
        raise AssertionError(f"total h2 {h2} is more than 3 SE from {truth}")

    out = os.path.join(d, "cli_streaming.txt")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "pyrhe_tpu_torch.cli", "-g", prefix,
         "-annot", prefix + ".annot", "-p", prefix + ".pheno", "-c",
         prefix + ".cov", "-k", str(B_BIG), "-jn", str(J_BIG), "-s", "5",
         "--streaming", "--device", "cuda", "-o", out, "--suppress"],
        check=True, cwd=ROOT)
    got = parse_output_file(out)
    cli_sigma = [g["value"] for g in got["sigma2_g"]] + [
        got["sigma2_e"]["value"]]
    if cli_sigma != [float(v) for v in res_s["sigma_ests_total"]]:
        raise AssertionError(f"CLI sigma {cli_sigma} != StreamingRHE "
                             f"{list(res_s['sigma_ests_total'])}")
    log(f"[4 main] CLI --streaming run: {time.perf_counter() - t0:.1f} s "
        "wall (new process, kernels already built); sigma equal to "
        "StreamingRHE's")
    return launches


def _example(d):
    from pyrhe_tpu_torch.io import synth
    cwd = os.getcwd()
    os.chdir(d)
    try:
        synth.make_dataset("test", 5000, 10000, seed=42, missing_rate=0.005)
        a1 = synth.make_annot("single.annot", 10000, 1, seed=42)
        cov = synth.make_cov_file("test.cov", 5000, num_cov=5, seed=42)
        env = synth.make_env_file("test.env", 5000, num_env=1, seed=42)
        synth.simulate_pheno_file("test", "test", [0.2], a1, seed=44,
                                  cov=cov, env=env, sigma_gxe=0.05)
    finally:
        os.chdir(cwd)
    return os.path.join(d, "test")


def phase_small(d):
    from pyrhe_tpu_torch import RHE, Logger
    prefix = _example(d)
    out = {}
    for device in ("cuda", "cpu"):
        model = RHE(geno_file=prefix, annot_file=os.path.join(d,
                                                              "single.annot"),
                    pheno_file=prefix + ".pheno", cov_file=prefix + ".cov",
                    num_jack=100, num_random_vec=10, seed=42, device=device,
                    log=Logger(suppress=True, debug_mode=False))
        out[device] = model(trait=0)
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
    log("[5 small] example N=5000 M=10000: " + "; ".join(
        f"{k} cuda {vals['cuda'][k][0]:.8f} cpu {vals['cpu'][k][0]:.8f} "
        f"ref {REFERENCE_RUN[k][0]:.8f}" for k in REFERENCE_RUN))


def main():
    t_start = time.perf_counter()
    phase_env()
    import torch
    from pyrhe_tpu_torch.ops import kernels as K
    phase_build()
    kres = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_") as d:
        launches = phase_main(d)
    with tempfile.TemporaryDirectory(prefix="rhe_smoke_ex_") as d:
        phase_small(d)
    src = os.path.relpath(K._SRC, ROOT)
    kernels = [{
        "name": fn.__name__, "route": "cuda", "source": src,
        "replaces": REPLACES[fn.__name__],
        "launches": launches[fn.__name__],
        "max_abs_err": kres[fn.__name__]["max_abs_err"],
        "ms": kres[fn.__name__]["ms"],
        "plain_ms": kres[fn.__name__]["plain_ms"],
    } for fn in K.KERNELS]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
