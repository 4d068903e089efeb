"""Genotype randomized-matvec throughput of the port on one card.

    python -m pyrhe_tpu_torch.bench.matvec [--device cpu]

The port's counterpart of bench.py (the JAX package's bench, which stays
as it is). Prints ONE JSON line:

  {"metric": "genotype_matvec_gflops_per_chip", "value": ..., "unit":
   "GFLOP/s", "vs_baseline": ..., "mfu_pct": ..., "peak_tflops": 989,
   "config": {...}, "wide": {the same keys}, "device": {...}, ...}

The body is the engine's pass 1 over blocks whose stats it does not keep
(streaming): ops/moments.acc_scan_stats, i.e. per block
block_stats_pallas_acc_core (gp_matmul, then ytg_acc_matmul per additive
component and ytg_acc2_matmul for a dominance one), with the stage-1
column sums taken once (ops/moments.stage1_colsum) as the engine takes
them. BENCH_ACC=0 times the cached pass 1 instead: block_stats_pallas_core
and a tensor add into the totals. The blocks are cleaned int32 words
(codes 00/10/11 only, as io/bed.clean_packed leaves them), made on the
device from a seed and resident there.

Shapes are bench.py's: narrow N = 131,072, m = 2048, K = 1, B = 10; wide
K = 8 with covariates (b2 = 2B) at m = 5120. On the CPU (--device cpu, the
kernels' plain versions) N = 8192, m = 512.

Timing: n blocks between two CUDA events ended by a synchronize, after a
warm-up pass, 7 times; `value` is the median rate, with
its quartiles and the sample count. `device_busy_pct` is the device time
of the same blocks queued behind a spin (torch.cuda._sleep: every launch is
enqueued before the device starts, so the events see the device work
alone) over the time without the spin: below 100, the host's launches set
the pace. On the CPU the times are host times and the device keys are
null.

Check, after timing: the acc body's totals equal the standard body's
bitwise over the same blocks (the engine's streaming == cached).

Useful flops only (useful_flops_per_block). vs_baseline = value / 8.9
GFLOP/s, PyRHE's published CPU run (bench.py's docstring); mfu_pct is
against `peak_tflops`, the H100 SXM's dense bf16 peak at 700 W (the
kernel modes run bf16 operands on the tensor cores; BENCH_IMPL=exact runs
f32 torch products, against 67 TF/s), and null on the CPU.

Environment (bench.py's): BENCH_DTYPE float32 (split2) | bfloat16 (bf16),
BENCH_IMPL kernels (default) | exact (ops/moments.block_stats_core: g
decoded, two torch.matmul, the standard body), BENCH_K, BENCH_B,
BENCH_COV=1, BENCH_ENV=E (E GxE components), BENCH_DOM=1 (a dominance
component), BENCH_M (SNP rows a block), BENCH_ACC=0; and BENCH_BLOCKS
(blocks timed; default 8 narrow, 4 wide on the card, 3 on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels import ROW_TILE, TN, pad_to, plane_permutation
from ..ops.moments import (acc_scan_stats, block_stats_core,
                           block_stats_pallas_core, stage1_colsum)
from .timing import (PEAK_BF16, PEAK_F32, SPIN_CYCLES, card, event_ms,
                     host_ms, require_card, summary)

BASELINE_GFLOPS = 8.9        # PyRHE CPU-equivalent, bench.py's docstring
NARROW = dict(N=131_072, m=2048, blocks=8)
WIDE = dict(K=8, cov=True, m=5120, blocks=4)
CPU_SHAPE = dict(N=8192, m=512, blocks=3)
T = 1                        # traits: the probe block carries one
REPS = 7


def useful_flops_per_block(N: int, m: int, K: int, b2: int, Bp: int,
                           num_env: int = 0, dom: bool = False) -> float:
    """Useful flops of one block, the ones/mask column excluded: stage 1
    takes the Bp probe columns of each of the V = 1 + num_env env variants
    through g, and with dominance the Bp columns of the one variant the
    dominance component consumes through g² (Bp·(V + 1), where bench.py
    counted Bp·V·2); stage 2 K·b2 rows a component, twice for the
    dominance one (its stats are a g and a g² contraction)."""
    V = 1 + num_env
    stage1 = Bp * (V + (1 if dom else 0))
    stage2 = (V + (1 if dom else 0)) * K * b2 + (K * b2 if dom else 0)
    return 2.0 * N * m * (stage1 + stage2)


class Case(NamedTuple):
    """One configuration's device arrays, in the kernels' layout."""
    N: int
    K: int
    b2: int
    Bp: int
    components: tuple
    P: torch.Tensor              # (n_pad, Bp) plane-permuted probes
    env: torch.Tensor | None     # (n_pad, num_env) or None
    mask: torch.Tensor           # (n_pad,) 1.0 at real individuals
    annot: torch.Tensor          # (m, K) one-hot bins
    csum: torch.Tensor           # stage1_colsum of the operands


def make_case(N: int, m: int, K: int, B: int, *, use_cov: bool = False,
              num_env: int = 0, dom: bool = False, dev="cpu",
              seed: int = 0) -> Case:
    """Probes, env columns and annotation from np.random.default_rng(seed)
    (natural order, then plane-permuted and padded to n_pad as the engine
    stages them)."""
    if m % ROW_TILE:
        raise ValueError(f"m = {m} must be a multiple of {ROW_TILE}")
    b2 = B * (2 if use_cov else 1)   # covariates double the probe block
    Bp = b2 + T
    components = ((("add", None),) + tuple(("add", e) for e in range(num_env))
                  + ((("dom", None),) if dom else ()))
    rng = np.random.default_rng(seed)
    n_pad = pad_to(N, TN)
    perm = plane_permutation(n_pad)

    def put(x):
        out = np.zeros((n_pad,) + x.shape[1:])
        out[:N] = x
        return torch.as_tensor(out[perm], dtype=torch.float32, device=dev)

    P = put(rng.normal(size=(N, Bp)))
    env = put(rng.normal(size=(N, num_env))) if num_env else None
    mask = torch.as_tensor(perm < N, dtype=torch.float32, device=dev)
    annot = np.zeros((m, K), np.float32)
    annot[np.arange(m), rng.integers(0, K, m)] = 1.0
    return Case(N, K, b2, Bp, components, P, env, mask,
                torch.as_tensor(annot, device=dev),
                stage1_colsum(components, P, env, mask))


def make_blocks(n_blocks: int, m: int, n_pad: int, dev, seed: int = 1):
    """n_blocks cleaned (m, n_pad/16) int32 word blocks on dev: every byte
    four codes drawn from {00, 10, 11} (dosages 0, 1, 2; no missing code)
    by a torch.Generator seeded with seed."""
    codes = (0, 2, 3)
    lut = torch.tensor([a | b << 2 | c << 4 | d << 6 for a in codes
                        for b in codes for c in codes for d in codes],
                       dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [lut[torch.randint(0, len(lut), (m, n_pad // 4), device=dev,
                              generator=gen)].view(torch.int32)
            for _ in range(n_blocks)]


def _totals(case: Case):
    E = len(case.components) * case.K
    return (torch.zeros((E, case.b2, case.P.shape[0]), device=case.P.device),
            torch.zeros((E, T), device=case.P.device))


def acc_body(case: Case, blocks, mode: str):
    """Streaming pass 1: the totals updated in place by the aliased
    stage-2 kernels (ops/moments.acc_scan_stats). Returns (totX, toty)."""
    totX, toty = _totals(case)
    return acc_scan_stats(((w, case.annot) for w in blocks), case.P,
                          case.env, case.mask, totX, toty, K=case.K,
                          components=case.components, n_indiv=case.N,
                          b2=case.b2, mode=mode, csum=case.csum)


def standard_body(case: Case, blocks, mode: str):
    """Cached pass 1: each block's stats materialized
    (block_stats_pallas_core; block_stats_core in mode "exact") and added
    to the totals as the engine adds them. Returns (totX, toty)."""
    totX, toty = _totals(case)
    kw = dict(n_indiv=case.N, components=case.components, b2=case.b2,
              csum=case.csum)
    for w in blocks:
        args = (w, case.annot, case.P, case.env, case.mask)
        if mode == "exact":
            X, y, _ = block_stats_core(*args, **kw)
        else:
            X, y, _ = block_stats_pallas_core(*args, mode=mode, **kw)
        totX.add_(X.transpose(1, 2))
        toty.add_(y)
    return totX, toty


def acc_equals_standard(case: Case, blocks, mode: str) -> bool:
    """Whether the two bodies give bitwise the same totals."""
    a, s = acc_body(case, blocks, mode), standard_body(case, blocks, mode)
    return all(torch.equal(x, y) for x, y in zip(a, s))


def _device_ms(fn, reps: int) -> list[float]:
    """Device ms of each call of fn with every launch enqueued behind a
    spin before the device starts (the spin doubles until the host's
    enqueue takes less than it)."""
    cycles, times = 8 * SPIN_CYCLES, []
    while len(times) < reps:
        torch.cuda.synchronize()
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if enqueue_ms < 0.9 * s.elapsed_time(a):
            times.append(a.elapsed_time(b))
        elif cycles > 2000 * SPIN_CYCLES:
            raise RuntimeError(f"the host took {enqueue_ms:.1f} ms to "
                               "enqueue the blocks, longer than any spin")
        else:
            cycles *= 2
    return times


def bench_config(N, m, K, B, n_blocks, *, dtype_mode="float32",
                 impl="kernels", use_cov=False, num_env=0, dom=False,
                 acc=True, dev=torch.device("cpu"), reps=REPS) -> dict:
    """Time one configuration; returns its part of the JSON line. Raises
    AssertionError when the acc body's totals differ from the standard
    body's."""
    if dtype_mode not in ("float32", "bfloat16"):
        raise ValueError(f"BENCH_DTYPE {dtype_mode!r}: float32 | bfloat16")
    if impl not in ("kernels", "exact"):
        raise ValueError(f"BENCH_IMPL {impl!r}: kernels | exact")
    on_card = dev.type == "cuda"
    kmode = ("bf16" if dtype_mode == "bfloat16"
             else "split2" if on_card else "f32")
    mode = "exact" if impl == "exact" else kmode
    case = make_case(N, m, K, B, use_cov=use_cov, num_env=num_env, dom=dom,
                     dev=dev)
    blocks = make_blocks(n_blocks, m, case.P.shape[0], dev)
    use_acc = acc and mode != "exact"

    def run():
        (acc_body if use_acc else standard_body)(case, blocks, mode)

    if on_card:
        torch.cuda.synchronize()
        ms = event_ms(run, reps, cold=False)
        dev_ms = _device_ms(run, reps)
    else:
        ms, dev_ms = host_ms(run, dev, reps), None
    same = acc_equals_standard(case, blocks, kmode)
    if not same:
        raise AssertionError(f"acc body != standard body (mode {kmode}, "
                             f"K {K}, B {B}, cov {use_cov}, env {num_env}, "
                             f"dom {dom}): the totals must be bitwise equal")
    flops = useful_flops_per_block(N, m, K, case.b2, case.Bp, num_env,
                                   dom) * n_blocks
    rates = summary([flops / (t / 1e3) / 1e9 for t in ms])
    peak = PEAK_F32 if mode == "exact" else PEAK_BF16
    per_block = summary([t / n_blocks for t in ms])
    out = {
        "value": rates["median"], "gflops_q1": rates["q1"],
        "gflops_q3": rates["q3"], "samples": rates["n"],
        "vs_baseline": rates["median"] / BASELINE_GFLOPS,
        "mfu_pct": 100 * rates["median"] * 1e9 / peak if on_card else None,
        "peak_tflops": peak / 1e12,
        "ms_per_block": per_block["median"],
        "ms_per_block_q1": per_block["q1"], "ms_per_block_q3": per_block["q3"],
        "device_ms_per_block": None, "device_busy_pct": None,
        "useful_gflop_per_block": flops / n_blocks / 1e9,
        "acc_equals_standard": same,
        "config": {"N": N, "m": m, "K": K, "B": B, "cov": use_cov,
                   "impl": impl, "dtype": dtype_mode, "mode": mode,
                   "acc": use_acc, "blocks": n_blocks,
                   **({"env": num_env} if num_env else {}),
                   **({"dom": True} if dom else {})},
    }
    if dev_ms is not None:
        d = summary([t / n_blocks for t in dev_ms])["median"]
        out["device_ms_per_block"] = d
        out["device_busy_pct"] = 100 * d / per_block["median"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda; raises without a card) | cuda | cpu")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    env = os.environ.get
    on_card = dev.type == "cuda"
    shape = NARROW if on_card else CPU_SHAPE
    N, m = shape["N"], int(env("BENCH_M", shape["m"]))
    K, B = int(env("BENCH_K", 1)), int(env("BENCH_B", 10))
    cov = env("BENCH_COV", "0") == "1"
    num_env = int(env("BENCH_ENV", 0))
    dom = env("BENCH_DOM", "0") == "1"
    common = dict(dtype_mode=env("BENCH_DTYPE", "float32"),
                  impl=env("BENCH_IMPL", "kernels"),
                  acc=env("BENCH_ACC", "1") == "1", dev=dev)
    n_blocks = int(env("BENCH_BLOCKS", shape["blocks"]))
    narrow = bench_config(N, m, K, B, n_blocks, use_cov=cov, num_env=num_env,
                          dom=dom, **common)
    # the wide production shape (8 bins + covariates, stage-2 width 160)
    # at the flagship block height, unless the overrides already ask for it
    wide_m = WIDE["m"] if on_card else m
    if (K, cov, num_env, dom, m) == (WIDE["K"], True, 0, False, wide_m):
        wide = narrow
    else:
        wide = bench_config(
            N, wide_m, WIDE["K"], B,
            int(env("BENCH_BLOCKS", WIDE["blocks"] if on_card
                    else shape["blocks"])), use_cov=True, **common)
    print(json.dumps({
        "metric": "genotype_matvec_gflops_per_chip", "unit": "GFLOP/s",
        **narrow, "wide": wide, "device": card(dev),
        "note": ("useful-flop rate of the engine's streaming pass-1 body; "
                 "'wide' is the 8-bin + covariates configuration at the "
                 "m = 5120 block height (M = 500k, J = 100)"),
    }))


if __name__ == "__main__":
    main()
