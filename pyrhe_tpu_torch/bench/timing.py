"""Timers, bounds and the card's identity, shared by the port's tools.

Every tool of `pyrhe_tpu_torch.bench` and chip_smoke.py phase 3 time with
these helpers, so a kernel's time in a tool's line and in chip_smoke.py's
come from one timer.

    python -m pyrhe_tpu_torch.bench.timing [--device cpu]

prints the card's identity (`card()`) as one JSON line; without a card it
raises unless `--device cpu` is passed.

Peaks are NVIDIA's published ones for one H100 SXM at its full 700 W
power limit (dense, no sparsity); a card set below that limit runs slower
under load, so every tool prints the limit beside its numbers.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import platform
import statistics
import subprocess
import time

import torch

# Published H100 SXM peaks at 700 W (bytes/s, flop/s by operand type).
HBM_BPS, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
SPIN_CYCLES = 4_000_000          # ~2 ms of the card's clock
L2_FLUSH_BYTES = 128 << 20       # more than the H100's 50 MB L2


def require_card(device: str = "auto") -> torch.device:
    """The device a tool runs on: the current CUDA card unless the caller
    passed "cpu". "auto", "cuda" and "gpu" raise RuntimeError when
    torch.cuda.is_available() is False: no tool falls back to the CPU."""
    from ..core.engine import pick_device
    return pick_device(device)


def card(dev: torch.device | str = "cuda") -> dict:
    """Identity of the device a result was measured on. On the card:
    platform "gpu", torch.cuda.get_device_name(0) as `name`, the device
    count, and nvidia-smi's name and power.limit
    (`--query-gpu=name,power.limit --format=csv,noheader`); on the CPU
    platform "cpu" and the host's processor."""
    dev = torch.device(dev)
    if dev.type == "cpu":
        return {"platform": "cpu",
                "name": platform.processor() or platform.machine(),
                "count": os.cpu_count()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi_name, power = (s.strip() for s in
                       smi.splitlines()[idx].rsplit(",", 1))
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "count": torch.cuda.device_count(), "smi_name": smi_name,
            "power_limit": power}


def event_ms(fn, reps: int = 20, *, cold: bool = True) -> list[float]:
    """Device time in ms of each of `reps` calls of fn, after 3 warm-up
    calls: CUDA events around each call, ended by the end event's
    synchronize. With cold=True (the default), before each call a 128 MB
    write evicts the 50 MB L2 (the main path's other kernels leave it cold)
    and the card spins ~2 ms (torch.cuda._sleep) while the host enqueues
    the call, so the events time the device work and not the Python
    launch overhead."""
    flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def median_ms(fn, reps: int = 20) -> float:
    """Median of event_ms(fn, reps): cold L2, launches hidden."""
    return statistics.median(event_ms(fn, reps))


def host_ms(fn, dev: torch.device, reps: int) -> list[float]:
    """Wall time in ms of each of `reps` calls of fn on the host clock,
    each started on an idle device and ended by a synchronize (a no-op on
    the CPU), after one warm-up call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def summary(samples) -> dict:
    """Median, quartiles (inclusive method) and count of repeated
    samples."""
    xs = [float(x) for x in samples]
    if len(xs) > 1:
        q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    else:
        q1 = q3 = xs[0]
    return {"median": statistics.median(xs), "q1": q1, "q3": q3,
            "n": len(xs)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_moved, flops, dtype) -> tuple[float, str]:
    """(bound ms, what sets it): the larger of the bytes a call must move
    (each input read once, each output written once) over the memory rate
    and its flops over the peak for the operand dtype (bf16 on the tensor
    cores, else f32)."""
    t_bytes = nbytes_moved / HBM_BPS
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def finite_positive(obj, skip=(), path: str = "") -> list[str]:
    """The paths of the numbers in a tool's JSON (nested dicts and lists;
    bools and strings aside, and the dict keys in skip) that are not
    finite and positive, and of every null."""
    bad = []
    if obj is None:
        bad.append(path)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if k not in skip:
                bad += finite_positive(v, skip, f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            bad += finite_positive(v, skip, f"{path}[{i}]")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if not (math.isfinite(obj) and obj > 0):
            bad.append(path)
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda; raises without a card) | cuda | cpu")
    args = ap.parse_args(argv)
    print(json.dumps(card(require_card(args.device))))


if __name__ == "__main__":
    main()
