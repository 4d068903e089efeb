"""Device-time breakdown of one model's passes on the CUDA card.

    python -m pyrhe_tpu_torch.profile_run [--model rhe|rhe_dom|genie]
        [--dtype float32|float64|bfloat16 ...]

Synthesizes the cohort of chip_smoke.py phase 4 (pyrhe_tpu_torch.cohort:
N = M = 100,000, 8 bins, 4 covariates, 2 environments, J = 100, B = 10;
GENIE runs G+GxE+NxE), runs the model once to warm the kernels and the
page cache, then profiles pass 1 + pass 2 (Engine.run_precompute_and_assemble)
of one cached and one streaming run with torch.profiler, for each --dtype
in turn (default float32). Prints per run:
wall time of the window, device busy time (sum of the device activities:
kernels and copies run one at a time on the engine's one stream) split
into the port's kernels (csrc/rhe_kernels.cu), host-to-device copies and
torch glue (every other device activity), the idle share, the phase
times, peak device memory, and device time and calls per kernel name.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
from torch.autograd import DeviceType

from . import cohort


# device kernels of csrc/rhe_kernels.cu, by the names the profiler shows
PORT_KERNELS = ("::gp_kernel<", "::gp_reduce(", "::ytg_kernel<",
                "::ytg_acc_kernel<", "::ytg_fma_kernel<",
                "::ytg_acc_fma_kernel<")


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def profile_model(cls, prefix, **kw):
    """(summary dict, [(name, device ms, calls), ...] by device time) of
    one profiled pass 1 + pass 2."""
    eng = cohort.model(cls, prefix, **kw).engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run_precompute_and_assemble()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launch them carry the same time again
    rows = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows) / 1e3
    kernels_s = sum(ms for name, ms, _ in rows
                    if any(k in name for k in PORT_KERNELS)) / 1e3
    copies_s = sum(ms for name, ms, _ in rows
                   if name.startswith("Memcpy HtoD")) / 1e3
    summary = dict(streaming=eng.cfg.streaming, wall_s=wall, busy_s=busy,
                   kernels_s=kernels_s, h2d_copies_s=copies_s,
                   glue_s=busy - kernels_s - copies_s,
                   idle_share=1.0 - busy / wall,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **{k: round(v, 4) for k, v in eng.phase_times.items()})
    return summary, rows


def main(argv=None):
    from .models import (GENIE, RHE, RHE_DOM, StreamingGENIE, StreamingRHE,
                         StreamingRHE_DOM)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["rhe", "rhe_dom", "genie"],
                    default="rhe_dom")
    ap.add_argument("--dtype", choices=["float32", "float64", "bfloat16"],
                    default=["float32"], nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_run needs a CUDA card")
    classes = {"rhe": (RHE, StreamingRHE),
               "rhe_dom": (RHE_DOM, StreamingRHE_DOM),
               "genie": (GENIE, StreamingGENIE)}[args.model]
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    with tempfile.TemporaryDirectory(prefix="rhe_prof_") as d:
        prefix = cohort.make(os.path.join(d, "cohort"))
        kw = cohort.genie_kw(prefix) if args.model == "genie" else {}
        for dtype in args.dtype:
            profile_model(classes[1], prefix, dtype=dtype, **kw)  # warm-up
            for cls in classes:
                summary, rows = profile_model(cls, prefix, dtype=dtype, **kw)
                print(f"== {args.model} {dtype} {cls.__name__}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in summary.items()))
                for name, ms, calls in rows[:25]:
                    print(f"   {ms:10.3f} ms {calls:7d}  {name[:90]}")


if __name__ == "__main__":
    main()
