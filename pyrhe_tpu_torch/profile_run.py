"""Device-time breakdown of one model's passes on the CUDA card.

    python -m pyrhe_tpu_torch.profile_run [--model rhe|rhe_dom|genie]
        [--dtype float32|float64|bfloat16 ...] [--num_vec B]

Synthesizes the cohort of chip_smoke.py phase 4 (pyrhe_tpu_torch.cohort:
N = M = 100,000, 8 bins, 4 covariates, 2 environments, J = 100, B = 10
unless --num_vec says otherwise; GENIE runs G+GxE+NxE), runs the model
once to warm the kernels and the
page cache, then profiles pass 1 + pass 2 (Engine.run_precompute_and_assemble)
of one cached and one streaming run with torch.profiler, for each --dtype
in turn (default float32). Prints per run:
wall time of the window, device busy time (sum of the device activities:
kernels and copies run one at a time on the engine's one stream) split
into the port's kernels (csrc/rhe_kernels.cu), host-to-device copies and
torch glue (every other device activity), the idle share, the phase
times, peak device memory, device time and calls per kernel name, and the
device seconds under each of the engine's `pyrhe.*` spans (by_span).
"""
from __future__ import annotations

import argparse
import bisect
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from . import cohort
from .utils import trace


# device kernels of csrc/rhe_kernels.cu, by the names the profiler shows
PORT_KERNELS = ("::gp_kernel<", "::gp_reduce(", "::ytg_kernel<",
                "::ytg_acc_kernel<", "::ytg_fma_kernel<",
                "::ytg_acc_fma_kernel<", "::sample_contract_kernel<",
                "::sample_contract_merge(")


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def _segments(spans):
    """(times, names) of nested (start, end, name) spans: names[i] is the
    innermost span from times[i] to times[i + 1], None outside them."""
    times, names, stack = [], [], []

    def mark(t):
        name = stack[-1][1] if stack else None
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    for start, end, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= start:
            mark(stack.pop()[0])
        stack.append((end, name))
        mark(start)
    while stack:
        mark(stack.pop()[0])
    return times, names


def by_span(events) -> list:
    """[(span, device seconds), ...], largest first, of the device
    activities among `events` (a profile's kineto_results.events()), each
    under the innermost `pyrhe.*` span open on the engine's thread (the
    one that opens `pyrhe.precompute` and `pyrhe.assemble`) when the host
    launched it: CUPTI gives an activity and its runtime launch call (a
    `cu*` event) one correlation id. "-" holds what was launched outside
    every span or has no launch call. The spans that the profiler mirrors
    onto the device are none of its work and count nowhere.

    Unlike a span's CUDA event pair (Engine.phase_times), this is the
    card's own time, whatever the stream waited for the host inside the
    span."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    dev: dict[int, float] = defaultdict(float)
    for e in events:
        if (e.device_type() != DeviceType.CPU
                and not e.name().startswith(trace.PREFIX)):
            dev[e.correlation_id()] += e.duration_ns() / 1e9
    threads = {e.start_thread_id() for e in host
               if e.name() in (trace.PREFIX + "precompute",
                               trace.PREFIX + "assemble")}
    times, names = _segments(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in host if e.start_thread_id() in threads
        and e.name().startswith(trace.PREFIX))
    out: dict[str, float] = defaultdict(float)
    for e in host:
        sec = dev.pop(e.correlation_id(), 0.0) if e.name().startswith(
            "cu") else 0.0
        if sec:
            i = bisect.bisect_right(times, e.start_ns()) - 1
            out[(names[i] if i >= 0 else None) or "-"] += sec
    if dev:
        out["-"] += sum(dev.values())
    return sorted(out.items(), key=lambda r: -r[1])


def profile_model(cls, prefix, **kw):
    """(summary dict, [(name, device ms, calls), ...] by device time,
    by_span's list) of one profiled pass 1 + pass 2."""
    eng = cohort.model(cls, prefix, **kw).engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with trace.profiler(acts) as prof:
        t0 = time.perf_counter()
        eng.run_precompute_and_assemble()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launch them carry the same time again, and the engine's spans
    # (utils/trace.py), which the profiler mirrors onto the device, are
    # none of its work
    rows = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not e.key.startswith(trace.PREFIX)]
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
    return summary, rows, by_span(
        prof.profiler.kineto_results.events())


def main(argv=None):
    from .models import (GENIE, RHE, RHE_DOM, StreamingGENIE, StreamingRHE,
                         StreamingRHE_DOM)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["rhe", "rhe_dom", "genie"],
                    default="rhe_dom")
    ap.add_argument("--dtype", choices=["float32", "float64", "bfloat16"],
                    default=["float32"], nargs="+")
    ap.add_argument("--num_vec", type=int, default=cohort.PROBES,
                    help="random probes B (the cohort's 10 by default)")
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
        kw["num_random_vec"] = args.num_vec
        for dtype in args.dtype:
            profile_model(classes[1], prefix, dtype=dtype, **kw)  # warm-up
            for cls in classes:
                summary, rows, spans = profile_model(cls, prefix,
                                                     dtype=dtype, **kw)
                print(f"== {args.model} {dtype} {cls.__name__}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in summary.items()))
                for name, ms, calls in rows[:25]:
                    print(f"   {ms:10.3f} ms {calls:7d}  {name[:90]}")
                print("   by span: " + ", ".join(
                    f"{name} {sec:.4f}" for name, sec in spans)
                    + f"; total {sum(sec for _, sec in spans):.4f} s")


if __name__ == "__main__":
    main()
