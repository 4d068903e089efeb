"""Reduction of a torch.profiler trace of the window to device times.

Every CUDA run records the device's activities over its window. A run
with --trace 0 records nothing else, one estimate a cycle, and keeps only
each cycle's busy seconds (device_busy_s), the basis of the end-to-end
`device_s`. A --trace 1 run records the host too, over the whole window,
and summarize() reduces it as follows.

Device activities are every event the profiler records on the CUDA
device (kernels, copies and memsets) but the annotations that mirror the
host's spans there. Over the traced window (the
benchmark's own `h100_bench.window` span):

  - busy_s: the length of the union of the device activities;
  - kernels_s: device time of the port's kernels, recognized by name
    (PORT_KERNELS, a frozen copy of pyrhe_tpu_torch/profile_run.py's
    list for csrc/rhe_kernels.cu);
  - copy_s: device time of the copies (names starting "Memcpy");
  - glue_s: device time of every other activity (torch's kernels,
    memsets): the port's torch glue;
  - device_ops: device seconds by activity name, largest first;
  - idle_gaps: the longest stretches with no device activity, each named
    by what the host's main thread was in: the innermost of the
    benchmark's spans (`h100_bench.*`) around the gap's midpoint, and the
    innermost profiled host operation there, if any.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

PORT_KERNELS = ("::gp_kernel<", "::gp_reduce(", "::ytg_kernel<",
                "::ytg_acc_kernel<", "::ytg_fma_kernel<",
                "::ytg_acc_fma_kernel<")
WINDOW_SPAN = "h100_bench.window"
SPAN_PREFIX = "h100_bench."
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels_s: float
    copy_s: float
    glue_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _events(prof):
    """(host events, device events) as (name, start_ns, end_ns, thread)
    tuples."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (e.name(), start, start + e.duration_ns(), e.start_thread_id())
        if e.device_type() == DeviceType.CPU:
            host.append(rec)
        elif not e.is_user_annotation():
            # the profiler mirrors each host span onto the device's
            # timeline as an annotation: no device work
            dev.append(rec)
    return host, dev


def _innermost(events, t):
    best = None
    for name, s, e, _ in events:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else None


def _union(intervals, w0, w1):
    """(ns covered by the union of the (start, end) intervals, the gaps
    between them within [w0, w1] as (length, start, end))."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    prev_end = w0
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((s - prev_end, prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > prev_end:
        gaps.append((w1 - prev_end, prev_end, w1))
    return busy, gaps


def device_busy_s(prof) -> float:
    """busy_s of a trace that recorded the device alone over one cycle:
    the union of every device activity in it."""
    _, dev = _events(prof)
    spans = [(s, e) for _, s, e, _ in dev if e > s]
    if not spans:
        return 0.0
    return _union(spans, min(s for s, _ in spans),
                  max(e for _, e in spans))[0] / 1e9


def summarize(prof) -> Summary:
    host, dev = _events(prof)
    windows = [h for h in host if h[0] == WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    _, w0, w1, main = windows[0]
    main_host = [h for h in host if h[3] == main and h is not windows[0]]
    spans = [h for h in main_host if h[0].startswith(SPAN_PREFIX)]
    ops = [h for h in main_host if not h[0].startswith(SPAN_PREFIX)]

    per_name = defaultdict(float)
    kernels = copies = 0.0
    intervals = []
    for name, s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        dt = (e - s) / 1e9
        per_name[name] += dt
        if name.startswith("Memcpy"):
            copies += dt
        elif any(k in name for k in PORT_KERNELS):
            kernels += dt
        intervals.append((s, e))
    busy, gaps = _union(intervals, w0, w1)
    gaps.sort(reverse=True)
    idle = []
    for length, s, e in gaps[:TOP]:
        mid = (s + e) // 2
        label = _innermost(spans, mid) or WINDOW_SPAN
        op = _innermost(ops, mid)
        idle.append([f"{label}:{op}" if op else label, length / 1e9])
    device_ops = sorted(([n, t] for n, t in per_name.items()),
                        key=lambda r: -r[1])[:TOP]
    busy_s = busy / 1e9
    total = sum(per_name.values())
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_s,
                   kernels_s=kernels, copy_s=copies,
                   glue_s=total - kernels - copies, device_ops=device_ops,
                   idle_gaps=idle)
