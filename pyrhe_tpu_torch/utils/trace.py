"""Spans and device timers of the engine, on the profiler's clock.

`span(name)` opens `torch.profiler.record_function("pyrhe." + name)`
while a torch profiler runs, so the span lies on the same clock as the
device activities the profiler records, nested in the spans around it;
otherwise it returns one shared no-op context and costs a flag read.
torch offers no public way to ask which activities a running profiler
records, so every profiler turns the spans on, one that records the
device alone too. The spans of one estimate are those that nest in its
`pyrhe.engine_init`, `pyrhe.precompute` and `pyrhe.assemble` on the
calling thread, the blocks and samples in order.

`DeviceTimer` turns spans into device seconds: `timer.span(name, key)`
records a CUDA event on the current stream as the span opens and one as
it closes, and keeps the pair pending until the caller has synchronized
the device; `resolve()` then sums the pairs per `Engine.phase_times` key.
A pair measures the stream's time between the two events, so it holds the
work enqueued inside the span and any wait of the stream for the host's
next launch there: where the host launches more slowly than the card
runs, as under a profiler, it reads more than the card's own work in the
span (profile_run.by_span gives that by correlation id). The pairs are
recorded while tracing is on, or always for a key the caller asks to be
(`always=True`). On the CPU, where torch runs each operation before it
returns, the host clock stands in for the events. A resolved CUDA event is kept for reuse: creating one costs far
more than recording it.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "pyrhe."
_OFF = contextlib.nullcontext()
_FREE_EVENTS: dict[int, list] = {}     # resolved CUDA events, per device


def tracing() -> bool:
    """True while a torch profiler runs (torch.profiler.profile or
    torch.autograd.profiler.profile), in any thread of the process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A `pyrhe.<name>` span while tracing is on, else a shared no-op
    context."""
    if not tracing():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def profiler(activities):
    """torch.profiler.profile over `activities` that records every thread
    of the process, the prefetch thread's spans among them."""
    return torch.profiler.profile(
        activities=activities,
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))


class _Timed:
    """A span with a start and an end mark on the timer's clock."""
    __slots__ = ("timer", "key", "ctx", "start")

    def __init__(self, timer, key, ctx):
        self.timer, self.key, self.ctx = timer, key, ctx

    def __enter__(self):
        self.ctx.__enter__()
        self.start = self.timer._mark()

    def __exit__(self, *exc):
        self.timer.pending.append((self.key, self.start, self.timer._mark()))
        return self.ctx.__exit__(*exc)


class DeviceTimer:
    """Device seconds of spans per phase_times key, pending until the
    device has been synchronized."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: list = []        # (key, start mark, end mark)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        free = _FREE_EVENTS.setdefault(torch.cuda.current_device(), [])
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(self, name: str, key: str, *, always: bool = False):
        """The span `pyrhe.<name>` (see span), timed into `key` while
        tracing is on, or always with always=True; else the shared no-op
        context."""
        if not (always or tracing()):
            return _OFF
        return _Timed(self, key, span(name))

    def resolve(self) -> dict:
        """{key: seconds} of the pending spans, which are dropped; call it
        once the device has run past every end mark."""
        out: dict[str, float] = {}
        for key, a, b in self.pending:
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[key] = out.get(key, 0.0) + dt
        if self.cuda:
            _FREE_EVENTS.setdefault(torch.cuda.current_device(), []).extend(
                ev for _, a, b in self.pending for ev in (a, b))
        self.pending = []
        return out
