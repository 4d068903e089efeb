"""Host-to-card copy rate from pinned and pageable memory over 1-4 CUDA
streams.

    python -m pyrhe_tpu_torch.bench.staging [--chunk_mb 64] [--chunks 8]
        [--streams 1,2,3,4]

The port's counterpart of scripts/bench_staging.py. Moves `--chunks`
host buffers of `--chunk_mb` MB each into device buffers allocated once,
the chunks dealt round-robin to S torch.cuda.Stream side streams, each
copy non_blocking; the start is an event on the current stream that every
side stream waits on, the end an event the current stream records after
waiting on every side stream, followed by a synchronize. For each memory
kind (pinned: the engine's staging buffers; pageable: plain host memory,
which CUDA copies through a pinned bounce buffer) and stream count,
prints the median, quartiles and count of MB/s over 5 repeats after
one warm-up, as ONE JSON line with the card's name and power limit. This
is the number a side copy stream for the engine's staging needs.

It measures copies to the card, so it has no CPU mode: without a card it
raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from .timing import card, require_card, summary

REPS = 5


def copy_ms(srcs, dsts, n_streams: int) -> float:
    """Device ms (events) of copying every srcs[i] into dsts[i], chunk i on
    side stream i % n_streams."""
    cur = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(n_streams)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(cur)
    for s in streams:
        s.wait_event(start)
    for i, (src, dst) in enumerate(zip(srcs, dsts)):
        with torch.cuda.stream(streams[i % n_streams]):
            dst.copy_(src, non_blocking=True)
    for s in streams:
        cur.wait_stream(s)
    end.record(cur)
    end.synchronize()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure(chunk_mb: int, chunks: int, streams, dev,
            reps: int = REPS) -> list:
    """One row a (memory kind, stream count)."""
    n = chunk_mb << 20
    dsts = [torch.empty(n, dtype=torch.uint8, device=dev)
            for _ in range(chunks)]
    mb = chunk_mb * chunks * (1 << 20) / 1e6
    rows = []
    for kind in ("pinned", "pageable"):
        srcs = [torch.full((n,), i, dtype=torch.uint8,
                           pin_memory=kind == "pinned")
                for i in range(chunks)]
        for ns in streams:
            copy_ms(srcs, dsts, ns)                 # warm-up
            s = summary([mb / (copy_ms(srcs, dsts, ns) / 1e3)
                         for _ in range(reps)])
            rows.append({"memory": kind, "streams": ns, "mb": mb,
                         "mb_s": s["median"], "mb_s_q1": s["q1"],
                         "mb_s_q3": s["q3"], "samples": s["n"]})
        del srcs
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk_mb", type=int, default=64)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--streams", default="1,2,3,4")
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda) | cuda; raises without a card")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    if dev.type != "cuda":
        raise RuntimeError("bench.staging measures copies to the card; it "
                           "has no CPU mode")
    print(json.dumps({
        "tool": "staging", "device": card(dev),
        "chunk_mb": args.chunk_mb, "chunks": args.chunks,
        "rows": measure(args.chunk_mb, args.chunks,
                        [int(s) for s in args.streams.split(",")], dev)}))


if __name__ == "__main__":
    main()
