"""Rate of the engine's host block pipeline against its thread count.

    python -m pyrhe_tpu_torch.bench.host_read --prefix P [-N n] [-M m]
        [--threads 1,2,4,8] [--span_gb 2.0] [--seed 1] [--device auto]

The port's counterpart of scripts/bench_host_read.py. Per thread count it
reads a contiguous span of `--span_gb` of packed .bed rows (a new random
span each time, so a large file's later spans are not in the page cache)
through the port's io/bed.BedFile(num_threads=nt) and times each stage of
the engine's prefetch (core/engine._load_block_uncached): the read out of
the mmap, packed_col_stats, the imputation draws, and clean_packed into
the engine's staging shape, a zero-padded (m_pad, n_pad/4) buffer, pinned
on the card; on the card also the non-blocking copy of that buffer to the
device (CUDA events). The CPU stages run on resident memory, best of two
(the first call pays first-touch costs). Prints ONE JSON line with a row a
thread count, in packed MB/s per stage and for the whole pipeline.

-N and -M default to the .fam and .bim line counts. Without a card the
tool raises unless --device cpu is passed (then no copy is timed).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..core.engine import imputation_fills
from ..io.bed import BedFile, clean_packed
from ..ops.kernels import ROW_TILE, TN, pad_to
from .timing import card, require_card


def staging_buffer(m: int, n_indiv: int, pin: bool) -> torch.Tensor:
    """The engine's zero-padded (m_pad, n_pad/4) uint8 staging buffer,
    written once, so first-touch page faults stay out of the clean."""
    return torch.zeros((pad_to(m, ROW_TILE), pad_to(n_indiv, TN) // 4),
                       dtype=torch.uint8, pin_memory=pin)


def stage_seconds(bed: BedFile, start: int, stop: int, seed: int,
                  out: np.ndarray, num_threads: int) -> list[float]:
    """Seconds of each host stage of the engine's prefetch for rows
    [start, stop) of the .bed, cleaned into out as the engine stages them:
    the read out of the mmap, packed_col_stats (best of 2), the imputation
    draws, clean_packed (best of 2)."""
    t0 = time.perf_counter()
    # np.array copies out of the mmap (read_packed_block is a lazy view;
    # its page faults would land in the col_stats timing)
    packed = np.array(bed.read_packed_block(start, stop))
    t_read = time.perf_counter() - t0
    t_stats = t_clean = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        sums, nmiss = bed.packed_col_stats(packed)
        t_stats = min(t_stats, time.perf_counter() - t0)
    t0 = time.perf_counter()
    fill = imputation_fills(sums, nmiss, bed.n_keep, seed)
    t_fill = time.perf_counter() - t0
    for _ in range(2):
        t0 = time.perf_counter()
        clean_packed(packed, fill, out=out, num_threads=num_threads)
        t_clean = min(t_clean, time.perf_counter() - t0)
    return [t_read, t_stats, t_fill, t_clean]


def _h2d_ms(buf: torch.Tensor, dev, reps: int = 5) -> float:
    dst = torch.empty_like(buf, device=dev)
    times = []
    for _ in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(buf, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def measure(prefix: str, N: int, M: int, threads, span_gb: float,
            seed: int, dev) -> list[dict]:
    """One row a thread count (module docstring)."""
    bps = (N + 3) // 4
    m_span = int(min(M, span_gb * 1e9 // bps))
    rng = np.random.default_rng(0)
    on_card = dev.type == "cuda"
    buf = staging_buffer(m_span, N, pin=on_card)
    out = buf.numpy()
    rows = []
    for nt in threads:
        bed = BedFile(prefix + ".bed", N, M, num_threads=nt)
        s = int(rng.integers(0, max(1, M - m_span)))
        stages = stage_seconds(bed, s, s + m_span, seed, out, nt)
        t_read, t_stats, t_fill, t_clean = stages
        mb = m_span * bps / 1e6
        row = {"threads": nt, "span_mb": mb, "rows": m_span,
               "staging_shape": list(buf.shape),
               "read_mb_s": mb / t_read, "col_stats_mb_s": mb / t_stats,
               "fill_s": t_fill, "clean_mb_s": mb / t_clean}
        if on_card:
            t_h2d = _h2d_ms(buf, dev) / 1e3
            stages.append(t_h2d)
            row["h2d_mb_s"] = buf.numel() / 1e6 / t_h2d
        row["pipeline_mb_s"] = mb / sum(stages)
        rows.append(row)
    return rows


def _line_count(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefix", required=True)
    ap.add_argument("-N", type=int, default=None)
    ap.add_argument("-M", type=int, default=None)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--span_gb", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda; raises without a card) | cuda | cpu")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    N = args.N or _line_count(args.prefix + ".fam")
    M = args.M or _line_count(args.prefix + ".bim")
    threads = [int(t) for t in args.threads.split(",")]
    print(json.dumps({
        "tool": "host_read", "N": N, "M": M, "device": card(dev),
        "rows": measure(args.prefix, N, M, threads, args.span_gb, args.seed,
                        dev)}))


if __name__ == "__main__":
    main()
