"""Scaling study of the port: end-to-end time against N x M on the card.

    python -m pyrhe_tpu_torch.bench.scaling_study
        [--sizes 10000x100000,50000x100000] [--data_dir D] [--streaming]
        [--device auto]
        [--out docs/torch/scaling_study.md]
        [--json_out docs/torch/scaling_study.json]
    python -m pyrhe_tpu_torch.bench.scaling_study --merge FILE

The port's counterpart of scripts/scaling_study.py: runs `python -m
pyrhe_tpu_torch.bench.e2e` at each size of the ladder (each in a process
of its own, with e2e's default 3 repeats inside it), keeps its JSON row and
writes the study to docs/torch/scaling_study.{md,json} (never the JAX
study's docs/design/ files), beside the published PyRHE and RHE-mc times.
Rows merge with the study's earlier rows, keyed by shape and
configuration, so the ladder can grow one expensive point at a time;
`--merge FILE` adds the last line of FILE (an e2e row) without running
anything. The study is written after every size; the tool exits non-zero
when a size failed. Without a card the ladder raises unless --device cpu
is passed. scripts/plot_scaling.py (`--json`, `--out`) plots either
study.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# BASELINE.md (plotting_200k.ipynb cell 6): PyRHE on a 5-worker CPU
# cluster node, k=10, 1 bin, J=100, ~500k UKBB SNPs (seconds)
PYRHE_PUBLISHED = {10000: 21.09, 50000: 103.50, 200000: 450.53}
RHEMC_PUBLISHED = {10000: 39.95, 50000: 238.88, 200000: 845.10}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="10000x100000,50000x100000")
    ap.add_argument("--data_dir", default=None,
                    help="dataset directory (e2e's --dir default)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "torch", "scaling_study.md"))
    ap.add_argument("--json_out", default=os.path.join(
        ROOT, "docs", "torch", "scaling_study.json"))
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--device", default="auto",
                    help="auto (= cuda; raises without a card) | cuda | cpu")
    ap.add_argument("--merge", default=None,
                    help="a file whose last line is an e2e JSON row: merge "
                         "it into the study without running anything")
    return ap


def _key(r):
    return (r["N"], r["M"], r.get("model", "rhe"), r.get("streaming", False),
            r.get("dtype", "float32"), r["device"]["name"],
            r.get("cache_blocks", -1), r.get("cold_read", False))


def merge_row(rows, row):
    """rows with row in place of any row of the same key, in key order."""
    rows = [r for r in rows if _key(r) != _key(row)] + [row]
    return sorted(rows, key=lambda r: (r["N"], r["M"],
                                       *(str(x) for x in _key(r)[2:])))


def write_study(rows, json_out, md_out):
    for path in (json_out, md_out):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(json_out, "w") as f:
        json.dump(rows, f, indent=2)
    with open(md_out, "w") as f:
        f.write(render_md(rows))


def _med(summaries, key):
    s = summaries.get(key)
    return "—" if s is None else f"{s['median']:.2f}"


def render_md(rows) -> str:
    lines = [
        "# Scaling study of the PyTorch port: runtime vs dataset size",
        "",
        "Generated by `python -m pyrhe_tpu_torch.bench.scaling_study` from",
        "`python -m pyrhe_tpu_torch.bench.e2e` rows. Times are medians over",
        "the repeats inside one call (`n`); precompute is pass 1 (host read",
        "and clean on the prefetch thread, the copies, the kernels), read",
        "and H2D its overlapped sub-phases (host thread seconds, CUDA-event",
        "seconds of the copies), assemble pass 2, total load to solve. The",
        "PyRHE / RHE-mc columns are the published times of BASELINE.md",
        "(5-worker CPU node, k=10, 1 bin, J=100, ~500k SNPs).",
        "",
        "| N | M | device (power limit) | model | mode | dtype | n "
        "| precompute (s) | read (s) | H2D (s) | assemble (s) | total (s) "
        "| peak (GB) | PyRHE pub (s) | RHE-mc pub (s) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ph, ep, dev = r["phases_s"], r.get("engine_phases_s", {}), r["device"]
        mode = "streaming" if r.get("streaming") else "cached"
        if not r.get("streaming") and r.get("cache_blocks", -1) >= 0:
            mode = f"hybrid({r['cache_blocks']})"
        if r.get("cold_read"):
            mode += "+cold"
        name = dev["name"] + (f" ({dev['power_limit']})"
                              if "power_limit" in dev else "")
        peak = r.get("peak_gb")
        lines.append(
            f"| {r['N']:,} | {r['M']:,} | {name} | {r.get('model', 'rhe')} "
            f"| {mode} | {r.get('dtype', 'float32')} | {ph['total']['n']} "
            f"| {_med(ph, 'precompute')} | {_med(ep, 'host_read_s')} "
            f"| {_med(ep, 'h2d_s')} | {_med(ph, 'assemble')} "
            f"| {_med(ph, 'total')} "
            f"| {'—' if peak is None else format(peak['median'], '.2f')} "
            f"| {PYRHE_PUBLISHED.get(r['N'], '—')} "
            f"| {RHEMC_PUBLISHED.get(r['N'], '—')} |")
    lines += ["", "The published PyRHE / RHE-mc times are at M ≈ 500k SNPs; "
              "rows with M = 500,000 are the direct comparison points.", ""]
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    rows = []
    if os.path.exists(args.json_out):
        with open(args.json_out) as f:
            rows = json.load(f)
    if args.merge:
        with open(args.merge) as f:
            rows = merge_row(rows, json.loads(f.read().strip()
                                              .splitlines()[-1]))
        write_study(rows, args.json_out, args.out)
        print(f"merged {args.merge} -> {args.json_out} and {args.out}")
        return
    from .timing import require_card
    require_card(args.device)
    failed = []
    for size in args.sizes.split(","):
        N, M = (int(x) for x in size.split("x"))
        cmd = [sys.executable, "-m", "pyrhe_tpu_torch.bench.e2e", "-N",
               str(N), "-M", str(M), "--device", args.device]
        if args.data_dir:
            cmd += ["--dir", args.data_dir]
        if args.streaming:
            cmd.append("--streaming")
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if res.returncode != 0:
            print(f"FAILED {size}: {res.stderr[-2000:]}", file=sys.stderr)
            failed.append(size)
            continue
        row = json.loads(res.stdout.strip().splitlines()[-1])
        rows = merge_row(rows, row)
        print(json.dumps(row), flush=True)
        write_study(rows, args.json_out, args.out)   # survive a kill
    print(f"wrote {args.out} and {args.json_out}")
    if failed:
        sys.exit(f"sizes failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
