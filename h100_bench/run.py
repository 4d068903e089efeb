"""Run one cell of the benchmark of pyrhe_tpu_torch once, on this machine.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads` with its file h100_bench/workloads/<cell>.json; the
configuration and traffic it names are h100_bench/configs/<name>.json and
h100_bench/traffic/<name>.json; each metric is read by
h100_bench/metrics/<metric>.py. See h100_bench/README.md.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer ones), `device` (with --trace 1
also `busy_s` and `window_s`), with --trace 1 `breakdown`, `card` (the
power limit), `wall` (the window's host-clock seconds and their share per
estimate, which the host's .bed read paces: recorded, not a metric),
`estimates` (each estimate's wall and pass times), and last
`checks`, each number compared beside its limit;
the checks are also the last lines of standard error. The run exits
non-zero and prints no result without CUDA or with fewer cards than the
cell asks for, and when a module of JAX or of the JAX package pyrhe_tpu
is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def read_metrics(run, entries: list) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read."""
    out = {}
    for m in entries:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "h100_bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def result(run, trace: bool, kind: str, count: int) -> dict:
    """The result line of a finished run."""
    cell = run.cell
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed,
            "metrics": read_metrics(run, cell.per_layer if trace
                                    else cell.end_to_end),
            "device": {"platform": "gpu", "kind": kind, "count": count,
                       "memory_peak_bytes": run.peak_device_bytes}}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["card"] = {"power": power_limit(), "seed": run.seed}
    line["wall"] = {"window_s": run.window_s, "estimate_s":
                    run.window_s / run.attempted if run.attempted else None}
    line["estimates"] = [
        {"wall_s": e["wall_s"], **{k: e["phase_times"].get(k) for k in
                                   ("pass1_s", "pass2_s", "host_read_s")},
         "solve_s": e["solve_s"]}
        for e in run.estimates]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from h100_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 2
    run = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    if run.forbidden:
        print("loaded after the window: " + ", ".join(run.forbidden),
              file=sys.stderr)
        return 3
    line = result(run, bool(args.trace), torch.cuda.get_device_name(0),
                  cell.chips)
    print(json.dumps(line), flush=True)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
