"""CLI of the PyTorch port: `python -m pyrhe_tpu_torch.cli`.

The parser is a copy of pyrhe_tpu/cli.py's (importing that module would
import jax): the same flags as run_rhe.py plus an INI `--config` overlay
with type coercion against argparse defaults (reference run_rhe.py:13-26,
158-220), and the same report schema, so parse_output.py and other
downstream regex parsers keep working. `--device` defaults to the CUDA
card ("auto"); `--device cpu` runs the same path on the CPU.
`--profile_dir d` wraps the trait loop in torch.profiler and writes a
Chrome trace into d. `--checkpoint_dir`, which the port does not run yet,
raises NotImplementedError naming its ROADMAP.md item; `--num_workers`,
`--cuda_num` and `--stage_streams` are accepted for config compatibility
and unused.
"""
from __future__ import annotations

import argparse
import configparser
import contextlib
import os
import time

import numpy as np

from .models import (GENIE, RHE, RHE_DOM, StreamingGENIE, StreamingRHE,
                     StreamingRHE_DOM)
from .utils.logger import Logger


def parse_config(config_path, config_name):
    """{key: raw string} from one INI section.

    Same contract as the reference CLI's config overlay
    (run_rhe.py:13-18): the section name and raw-string values are a
    compatibility surface for existing .txt config files.
    """
    cp = configparser.ConfigParser()
    cp.read(config_path)
    return {k: cp.get(config_name, k) for k in cp.options(config_name)}


# INI values arrive as strings; the argparse default's type decides the
# coercion. bool before int: isinstance(True, int) holds in Python, and
# booleans must parse "true"/"yes" rather than int("true"). float after
# int so integer defaults stay ints and float defaults (host_cache_gb)
# parse "1.5" instead of surviving as strings.
_COERCERS = (
    (bool, lambda s: s.lower() in ("true", "1", "yes")),
    (int, int),
    (float, float),
)


def convert_to_correct_type(value, default):
    """Coerce an INI string to the type of the matching argparse default
    (reference contract: run_rhe.py:19-26 — "none" means None, bools
    accept true/1/yes, ints parse, everything else stays a string)."""
    if value.lower() == "none":
        return None
    for ty, coerce in _COERCERS:
        if isinstance(default, ty):
            return coerce(value)
    return value


def build_parser():
    parser = argparse.ArgumentParser(description="PyRHE-TPU")
    parser.add_argument('--model', type=str, default="rhe",
                        choices=['rhe', 'genie', 'rhe_dom'])
    parser.add_argument('--genie_model', type=str, default="G+GxE+NxE",
                        choices=['G', 'G+GxE', 'G+GxE+NxE'])
    parser.add_argument('--streaming', action='store_true',
                        help='use streaming (two-pass, low-memory) version')
    parser.add_argument('--trace', '-tr', action='store_true',
                        help='get the trace estimate')
    parser.add_argument('--trace_dir', type=str, default="",
                        help='directory to save the trace information')
    parser.add_argument('--benchmark_runtime', action='store_true',
                        help='benchmark the runtime (3 repetitions)')
    parser.add_argument('--genotype', '-g', type=str, help='genotype file path')
    parser.add_argument('--phenotype', '-p', type=str, default=None,
                        help='phenotype file path')
    parser.add_argument('--covariate', '-c', type=str, default=None,
                        help='covariate file path')
    parser.add_argument('--cov_one_hot_conversion', action='store_true',
                        help='write one-hot side files for categorical covariates')
    parser.add_argument('--categorical_threshhold', type=int, default=100)
    parser.add_argument('--env', '-e', type=str, default=None,
                        help='environment file path')
    parser.add_argument('--annotation', '-annot', type=str, default=None,
                        help='annotation file path')
    parser.add_argument('--num_vec', '-k', type=int, default=10,
                        help='number of random probe vectors')
    parser.add_argument('--num_bin', '-b', type=int, default=8,
                        help='number of bins (when no annot file given)')
    parser.add_argument('--num_workers', type=int, default=8,
                        help='accepted for config compatibility (unused)')
    parser.add_argument('--num_block', '-jn', type=int, default=100,
                        help='number of jackknife blocks')
    parser.add_argument('--seed', '-s', default=None, help='random seed')
    parser.add_argument('--device', type=str, default="auto",
                        help='auto (= cuda) | cuda | cpu')
    parser.add_argument('--cuda_num', type=int, default=None,
                        help='accepted for config compatibility (unused)')
    parser.add_argument('--output', '-o', type=str, default="test.out")
    parser.add_argument('--geno_impute_method', type=str, default="binary",
                        choices=['binary', 'mean'])
    parser.add_argument('--cov_impute_method', type=str, default="ignore",
                        choices=['ignore', 'mean'])
    parser.add_argument('--samp_prev', default=None)
    parser.add_argument('--pop_prev', default=None)
    parser.add_argument('--suppress', action='store_true')
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--debug_output', type=str, default="test")
    parser.add_argument('--dtype', type=str, default=None,
                        choices=[None, 'float32', 'float64', 'bfloat16'],
                        help='working dtype (default float32, mm_mode '
                             'split2; float64 runs mm_mode exact, bfloat16 '
                             'mm_mode bf16)')
    parser.add_argument('--profile_dir', type=str, default=None,
                        help='write a torch.profiler trace of the run '
                             'into this directory')
    parser.add_argument('--checkpoint_dir', type=str, default=None,
                        help='directory for crash-safe resume snapshots; '
                             'a rerun with the same config resumes from '
                             'the last completed block')
    parser.add_argument('--checkpoint_every', type=int, default=1,
                        help='snapshot cadence in jackknife blocks/chunks')
    parser.add_argument('--stage_streams', type=int, default=0,
                        help='accepted for config compatibility (unused)')
    parser.add_argument('--cache_blocks', type=int, default=-1,
                        help='stats-cache size in jackknife blocks '
                             '(per device when sharded): -1 auto-fits '
                             'the HBM budget (hybrid when short), 0 '
                             'recomputes everything in pass 2')
    parser.add_argument('--host_cache_gb', type=float, default=-1.0,
                        help='host-RAM cache of cleaned packed blocks so '
                             'the streaming pass 2 skips the .bed re-read;'
                             ' -1 = auto (fit in half of free RAM), 0 = '
                             'off, >0 = budget in GB')
    parser.add_argument('--config', type=str, help='configuration file path')
    return parser


HEADER = [
    "##################################",
    "#                                #",
    "#        PyRHE-TPU (v0.1.0)      #",
    "#                                #",
    "##################################",
]


def main(args):
    log = Logger(output_file=args.output, suppress=args.suppress,
                 debug_mode=args.debug)
    for line in HEADER:
        log._log(line)
    log._log("\n")
    options = {
        "-g (genotype)": args.genotype,
        "-annot (annotation)": args.annotation,
        "-p (phenotype)": args.phenotype,
        "-c (covariates)": args.covariate,
        "-o (output)": args.output,
        "-k (# random vectors)": args.num_vec,
        "-jn (# jackknife blocks)": args.num_block,
        "--num_workers": args.num_workers,
        "--device": args.device,
        "--geno_impute_method": args.geno_impute_method,
        "--cov_impute_method": args.cov_impute_method,
    }
    log._log("Active essential options:")
    for flag, desc in options.items():
        log._log(f"\t{flag} {desc}")
    log._log("\n")
    log._debug(args)

    if (args.samp_prev is not None) != (args.pop_prev is not None):
        raise ValueError(
            'Must set both or neither of --samp-prev and --pop-prev.')

    params = {
        'geno_file': args.genotype,
        'annot_file': args.annotation,
        'pheno_file': args.phenotype,
        'cov_file': args.covariate,
        'num_jack': args.num_block,
        'num_bin': args.num_bin,
        'num_random_vec': args.num_vec,
        'geno_impute_method': args.geno_impute_method,
        'cov_impute_method': args.cov_impute_method,
        'cov_one_hot_conversion': args.cov_one_hot_conversion,
        'categorical_threshhold': args.categorical_threshhold,
        'device': args.device,
        'seed': int(args.seed) if args.seed is not None else None,
        'get_trace': args.trace,
        'trace_dir': args.trace_dir,
        'samp_prev': (float(args.samp_prev)
                      if args.samp_prev is not None else None),
        'pop_prev': (float(args.pop_prev)
                     if args.pop_prev is not None else None),
        'log': log,
        'dtype': args.dtype,
        'streaming': args.streaming,
        'checkpoint_dir': args.checkpoint_dir,
        'checkpoint_every': args.checkpoint_every,
        'stage_streams': args.stage_streams,
        'host_cache_gb': args.host_cache_gb,
        'cache_blocks': args.cache_blocks,
    }

    if args.model == "rhe":
        cls = StreamingRHE if args.streaming else RHE
    elif args.model == "genie":
        params['env_file'] = args.env
        params['genie_model'] = args.genie_model
        cls = StreamingGENIE if args.streaming else GENIE
    elif args.model == "rhe_dom":
        cls = StreamingRHE_DOM if args.streaming else RHE_DOM
    else:
        raise ValueError("Unsupported Model")

    rhe = cls(**params)

    results = {}
    runtime = 0.0
    with _profiler(args.profile_dir, rhe.engine.dev) as prof:
        for trait in range(rhe.num_traits):
            start = time.time()
            res_dict = rhe(trait=trait)
            runtime = time.time() - start
            results[f"Trait{trait}"] = {**res_dict, "runtime": runtime}
    if prof is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        log._log(f"Profiler trace written to {args.profile_dir}")

    log._log("Runtime: ", runtime)
    log._save_log()
    return runtime


def _profiler(profile_dir, device):
    """torch.profiler over the host and, on the card, the device activity
    when profile_dir is set (the reference's jax.profiler trace), else a
    no-op context yielding None."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def cli_entry(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        config_args = parse_config(args.config, 'PyRHE_Config')
        for key, default in vars(args).items():
            if key in config_args:
                setattr(args, key, convert_to_correct_type(
                    config_args[key], default))
    if args.benchmark_runtime:
        runtimes = []
        for _ in range(3):
            runtimes.append(main(args))
        print(f"runtime: {np.mean(runtimes):.2f} ± "
              f"{np.std(runtimes):.2f} seconds")
    else:
        main(args)


if __name__ == '__main__':
    cli_entry()
