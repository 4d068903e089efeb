#!/usr/bin/env python
"""The port's API reference: introspect its public modules and write one
markdown page per module, plus an index, under docs/torch/api/.

    python -m pyrhe_tpu_torch.api_docs [--out docs/torch/api] [--check]

Signatures come from inspect.signature, bodies from the docstrings, as
scripts/build_api_docs.py does for the JAX package (the port keeps its own
copy of the rendering: that script imports the JAX package). --check
renders into a temporary directory and exits non-zero when a committed
page differs (tests/test_torch_docs.py runs it). Importing the modules
builds no kernel and needs no card; rendered defaults carry no memory
address, so the pages read the same on every machine and torch build
(`--check` passes on the CPU and on the card).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# public surface: dotted module -> one-line role (page subtitle)
MODULES = [
    ("pyrhe_tpu_torch", "package root: public re-exports"),
    ("pyrhe_tpu_torch.core.data", "dataset ingest: filtering, centering, Q"),
    ("pyrhe_tpu_torch.core.engine", "two-pass estimation engine"),
    ("pyrhe_tpu_torch.core.normal_eq", "normal-equation assembly (T, q)"),
    ("pyrhe_tpu_torch.core.solver", "solvers, jackknife SE, h2/enrichment"),
    ("pyrhe_tpu_torch.core.checkpoint", "crash-safe checkpoint/resume"),
    ("pyrhe_tpu_torch.models.base", "shared model base class + report helpers"),
    ("pyrhe_tpu_torch.models.rhe", "RHE / StreamingRHE"),
    ("pyrhe_tpu_torch.models.rhe_dom", "RHE-DOM (dominance)"),
    ("pyrhe_tpu_torch.models.genie", "GENIE (GxE / NxE)"),
    ("pyrhe_tpu_torch.ops.moments", "block moments and their torch glue"),
    ("pyrhe_tpu_torch.ops.kernels",
     "CUDA kernels for Hopper and their plain PyTorch versions"),
    ("pyrhe_tpu_torch.ops.decode", "2-bit genotype decode primitives"),
    ("pyrhe_tpu_torch.parallel.sharded",
     "jackknife-axis sharding over torch.distributed ranks"),
    ("pyrhe_tpu_torch.parallel.distributed", "process-group set-up"),
    ("pyrhe_tpu_torch.io.bed", "PLINK .bed decoding"),
    ("pyrhe_tpu_torch.io.readers", "bim/fam/annot/pheno/cov/env readers"),
    ("pyrhe_tpu_torch.io.synth", "dataset + phenotype synthesis"),
    ("pyrhe_tpu_torch.bench.timing", "timers, bounds, the card's name"),
    ("pyrhe_tpu_torch.bench.matvec", "pass-1 genotype matvec rate"),
    ("pyrhe_tpu_torch.bench.kernels", "per-kernel times and bounds"),
    ("pyrhe_tpu_torch.bench.e2e", "end-to-end run walls by phase"),
    ("pyrhe_tpu_torch.bench.host_read", "host .bed read + clean rates"),
    ("pyrhe_tpu_torch.bench.staging", "host-to-device copy rates"),
    ("pyrhe_tpu_torch.bench.scaling_study", "run walls over cohort sizes"),
    ("pyrhe_tpu_torch.profile_run", "device time by kernel, idle share"),
    ("pyrhe_tpu_torch.sweep_phenotypes", "many phenotypes, one genome pass"),
    ("pyrhe_tpu_torch.simulate_pheno", "replicate phenotype simulation"),
    ("pyrhe_tpu_torch.make_example", "the example dataset"),
    ("pyrhe_tpu_torch.cohort", "the synthesized biobank-size cohort"),
    ("pyrhe_tpu_torch.utils.add_cov_pheno", "covariate effects on phenotypes"),
    ("pyrhe_tpu_torch.utils.generate_annot", "random annotation files"),
    ("pyrhe_tpu_torch.utils.logger", "report logger"),
    ("pyrhe_tpu_torch.utils.types", "enums"),
    ("pyrhe_tpu_torch.cli", "command-line interface"),
    ("pyrhe_tpu_torch.constant", ".env-style path configuration"),
]

_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def _no_address(text: str) -> str:
    """text without the object addresses a default's repr may carry."""
    return _ADDRESS.sub("", text)


def _sig(obj) -> str:
    try:
        return _no_address(str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    # drop generated boilerplate (a dataclass's signature repr, the
    # object.__init__ stub): noise, not documentation
    if not d or d.startswith("Initialize self."):
        return ""
    name = getattr(obj, "__name__", "")
    if name and d.startswith(name + "("):
        return ""
    return d


def _is_public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def _own_members(cls):
    """(name, function, kind) of the methods and properties cls defines
    itself (inherited ones are documented on the defining class), in
    source order."""
    out = []
    for name, obj in vars(cls).items():
        if not _is_public(name):
            continue
        if isinstance(obj, (staticmethod, classmethod)):
            out.append((name, obj.__func__, "method"))
        elif inspect.isfunction(obj):
            out.append((name, obj, "method"))
        elif isinstance(obj, property) and obj.fget is not None:
            out.append((name, obj.fget, "property"))
    return out


def render_module(dotted: str, role: str) -> str:
    mod = importlib.import_module(dotted)
    lines = [f"# `{dotted}`", "", f"*{role}*", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    classes = [(n, o) for n, o in vars(mod).items()
               if inspect.isclass(o) and o.__module__ == dotted
               and _is_public(n)]
    funcs = [(n, o) for n, o in vars(mod).items()
             if inspect.isfunction(o) and o.__module__ == dotted
             and _is_public(n)]

    for name, cls in classes:
        bases = ", ".join(b.__name__ for b in cls.__bases__
                          if b is not object)
        lines += [f"## class `{name}`" + (f" *({bases})*" if bases else ""),
                  ""]
        doc = _doc(cls)
        if doc:
            lines += [doc, ""]
        if dataclasses.is_dataclass(cls):
            lines += ["| field | default |", "|---|---|"]
            for f in dataclasses.fields(cls):
                dv = ("—" if f.default is dataclasses.MISSING
                      else f"`{_no_address(repr(f.default))}`")
                lines.append(f"| `{f.name}` | {dv} |")
            lines.append("")
        for mname, fn, kind in _own_members(cls):
            tag = " *(property)*" if kind == "property" else ""
            lines += [f"### `{name}.{mname}{_sig(fn)}`{tag}", ""]
            doc = _doc(fn)
            if doc:
                lines += [doc, ""]

    for name, fn in funcs:
        lines += [f"## `{name}{_sig(fn)}`", ""]
        doc = _doc(fn)
        if doc:
            lines += [doc, ""]
    return "\n".join(lines).rstrip() + "\n"


def page_name(dotted: str) -> str:
    return dotted.replace(".", "_") + ".md"


def build(outdir: str) -> dict[str, str]:
    """Render every page and the index into outdir; returns {file: text}."""
    pages = {}
    index = ["# API reference: pyrhe_tpu_torch", "",
             "Generated by `python -m pyrhe_tpu_torch.api_docs`; regenerate "
             "after changing a public signature or docstring "
             "(tests/test_torch_docs.py fails on stale pages).", "",
             "| module | role |", "|---|---|"]
    for dotted, role in MODULES:
        pages[page_name(dotted)] = render_module(dotted, role)
        index.append(f"| [`{dotted}`]({page_name(dotted)}) | {role} |")
    pages["index.md"] = "\n".join(index) + "\n"
    os.makedirs(outdir, exist_ok=True)
    for fname, text in pages.items():
        with open(os.path.join(outdir, fname), "w") as f:
            f.write(text)
    return pages


def stale_pages(outdir: str) -> list[str]:
    """The pages a fresh build would change or add under outdir."""
    with tempfile.TemporaryDirectory() as td:
        pages = build(td)
    stale = []
    for fname, text in pages.items():
        path = os.path.join(outdir, fname)
        if not os.path.exists(path):
            stale.append(fname)
            continue
        with open(path) as f:
            if f.read() != text:
                stale.append(fname)
    return sorted(stale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "torch",
                                                  "api"))
    ap.add_argument("--check", action="store_true",
                    help="fail if the pages under --out differ from a "
                         "fresh build (stale docs)")
    args = ap.parse_args(argv)
    if args.check:
        stale = stale_pages(args.out)
        if stale:
            print("STALE API docs (run python -m pyrhe_tpu_torch.api_docs): "
                  + ", ".join(stale))
            return 1
        print(f"API docs current ({len(MODULES) + 1} pages)")
        return 0
    pages = build(args.out)
    print(f"wrote {len(pages)} pages to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
