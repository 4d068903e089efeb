"""The variance components of a configuration, and the model file that
states them.

A configuration's `model` names a file h100_bench/models/<model>.py,
loaded by path (as run.py loads metrics/<name>.py). What is particular to
one variance-component model is in that file; reference.py, work.py,
inputs.py and harness.py take it from there and know no model by name. A
model file gives:

  - `layout(config) -> Layout`: the model's rows, below; it raises
    ValueError, naming the configuration, for settings it cannot take;
  - `rows(layout, dosages, seed, env, dtype)`: for one jackknife block,
    the standardized (m, N) rows each genotype component multiplies, in
    the layout's order (an iterable), from the block's raw (m, N) int8
    dosages (-1 = missing, before any fill or standardization), the
    block's HWE seed and the environments (N, num_env) or None, in
    `dtype`;
  - `analytic_rows(env, P, Y) -> (XXP, yXXy)`, where the layout has
    analytic rows: their (num_analytic, N, b2) XXP from the probe side P
    and (num_analytic, R) yXXy from the residualized phenotypes Y;
  - optionally `genetic_value(config, seed, bed_path, annot, device)`,
    the phenotypes' genetic value; without it, inputs.genetic_value's
    additive one.

work.py counts each genotype component as one stage-1 and one stage-2
product of a block. The port builds its own model from the
configuration (harness.prepare). A configuration whose model has no file
is refused by name.
"""
from __future__ import annotations

import importlib.util
import os
import re
from dataclasses import dataclass

MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")


@dataclass(frozen=True)
class Layout:
    """Rows in order: each genotype component's num_bin bins, then the
    analytic rows. A genotype row's M is its bin's SNP count; an analytic
    row's is 1."""
    components: tuple   # names of the genotype components, in row order
    num_bin: int
    num_analytic: int   # rows the model computes whole (analytic_rows)
    stochastic: tuple   # per row: is its trace the probes' estimate, not N

    def __post_init__(self):
        if len(self.stochastic) != self.E:
            raise ValueError(f"{len(self.stochastic)} stochastic flags for "
                             f"{self.E} rows")

    @property
    def E_geno(self) -> int:
        return len(self.components) * self.num_bin

    @property
    def E(self) -> int:
        return self.E_geno + self.num_analytic


def model_files() -> list:
    """The names of the model files there are."""
    return sorted(f[:-3] for f in os.listdir(MODELS)
                  if f.endswith(".py") and not f.startswith("_"))


def model(config: dict):
    """The configuration's model file as a module; raises ValueError,
    naming the configuration and the model files there are, when its
    `model` has none."""
    name = config["model"]
    path = os.path.join(MODELS, f"{name}.py")
    if not (isinstance(name, str) and re.fullmatch(r"[A-Za-z0-9_]+", name)
            and os.path.isfile(path)):
        raise ValueError(f"configuration {config.get('name')!r}: no model "
                         f"file for model {name!r} (model files: "
                         f"{', '.join(model_files())})")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_model_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layout(config: dict) -> Layout:
    """The Layout of a configuration, from its model file."""
    return model(config).layout(config)
