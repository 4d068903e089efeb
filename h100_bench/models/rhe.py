"""RHE: one additive genotype component, G, num_bin rows.

PyRHE's rhe.py: the rows are the standardized dosages x of the bin's SNPs,
and a G row's trace is N.
"""
from h100_bench import reference
from h100_bench.layout import Layout


def layout(config: dict) -> Layout:
    K = config["num_bin"]
    return Layout(components=("g",), num_bin=K, num_analytic=0,
                  stochastic=(False,) * K)


def rows(lay: Layout, dosages, seed: int, env, dtype):
    return [reference.standardized(dosages, seed, dtype)]
