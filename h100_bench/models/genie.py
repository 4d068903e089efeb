"""GENIE: G, G+GxE and G+GxE+NxE (`genie_model`) over `num_env`
environments.

PyRHE's genie.py, in its row order: G's num_bin bins (the standardized
dosages x, trace N); for G+GxE and G+GxE+NxE one GxE component per
environment e (e ⊙ x, num_bin bins each, trace the probes' estimate);
for G+GxE+NxE one analytic noise-by-environment row per environment
(XXP = e² ⊙ [z | Uz], yXXy = ‖e ⊙ ỹ‖², M = 1, trace the probes'
estimate).
"""
from h100_bench import reference
from h100_bench.layout import Layout

GENIE_MODELS = ("G", "G+GxE", "G+GxE+NxE")


def layout(config: dict) -> Layout:
    K = config["num_bin"]
    num_env = config.get("num_env") or 0
    gm = config.get("genie_model")
    if gm not in GENIE_MODELS:
        raise ValueError(f"configuration {config.get('name')!r}: the "
                         f"reference has no GENIE model {gm!r} "
                         f"({' | '.join(GENIE_MODELS)})")
    if gm != "G" and num_env < 1:
        raise ValueError(f"configuration {config.get('name')!r}: "
                         f"{gm} needs num_env >= 1")
    gxe = tuple(f"gxe{e}" for e in range(num_env)) if gm != "G" else ()
    nxe = num_env if gm == "G+GxE+NxE" else 0
    comps = ("g", *gxe)
    E = len(comps) * K + nxe
    return Layout(components=comps, num_bin=K, num_analytic=nxe,
                  stochastic=(False,) * K + (True,) * (E - K))


def rows(lay: Layout, dosages, seed: int, env, dtype):
    x = reference.standardized(dosages, seed, dtype)
    yield x
    for e in range(len(lay.components) - 1):
        yield x * env[:, e][None, :]


def analytic_rows(env, P, Y):
    e2 = (env * env).T[:, :, None]                 # (num_env, N, 1)
    return e2 * P[None, :, :], ((env.T[:, :, None] * Y[None]) ** 2).sum(1)
