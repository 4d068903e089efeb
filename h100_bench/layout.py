"""The variance components of a configuration, in one place.

reference.py computes them and work.py counts their work; both take them
from here, from the configuration's `model`, `genie_model`, `num_bin` and
`num_env`:

  - `rhe`: one genotype component, G (num_bin rows);
  - `genie`, `genie_model` G: G alone; G+GxE: G and one GxE component per
    environment (e ⊙ x); G+GxE+NxE: those and one noise-by-environment
    row per environment.

Rows are ordered G's bins, then each environment's GxE bins, then the NxE
rows (PyRHE's genie.py order). A G row's trace is N; a GxE or NxE row's is
the probes' estimate. Any other model (RHE-DOM's dominance component, for
one) is refused by name: the plain reference does not compute it.
"""
from __future__ import annotations

from dataclasses import dataclass

GENIE_MODELS = ("G", "G+GxE", "G+GxE+NxE")


@dataclass(frozen=True)
class Layout:
    components: tuple    # environment index per genotype component, None: G
    num_bin: int
    num_nxe: int

    @property
    def E_geno(self) -> int:
        return len(self.components) * self.num_bin

    @property
    def E(self) -> int:
        return self.E_geno + self.num_nxe

    def stochastic(self) -> list:
        """Per row: is its trace the probes' estimate (GxE, NxE) rather
        than N (G)?"""
        return [False] * self.num_bin + [True] * (self.E - self.num_bin)


def layout(config: dict) -> Layout:
    """The Layout of a configuration; raises ValueError, naming it, for a
    model the reference cannot compute."""
    model, K = config["model"], config["num_bin"]
    num_env = config.get("num_env") or 0
    if model == "rhe":
        return Layout((None,), K, 0)
    if model == "genie":
        gm = config.get("genie_model")
        if gm not in GENIE_MODELS:
            raise ValueError(f"configuration {config.get('name')!r}: the "
                             f"reference has no GENIE model {gm!r} "
                             f"({' | '.join(GENIE_MODELS)})")
        if gm != "G" and num_env < 1:
            raise ValueError(f"configuration {config.get('name')!r}: "
                             f"{gm} needs num_env >= 1")
        envs = tuple(range(num_env)) if gm != "G" else ()
        return Layout((None, *envs), K, num_env if gm == "G+GxE+NxE" else 0)
    raise ValueError(f"configuration {config.get('name')!r}: the reference "
                     f"cannot compute model {model!r} (rhe | genie)")
