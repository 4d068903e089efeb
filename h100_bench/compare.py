"""The comparison that decides `correct`.

Numbers compared, each with its limit (the configuration file's
`limits`, set from the card's readings of the port and of the control as
PERF.md records):

  - sigma_gap: over every estimate of the window, every trait, the full
    sample and every leave-one-block-out sample and every variance
    component (and the residual), the largest |sigma²_port -
    sigma²_reference| divided by the trait's residualized phenotype
    variance ỹ'ỹ / N, the scale all the components partition. A NaN
    fails.
  - failed_estimates: estimates that raised or ran another cache mode
    than the cell names; limit 0.
"""
from __future__ import annotations

import numpy as np


def sigma_gap(prog: np.ndarray, ref: np.ndarray, var: np.ndarray) -> float:
    """prog, ref: (R, J+1, E+1) sigma²; var: (R,) phenotype variances."""
    if prog.shape != ref.shape:
        return float("inf")
    gap = np.abs(prog - ref) / var[:, None, None]
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("nan")


def checks(config: dict, prog, ref, var, failed: int) -> dict:
    """{name: (value, limit)} of one run."""
    return {"sigma_gap": (sigma_gap(prog, ref, var),
                          config["limits"]["sigma_gap"]),
            "failed_estimates": (failed, 0)}
