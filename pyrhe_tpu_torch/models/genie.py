"""GENIE (gene-environment interaction: G / G+GxE / G+GxE+NxE).

Port of pyrhe_tpu/models/genie.py. Report parity: reference models/genie/genie.py:222-300. Heritabilities use
the trace-adjusted sigmas sigma_i * T[i, E] (genie.py:128-131); enrichment
covers genetic bins only (genie.py:191-219). Implements the CORRECT GxE
estimate indexing k_gxe = num_bin + e*num_bin + k (the reference's
(e+1)*k + num_bin at genie.py:65 collides for num_env > 1; identical for
the tested num_env == 1).
"""
from __future__ import annotations

import numpy as np

from ..core import solver as S
from .base import BaseModel


class GENIE(BaseModel):
    MODEL = "genie"
    STREAMING = False

    def __init__(self, env_file: str = None, genie_model: str = "G+GxE+NxE",
                 **kwargs):
        super().__init__(env_file=env_file, genie_model=genie_model, **kwargs)

    @property
    def num_env(self):
        return self.data.num_env

    @property
    def num_gen_env_bin(self):
        return (self.num_bin * self.num_env
                if self.genie_model in ("G+GxE", "G+GxE+NxE") else 0)

    def estimate(self, trait: int = 0, method: str = "QR"):
        """Returns (sigma_jack, sigma_total, sigma_jack_adj, sigma_total_adj);
        adj_i = sigma_i * T[i, E] (reference genie.py:97-144)."""
        self._ensure_computed()
        sigma_jack, sigma_total = self.engine.estimate(trait, method)
        sigma = np.vstack([sigma_jack, sigma_total[None]])
        border = self.engine.T_all[:, :, self.engine.E]  # (J+1, E+1)
        if self.cfg.num_jack == 1:
            border = border.copy()
            border[0] = border[1]
        adj = sigma * border
        return sigma_jack, sigma_total, adj[:-1], adj[-1]

    def compute_h2_nonoverlapping(self, sigma_jack_adj, sigma_total_adj):
        h2 = S.genie_h2_nonoverlapping(
            np.vstack([sigma_jack_adj, sigma_total_adj[None]]),
            self.num_bin, self.num_gen_env_bin, self.num_env,
            self.genie_model)
        return h2[:-1], h2[-1]

    def compute_enrichment(self, h2_jack, h2_total):
        enr = S.genie_enrichment(h2_jack, h2_total, self.engine.M_mat,
                                 self.num_bin)
        return enr[:-1], enr[-1]

    def run(self, method: str = "QR", trait: int = 0):
        (sigma_jack, sigma_total,
         sigma_jack_adj, sigma_total_adj) = self.estimate(trait, method)
        sig_errs = self.estimate_error(sigma_jack)

        K, G, E = self.num_bin, self.num_gen_env_bin, self.num_env
        self.log._log("Variance components: ")
        for i, est in enumerate(sigma_total):
            if self.genie_model == "G":
                if i != len(sigma_total) - 1:
                    self.log._log(f"Sigma^2_g[{i}] : {est}  SE : {sig_errs[i]}")
            elif i < K:
                self.log._log(f"Sigma^2_g[{i}] : {est}  SE : {sig_errs[i]}")
            elif i < K + G:
                self.log._log(f"Sigma^2_gxe[{i - K}] : {est}  SE : {sig_errs[i]}")
            elif i < K + G + E and self.genie_model == "G+GxE+NxE":
                self.log._log(f"Sigma^2_nxe[{i - K - G}] : {est}  SE : {sig_errs[i]}")
        self.log._log(f"Sigma^2_e : {sigma_total[-1]}  SE : {sig_errs[-1]}")

        h2_jack, h2_total = self.compute_h2_nonoverlapping(
            sigma_jack_adj, sigma_total_adj)
        h2_errs = self.estimate_error(h2_jack)
        self.log._log("*****")
        self.log._log("Heritabilities:")
        n_est = self.engine.E
        for i, est in enumerate(h2_total):
            if i < K:
                self.log._log(f"h2_g[{i}] : {est} SE : {h2_errs[i]}")
            elif i < K + G:
                self.log._log(f"h2_gxe[{i - K}] : {est} SE : {h2_errs[i]}")
            elif i < n_est:
                self.log._log(f"h2_nxe[{i - K - G}] : {est} SE : {h2_errs[i]}")
            elif i == n_est:
                self.log._log(f"Total h2 : {est} SE: {h2_errs[i]}")
            elif i == n_est + 1:
                self.log._log(f"Total h2_g : {est} SE: {h2_errs[i]}")
            elif i == n_est + 2:
                self.log._log(f"Total h2_gxe : {est} SE: {h2_errs[i]}")

        self.log._log("*****")
        self.log._log("Enrichments:")
        enr_jack, enr_total = self.compute_enrichment(h2_jack, h2_total)
        enr_errs = self.estimate_error(enr_jack)
        for i, est in enumerate(enr_total):
            self.log._log(f"Enrichment g[{i}] : {est} SE : {enr_errs[i]}")

        return {
            "sigma_ests_total": sigma_total,
            "sig_errs": sig_errs,
            "h2_total": h2_total,
            "h2_errs": h2_errs,
            "enrichment_total": enr_total,
            "enrichment_errs": enr_errs,
        }


class StreamingGENIE(GENIE):
    STREAMING = True
