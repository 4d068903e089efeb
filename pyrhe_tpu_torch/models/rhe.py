"""RHE (additive model). Report format parity: reference models/rhe/rhe.py:28-101."""
from __future__ import annotations

from .base import BaseModel


class RHE(BaseModel):
    MODEL = "rhe"
    STREAMING = False

    def run(self, method: str = "QR", trait: int = 0):
        sigma_jack, sigma_total = self.estimate(trait, method)
        sig_errs = self.estimate_error(sigma_jack)
        self._report_sigmas(sigma_total, sig_errs)

        h2_jack, h2_total = self.compute_h2_nonoverlapping(
            sigma_jack, sigma_total)
        h2_errs = self.estimate_error(h2_jack)
        self.log._log("*****")
        self._report_h2(h2_total, h2_errs)

        self.log._log("*****")
        enr_jack, enr_total = self.compute_enrichment(h2_jack, h2_total)
        enr_errs = self.estimate_error(enr_jack)
        self._report_enrichment(enr_total, enr_errs)

        self.log._log("*****\n*****\nHeritabilities and enrichments "
                      "computed based on overlapping setting")
        h2_jack_ov, h2_total_ov = self.compute_h2_overlapping(
            sigma_jack, sigma_total)
        h2_errs_ov = self.estimate_error(h2_jack_ov)
        self._report_h2(h2_total_ov, h2_errs_ov)
        enr_jack_ov, enr_total_ov = self.compute_enrichment(
            h2_jack_ov, h2_total_ov)
        enr_errs_ov = self.estimate_error(enr_jack_ov)
        self._report_enrichment(enr_total_ov, enr_errs_ov,
                                header="Enrichments (overlapping def):")

        if self.binary_pheno and self.samp_prev is not None \
                and self.pop_prev is not None:
            self.log._log("*****")
            self.log._log("Liability Scale h2 for binary phenotype:")
            for i, est_h2 in enumerate(h2_total):
                if i == len(h2_total) - 1:
                    out = self.calculate_liability_h2(h2_total[-1],
                                                      h2_errs[-1])
                    self.log._log(f"Total Liability-scale h2 : {out[0]}, "
                                  f"SE: {out[1]}, p-value: {out[2]}")
                else:
                    out = self.calculate_liability_h2(est_h2, h2_errs[i])
                    self.log._log(f"Liability-scale h2_g[{i}] : {out[0]}, "
                                  f"SE: {out[1]}, p-value: {out[2]}")

        return {
            "sigma_ests_total": sigma_total,
            "sig_errs": sig_errs,
            "h2_total": h2_total,
            "h2_errs": h2_errs,
            "enrichment_total": enr_total,
            "enrichment_errs": enr_errs,
            "h2_total_overlap": h2_total_ov,
            "h2_errs_overlap": h2_errs_ov,
            "enrichment_total_overlap": enr_total_ov,
            "enrichment_errs_overlap": enr_errs_ov,
        }


class StreamingRHE(RHE):
    """Two-pass low-memory variant (reference models/rhe/streaming_rhe.py)."""
    STREAMING = True
