"""RHE-DOM (additive + dominance). Report parity: reference
models/rhe_dom/rhe_dom.py:76-117 (RHE's report minus overlap/liability).
Port of pyrhe_tpu/models/rhe_dom.py."""
from __future__ import annotations

from .base import BaseModel


class RHE_DOM(BaseModel):
    MODEL = "rhe_dom"
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

        return {
            "sigma_ests_total": sigma_total,
            "sig_errs": sig_errs,
            "h2_total": h2_total,
            "h2_errs": h2_errs,
            "enrichment_total": enr_total,
            "enrichment_errs": enr_errs,
        }


class StreamingRHE_DOM(RHE_DOM):
    """Two-pass low-memory variant."""
    STREAMING = True
