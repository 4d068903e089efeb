"""Reference-compatible model classes wrapping the PyTorch engine.

Port of pyrhe_tpu/models/base.py. API parity: construct with file paths +
hyperparams, then call `model(trait, method="QR")` per trait (reference
base.py:24-48,874-886). The expensive precompute runs ONCE for all traits
(every trait's phenotype rides the probe matrix), so per-trait calls after
the first are nearly free.

Accepted-but-inert reference knobs: `num_workers`, `multiprocessing`,
`cuda_num`, and the TPU staging knob `stage_streams`. `device` is "auto"
(= "cuda"), "cuda", "gpu" or "cpu"; a CUDA device that is not available
raises (core/engine.pick_device).
"""
from __future__ import annotations

import numpy as np

from ..core.data import load_dataset
from ..core.engine import (Engine, ModelSpec, RunConfig, check_ported,
                           unported)
from ..core import solver as S
from ..utils.logger import Logger


class BaseModel:
    MODEL = "rhe"
    STREAMING = False

    def __init__(
        self,
        model: str | None = None,
        geno_file: str = None,
        annot_file: str = None,
        pheno_file: str = None,
        cov_file: str = None,
        env_file: str = None,
        genie_model: str = "G",
        num_bin: int = 8,
        num_jack: int = 1,
        num_random_vec: int = 10,
        geno_impute_method: str = "binary",
        cov_impute_method: str = "ignore",
        cov_one_hot_conversion: bool = False,
        categorical_threshhold: int = 100,
        device: str = "auto",
        cuda_num=None,
        num_workers=None,
        multiprocessing: bool = True,
        seed: int | None = None,
        get_trace: bool = False,
        trace_dir: str | None = None,
        samp_prev: float | None = None,
        pop_prev: float | None = None,
        log: Logger | None = None,
        dtype: str = None,
        streaming: bool | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        stage_streams: int = 0,
        host_cache_gb: float = -1.0,
        cache_blocks: int = -1,
    ):
        self.log = log or Logger(debug_mode=False)
        seed = 0 if seed is None else int(seed)
        self.seed = seed
        self.samp_prev = samp_prev
        self.pop_prev = pop_prev
        self.genie_model = genie_model
        self.spec = ModelSpec.build(self.MODEL, genie_model)
        self.cfg = RunConfig(
            num_random_vec=num_random_vec,
            num_jack=num_jack,
            seed=seed,
            geno_impute_method=geno_impute_method,
            dtype="float32" if dtype is None else dtype,
            streaming=(self.STREAMING if streaming is None else streaming),
            get_trace=get_trace,
            trace_dir=trace_dir,
            device=device,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            host_cache_gb=host_cache_gb,
            cache_blocks=cache_blocks,
        )
        # refuse unported features before reading any file
        check_ported(self.spec, self.cfg)

        self.data = load_dataset(
            geno_file,
            annot_file=annot_file,
            pheno_file=pheno_file,
            cov_file=cov_file,
            env_file=None,
            num_bin=num_bin,
            num_random_vec=num_random_vec,
            seed=seed,
            cov_impute_method=cov_impute_method,
            cov_one_hot_conversion=cov_one_hot_conversion,
            categorical_threshhold=categorical_threshhold,
            log=self.log,
        )
        self.engine = Engine(self.data, self.spec, self.cfg, self.log)
        self._computed = False
        self._trait = 0

    # -- reference-parity accessors ---------------------------------------
    @property
    def num_traits(self):
        return self.data.num_traits

    @property
    def num_bin(self):
        return self.data.num_bin

    @property
    def num_estimates(self):
        return self.engine.E

    @property
    def num_indv(self):
        return self.data.num_indv

    @property
    def num_snp(self):
        return self.data.num_snp

    @property
    def binary_pheno(self):
        return self.data.binary_pheno

    @property
    def M(self):
        return self.engine.M_mat

    def _ensure_computed(self):
        if not self._computed:
            self.engine.run_precompute_and_assemble()
            self._computed = True

    def estimate(self, trait: int = 0, method: str = "QR"):
        self._ensure_computed()
        return self.engine.estimate(trait, method)

    def estimate_error(self, ests):
        return list(S.jackknife_se(np.asarray(ests), self.cfg.num_jack))

    def calculate_liability_h2(self, h2, seh2):
        return S.liability_h2(h2, seh2, self.pop_prev, self.samp_prev)

    def compute_h2_nonoverlapping(self, sigma_jack, sigma_total):
        h2 = S.h2_nonoverlapping(np.vstack([sigma_jack, sigma_total[None]]))
        return h2[:-1], h2[-1]

    def compute_h2_overlapping(self, sigma_jack, sigma_total):
        h2 = S.h2_overlapping(np.vstack([sigma_jack, sigma_total[None]]),
                              self.data.annot, self.engine.M_mat,
                              self.cfg.num_jack)
        return h2[:-1], h2[-1]

    def compute_enrichment(self, h2_jack, h2_total):
        enr = S.enrichment(np.vstack([h2_jack, h2_total[None]]),
                           self.engine.M_mat)
        return enr[:-1], enr[-1]

    def get_XtXz(self, output: str, jackknife_blocks: bool = True):
        raise unported("get_XtXz", 12)

    def simulate_pheno(self, sigma_list):
        raise unported("simulate_pheno", 12)

    def run(self, method: str = "QR", trait: int = 0):
        raise NotImplementedError

    def __call__(self, trait: int = 0, method: str = "QR"):
        self._trait = trait
        self.log._log("*****")
        self.log._log(f"OUTPUT FOR TRAIT {trait}: ")
        self._ensure_computed()
        res = self.run(method=method, trait=trait)
        self._check_finite(res)
        return res

    def _check_finite(self, res: dict) -> None:
        """Flag non-finite σ/SE/h²/enrichment loudly instead of letting a
        NaN ride the report as a plausible-looking number: downstream
        regex parsers (SURVEY §4 output contract) would propagate it
        silently. A NaN here means a singular jackknife system or
        degenerate input (constant phenotype/covariate, empty bin)."""
        bad = sorted(
            k for k, v in res.items()
            if not np.all(np.isfinite(np.asarray(v, dtype=np.float64))))
        if bad:
            self.log._log(
                "WARNING: non-finite values in the report: "
                + ", ".join(bad)
                + " — check for a singular jackknife system (constant "
                "phenotype/covariate, empty bin, or J too large for M)")

    # ------------------------------------------------- shared report pieces
    def _report_sigmas(self, sigma_total, sig_errs):
        self.log._log("Variance components: ")
        for i, est in enumerate(sigma_total):
            if i == len(sigma_total) - 1:
                self.log._log(f"Sigma^2_e : {est}  SE : {sig_errs[i]}")
            else:
                self.log._log(f"Sigma^2_g[{i}] : {est}  SE : {sig_errs[i]}")

    def _report_h2(self, h2_total, h2_errs):
        self.log._log("Heritabilities:")
        for i, est in enumerate(h2_total):
            if i == len(h2_total) - 1:
                self.log._log(f"Total h2 : {est} SE: {h2_errs[i]}")
            else:
                self.log._log(f"h2_g[{i}] : {est} : {h2_errs[i]}")

    def _report_enrichment(self, enr_total, enr_errs, header="Enrichments: "):
        self.log._log(header)
        for i, est in enumerate(enr_total):
            self.log._log(f"Enrichment g[{i}] : {est} SE : {enr_errs[i]}")
