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

Under a torch.distributed job of more than one process the estimate is
sharded over the jackknife blocks (Engine.run_sharded). The torch idiom is
one process per GPU (`torchrun --nproc_per_node G`): unlike the JAX
package, one process does not spread itself over several local devices.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.data import load_dataset
from ..core.engine import Engine, ModelSpec, RunConfig, resolve_mm_mode
from ..core import solver as S
from ..parallel import distributed
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
        # refuse an unknown dtype or mm_mode before reading any file
        resolve_mm_mode(self.cfg)

        self.data = load_dataset(
            geno_file,
            annot_file=annot_file,
            pheno_file=pheno_file,
            cov_file=cov_file,
            env_file=env_file if self.MODEL == "genie" else None,
            num_bin=num_bin,
            num_random_vec=num_random_vec,
            seed=seed,
            cov_impute_method=cov_impute_method,
            cov_one_hot_conversion=cov_one_hot_conversion,
            categorical_threshhold=categorical_threshhold,
            log=self.log,
        )
        if self.MODEL == "genie":
            self.log._log(f"Number of environments: {self.data.num_env}")
            self.log._log(f"GENIE model: {genie_model}")
        self.spec = ModelSpec.build(self.MODEL, genie_model,
                                    self.data.num_env)
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
            if self._want_sharded():
                self.engine.run_sharded()
            else:
                self.engine.run_precompute_and_assemble()
            self._computed = True

    def _want_sharded(self) -> bool:
        """The sharded path under a torch.distributed job of more than one
        process (reference models/base.py:157-177); PYRHE_TPU_DISTRIBUTED=0
        disables it, and =1 in a single process logs a note and runs the
        sequential engine. Any num_jack works."""
        forced = os.environ.get("PYRHE_TPU_DISTRIBUTED")
        if forced == "0":
            return False
        if distributed.world()[1] > 1:
            return True
        if forced == "1":
            self.log._log(
                "Note: PYRHE_TPU_DISTRIBUTED set but only one process is "
                "running; running the sequential engine")
        return False

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

    def get_trace_summary(self):
        """Write SUMRHE-compatible `<prefix>.MN` and `<prefix>.tr` sumstats
        (reference base.py:831-855), prefix `run_<pheno file name>` in
        cfg.trace_dir when that is a directory, else in the working
        directory.

        The `.tr` format is SUMRHE's and carries only the K genetic-bin
        rows/columns. When E > K (GENIE) a second file `<prefix>.all.tr`
        holds every component's row (K genetic bins, then K*num_env GxE
        bins, then num_env NxE columns)."""
        trace_sums = self.engine.trace_sums
        pheno_path = (os.path.basename(self.data.pheno_file)
                      if self.data.pheno_file else None)
        trace_filename = f"run_{pheno_path}"
        trace_dir = self.cfg.trace_dir
        if trace_dir and os.path.isdir(trace_dir):
            trace_prefix = os.path.join(trace_dir, trace_filename)
        else:
            trace_prefix = trace_filename
        K = self.num_bin
        with open(trace_prefix + ".MN", "w") as fd:
            fd.write("NSAMPLE,NSNPS,NBLKS,NBINS,K\n")
            fd.write(f"{self.num_indv:.0f},{self.num_snp:.0f},"
                     f"{self.cfg.num_jack:.0f},{K:.0f},"
                     f"{self.cfg.num_random_vec:.0f}")
        self._write_tr(trace_prefix + ".tr", trace_sums, K)
        if trace_sums.shape[1] > K:
            self._write_tr(trace_prefix + ".all.tr", trace_sums,
                           trace_sums.shape[1])
        self.log._log(f"Saved trace summary into {trace_prefix}(.tr/.MN)")

    def _write_tr(self, path, trace_sums, E):
        """The leading (E, E) block of every sample's trace sums, one row
        per estimate with its jackknife SNP count."""
        with open(path, "w") as fd:
            fd.write(",".join(f"LD_SUM_{i:d}" for i in range(E))
                     + ",NSNPS_JACKKNIFE\n")
            for j in range(self.cfg.num_jack + 1):
                for k in range(E):
                    row = ",".join(f"{trace_sums[j, k, l]:.3f}"
                                   for l in range(E))
                    fd.write(row + f",{self.engine.M_mat[j, k]:.0f}\n")

    def get_XtXz(self, output: str, jackknife_blocks: bool = True):
        """X^T X z sumstat export (reference models/base.py:250-252,
        core/engine.get_XtXz)."""
        return self.engine.get_XtXz(output, jackknife_blocks)

    def simulate_pheno(self, sigma_list):
        """Simulate y = sum_k X_k beta_k (+ cov effect) + e over the
        imputed, unstandardized dosages and install it as the phenotype
        (reference models/base.py:254-289): beta ~ N(0, sigma_k / M_k) per
        SNP of bin k from RandomState(seed), g^T beta accumulated per block
        in float64 on the device, then the noise and covariate effect on
        the host. Rebuilds the engine (the phenotype rides the probe
        matrix). Returns (y, betas)."""
        d = self.data
        if len(sigma_list) != d.num_bin:
            raise ValueError("Number of elements in sigma list should be "
                             "equal to number of bins")
        rng = np.random.RandomState(self.seed)
        len_bin = d.len_bin.astype(np.float64)
        scale_per_bin = np.sqrt(
            np.where(len_bin > 0, np.asarray(sigma_list) /
                     np.maximum(len_bin, 1), 0.0))
        betas = np.zeros(d.num_snp)
        eng = self.engine
        gb = torch.zeros(eng.n_pad, dtype=torch.float64, device=eng.dev)
        for j, g in enumerate(eng._iter_raw_blocks(torch.float64)):
            s, e = eng._block_range(j)
            beta = rng.randn(e - s) * (d.annot[s:e] @ scale_per_bin)
            betas[s:e] = beta
            gb += torch.as_tensor(beta, device=eng.dev) @ g
        y = eng.unpermute(gb)
        resid = 1.0 - float(np.sum(sigma_list))
        y += rng.randn(d.num_indv) * np.sqrt(max(resid, 0.0))
        if d.cov is not None:
            y = y + d.cov @ np.ones(d.cov.shape[1])
        y = y - y.mean()
        d.pheno = y[:, None]
        d.binary_pheno = False
        self._reset_engine()
        return y, betas

    def _reset_engine(self):
        """Rebuild the engine after the phenotype changed (the phenotype
        rides the probe matrix, so precompute must rerun)."""
        self.engine = Engine(self.data, self.spec, self.cfg, self.log)
        self._computed = False

    def run(self, method: str = "QR", trait: int = 0):
        raise NotImplementedError

    def __call__(self, trait: int = 0, method: str = "QR"):
        self._trait = trait
        self.log._log("*****")
        self.log._log(f"OUTPUT FOR TRAIT {trait}: ")
        self._ensure_computed()
        if self.cfg.get_trace:
            self.get_trace_summary()
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
