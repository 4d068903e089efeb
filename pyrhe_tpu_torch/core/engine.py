"""The RHE estimation engine on PyTorch: one device, blocks one at a time.

Port of pyrhe_tpu/core/engine.py for RHE, RHE-DOM and GENIE in every
working dtype. Orchestrates the method-of-moments pipeline over jackknife
blocks:

  pass 1   for each SNP block j: host .bed read + imputation fills +
           missing-code clean (one block ahead, on a background thread)
           -> pinned host buffer -> non-blocking copy to the device ->
           decode + standardize + fused products (ops/moments) ->
           accumulate totals; cache the per-block stats of the first
           `cache_limit` blocks unless streaming.
  pass 2   per-sample leave-one-out stats (total - block, GENIE's
           analytic NxE rows appended) -> assemble (T, q) on the device,
           one jackknife sample at a time, walking the blocks in order:
           cached blocks are popped, the others recomputed (all of them
           when streaming); the SUMRHE trace sums from the assembled T when
           asked for (get_trace).
  solve    QR per sample + jackknife SEs + h2/enrichment (core/solver.py,
           host float64).

Cache modes, all bitwise equal in (T, q): cached (every block's stats on
the device), hybrid (the first cache_limit blocks: --cache_blocks, or as
many as fit the device-memory budget), and streaming (nothing cached,
O(E*N*B) device memory independent of J). In a kernel mode, blocks whose
stats are not cached go into the totals through the aliased stage-2
kernels (ops/kernels.ytg_acc_matmul, ytg_acc2_matmul for dominance).
Streaming pass 2 serves the cleaned blocks from a host-RAM cache when they
fit (host_cache_gb), so it does not read the .bed again.

Working dtypes and mm_modes (the reference's): float32 -> split2,
bfloat16 -> bf16 (working dtype float32), float64 -> exact. split2 and
bf16 run the kernels; exact runs ops/moments.block_stats_core, torch
products in the working dtype, and never the f32 acc kernels. On the CPU
the kernels run as their plain versions and split2 takes f32 operands
unsplit, as the reference runs its Pallas kernels in interpret mode; bf16
keeps its bf16 operands there.

Every trait's residualized phenotype is an extra probe column, so all
traits share one precompute and only q differs per trait.

Checkpoint/resume (cfg.checkpoint_dir, core/checkpoint.py): pass 1 saves
its totals and commits at the checkpoint_every cadence (and writes the
cached blocks' stats), pass 2 saves its partial (T, q) in every cache mode,
and a finished run keeps its results; a rerun with the same fingerprint
resumes from the stored state and gives bitwise the same (T, q).
run_sharded() runs the same passes over the blocks of one rank of a
torch.distributed job (parallel/sharded.py).

The device is CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..io.bed import clean_packed
from ..ops.decode import imputed_dosages
from ..ops.kernels import ROW_TILE, TN, pad_to, plane_permutation
from ..ops.moments import (acc_scan_stats, block_stats_core,
                           block_stats_pallas_core, mm, nxe_stats,
                           stage1_colsum)
from ..utils.logger import Logger
from ..utils.trace import DeviceTimer, span
from ..utils.types import GenoImputeMethod
from . import solver as S
from .checkpoint import Checkpoint, CheckpointBusy
from .data import DataBundle
from .normal_eq import assemble_Tq_core


@dataclass(frozen=True)
class ModelSpec:
    """Which variance components to estimate.

    components: tuple of (kind, env_idx) per genotype-backed component,
    kind in {"add", "dom"}; each contributes num_bin estimate rows.
    include_nxe appends num_env analytic hetero-noise rows.
    Estimate ordering matches the reference's (with the corrected GxE
    indexing k_gxe = num_bin + e*num_bin + k, see SURVEY §2.6).
    """
    model: str
    genie_model: str = "G"
    components: tuple = (("add", None),)
    num_env: int = 0
    include_nxe: bool = False

    @staticmethod
    def build(model: str, genie_model: str = "G", num_env: int = 0):
        if model == "rhe":
            return ModelSpec("rhe", components=(("add", None),))
        if model == "rhe_dom":
            return ModelSpec("rhe_dom",
                             components=(("add", None), ("dom", None)))
        if model == "genie":
            comps = [("add", None)]
            include_nxe = False
            if genie_model in ("G+GxE", "G+GxE+NxE"):
                comps += [("add", e) for e in range(num_env)]
            if genie_model == "G+GxE+NxE":
                include_nxe = True
            elif genie_model not in ("G", "G+GxE"):
                raise ValueError("Unsupported GENIE genie_model type")
            return ModelSpec("genie", genie_model, tuple(comps), num_env,
                             include_nxe)
        raise ValueError(f"Unsupported model {model}")


@dataclass
class RunConfig:
    """The reference's RunConfig without its TPU staging knobs
    (use_pallas, stage_streams): the port runs its kernels in the kernel
    mm_modes and stages one block at a time."""
    num_random_vec: int = 10
    num_jack: int = 100
    seed: int = 0
    geno_impute_method: str = "binary"
    dtype: str = "float32"          # float32 | float64 | bfloat16
    streaming: bool = False
    get_trace: bool = False         # SUMRHE trace sums (engine.trace_sums)
    trace_dir: str | None = None
    device: str = "auto"            # auto (= cuda) | cuda[:i] | cpu
    mm_mode: str = "auto"           # auto (from dtype) | exact | split2 | bf16
    checkpoint_dir: str | None = None   # crash-safe snapshots here
    checkpoint_every: int = 1           # snapshot cadence in blocks
    cache_blocks: int = -1          # stats-cache size in blocks: -1 = auto
                                    # (fit the device budget, hybrid when
                                    # short), 0 = cache nothing, J = all;
                                    # ignored when streaming
    host_cache_gb: float = -1.0     # host-RAM cache of cleaned blocks for
                                    # streaming pass 2: -1 = auto (when it
                                    # fits half of MemAvailable), 0 = off,
                                    # > 0 = budget in GB


# working dtype of each dtype setting; bfloat16 keeps float32 state and
# runs the bf16 mm_mode (reference engine._DTYPES)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.float32}
AUTO_MM_MODE = {"float32": "split2", "float64": "exact", "bfloat16": "bf16"}


def resolve_mm_mode(cfg: RunConfig) -> str:
    """The mm_mode a config runs (reference engine.py:150-153); raises on
    an unknown dtype or mm_mode, and on a kernel mode with float64 state
    (the kernels produce f32)."""
    if cfg.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r} "
                         f"({' | '.join(DTYPES)})")
    mode = AUTO_MM_MODE[cfg.dtype] if cfg.mm_mode == "auto" else cfg.mm_mode
    if mode not in ("exact", "split2", "bf16"):
        raise ValueError(f"unsupported mm_mode {cfg.mm_mode!r} "
                         "(auto | exact | split2 | bf16)")
    if mode != "exact" and cfg.dtype == "float64":
        raise ValueError(f"mm_mode {mode!r} runs the float32 kernels; "
                         "float64 runs mm_mode 'exact'")
    return mode


def mem_available_bytes() -> float:
    """MemAvailable of /proc/meminfo, 0 where it cannot be read."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return float(line.split()[1]) * 1024
    except OSError:
        pass
    return 0.0


def pick_device(device: str) -> torch.device:
    """"auto", "cuda" and "gpu" mean the current CUDA device and raise when
    there is none; the CPU runs only when asked for."""
    dev = torch.device("cuda" if device in ("auto", "gpu") else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} needs CUDA but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        return torch.device("cuda", dev.index if dev.index is not None
                            else torch.cuda.current_device())
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (auto|cuda|cpu)")
    return dev


@dataclass
class StaticArrays:
    """The engine's device-resident per-run arrays, N-indexed ones padded
    to n_pad and plane-permuted (ops/kernels.py contract)."""
    P: torch.Tensor              # (n_pad, Bp) [Z | Uzb? | y~ traits]
    # Z, Uzb and C are transposed views of contiguous (k, n_pad) tensors:
    # pass 2's kernel reads Z.T, Uzb.T and C.T along N
    Z: torch.Tensor              # (n_pad, B)
    Uzb: torch.Tensor            # (n_pad, B), zeros without covariates
    C: torch.Tensor | None       # (n_pad, ncov)
    Q: torch.Tensor | None       # (ncov, ncov), not permuted
    valid_mask: torch.Tensor     # (n_pad,) 1.0 at kept individuals
    q_last: torch.Tensor         # (T,) y~^T y~ per trait
    Y: torch.Tensor              # (n_pad, T) residualized phenotypes
    perm: np.ndarray             # (n_pad,) plane permutation
    n_pad: int
    env: torch.Tensor | None = None   # (n_pad, num_env), GENIE only


def static_arrays_from_numpy(Z, Uzb, cov, Q, Y_resid, keep_idx,
                             num_indiv_bed: int, device,
                             dtype=torch.float32, env=None) -> StaticArrays:
    """Build the device tensors from the dataset's numpy arrays.

    Every N-indexed (N_kept, k) array is scattered to n_pad rows at the
    individuals' ORIGINAL .bed positions (zero rows at dropped and padding
    positions) and plane-permuted: the kernels decode the full .bed
    population and dropped individuals ride as rows that valid_mask zeroes
    in every reduction."""
    n_pad = pad_to(num_indiv_bed, TN)
    perm = plane_permutation(n_pad)

    def put(x, transposed=False):
        x = np.asarray(x, np.float64)
        out = np.zeros((n_pad,) + x.shape[1:])
        if keep_idx is None:
            out[:x.shape[0]] = x
        else:
            out[keep_idx] = x
        if transposed:
            return torch.as_tensor(np.ascontiguousarray(out[perm].T),
                                   dtype=dtype, device=device).T
        return torch.as_tensor(out[perm], dtype=dtype, device=device)

    cols = [Z] + ([Uzb] if cov is not None else []) + (
        [Y_resid] if Y_resid.shape[1] else [])
    Zd = put(Z, transposed=True)
    keep = np.zeros(n_pad, dtype=bool)
    if keep_idx is None:
        keep[:Z.shape[0]] = True
    else:
        keep[keep_idx] = True
    return StaticArrays(
        P=put(np.concatenate(cols, axis=1)), Z=Zd,
        Uzb=put(Uzb, True) if cov is not None else torch.zeros_like(Zd),
        C=put(cov, True) if cov is not None else None,
        Q=(torch.as_tensor(Q, dtype=dtype, device=device)
           if cov is not None else None),
        valid_mask=torch.as_tensor(keep[perm], dtype=dtype, device=device),
        q_last=torch.as_tensor((np.asarray(Y_resid) ** 2).sum(axis=0),
                               dtype=dtype, device=device),
        Y=put(Y_resid), perm=perm, n_pad=n_pad,
        env=put(env) if env is not None else None)


def stored_results(ck):
    """(T_all, q_all) of a finished run stored in the checkpoint ck, else
    None (no checkpoint, another phase, or corrupt results)."""
    state = ck.state() if ck is not None else None
    if state is None or state[0] != "done":
        return None
    return ck.load_results()


def imputation_fills(sums, nmiss, n_total: int, seed: int) -> np.ndarray:
    """Per-SNP HWE imputation draws of one block from its observed dosage
    sums and missing counts, reproducing the reference's RNG discipline
    exactly: reseed per block, one uniform draw per SNP whether or not it
    has missing entries (base.py:265-289,510)."""
    n_obs = n_total - nmiss
    p = np.divide(sums, n_obs, out=np.zeros_like(sums),
                  where=n_obs > 0) * 0.5
    rval = np.random.RandomState(seed).random_sample(len(sums))
    d0 = (1 - p) ** 2
    d1 = 2 * p * (1 - p)
    return np.where(rval < d0, 0.0, np.where(rval < d0 + d1, 1.0, 2.0))


def _ticking(blocks, j: int, covered):
    """Yield the blocks, which start at block j, and call covered(j + 1)
    once the consumer asks for the next one or finishes: block j's work is
    then enqueued and its in-place updates of the totals made."""
    for blk in blocks:
        yield blk
        j += 1
        covered(j)


class Engine:
    """The two passes and the solve of one run on one device.

    phase_times holds the run's counters, summed over both passes (the
    keys a run reaches; seconds unless noted):
      engine_init_s    host clock around __init__
      pass1_s, pass2_s host clock of each pass, ending in a device
                       synchronize
      host_read_s      the prefetch thread's read + clean, overlapped with
                       the device's work
      prefetch_wait_s  host clock of the main thread blocked on the
                       prefetch thread (Engine._blocks)
      h2d_s            device time of the block copies (CUDA events)
      block_stats_s    stream time of the block stats (the kernels and
                       their torch glue), per block from the stream's event
                       as `pyrhe.block_stats` opens to the one as it
                       closes; recorded while tracing is on
      assemble_s       the same over each `pyrhe.sample` (the leave-one-out
                       subtraction, the sample's contractions, the
                       covariate-space Grams, T and q), J + 1 samples;
                       recorded while tracing is on
      host_cache_hits  blocks served from the host block cache (a count)
      blocks_read      blocks read from the .bed (a count)
    The device times are resolved after each pass's synchronize; on the
    CPU block_stats_s and assemble_s read the host clock and h2d_s is 0.
    A stream time holds the stream's waits for the host's next launch
    inside the span too, which a profiler lengthens: profile_run gives
    the card's own seconds under each span.

    While a torch profiler runs, the engine opens `pyrhe.*` spans
    (utils/trace.py) at its boundaries: engine_init (plan_cache,
    checkpoint_open, static_arrays with stage1_colsum and nxe_stats,
    host_cache_init, m_matrix), precompute and assemble, per block
    `block` (prefetch_wait, h2d, block_stats), on the prefetch thread
    host_read and clean, per sample `sample` (loo_sub, assemble_Tq with
    sample_contract and, with covariates, cov_gram), and sync and results
    where a pass waits for the device.
    """

    def __init__(self, data: DataBundle, spec: ModelSpec, cfg: RunConfig,
                 log: Logger | None = None):
        t0 = time.perf_counter()
        # Per-estimate counters, summed over both passes (docs in
        # Engine.phase_times below)
        self.phase_times: dict[str, float] = {}
        with span("engine_init"):
            self._setup(data, spec, cfg, log)
        self._phase_add("engine_init_s", time.perf_counter() - t0)

    def _setup(self, data: DataBundle, spec: ModelSpec, cfg: RunConfig,
               log: Logger | None):
        self.mm_mode = resolve_mm_mode(cfg)
        GenoImputeMethod(cfg.geno_impute_method)  # raises on unknown value
        self.data = data
        self.spec = spec
        self.cfg = cfg
        self.log = log or Logger(debug_mode=False)

        self.dev = pick_device(cfg.device)
        self._timer = DeviceTimer(self.dev)
        # f32 products in full f32 (matters for the plain versions and
        # any torch product on the card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = DTYPES[cfg.dtype]
        # the block path's mode (ops/moments): the CPU runs split2 as the
        # plain f32 products unsplit
        self.mode = ("f32" if self.mm_mode == "split2"
                     and self.dev.type == "cpu" else self.mm_mode)
        if self.mm_mode == "exact":
            self.log._log(
                f"Note: mm_mode 'exact' ({cfg.dtype}): the fused kernels are "
                "off; blocks run as torch products in the working dtype")

        self.K = data.num_bin
        self.B = cfg.num_random_vec
        self.J = cfg.num_jack
        self.E_geno = len(spec.components) * self.K
        self.num_nxe = data.num_env if spec.include_nxe else 0
        self.E = self.E_geno + self.num_nxe
        self.T_traits = data.num_traits
        self.use_cov = data.cov is not None
        self.b2 = self.B * (2 if self.use_cov else 1)
        self.n_pad = pad_to(data.bed.num_indiv, TN)
        with span("plan_cache"):
            self.cache_limit = self._plan_cache()
        self._ckpt = self._open_checkpoint()
        with span("static_arrays"):
            self._build_static_arrays()
        self._cache: dict[int, tuple] = {}
        self._block_span = None         # _blocks' open pyrhe.block span
        with span("host_cache_init"):
            self._host_cache = self._init_host_cache()
        self._tot = None
        with span("m_matrix"):
            self.M_mat = self._build_M_matrix()
            self.M_dev = torch.as_tensor(self.M_mat, device=self.dev)
        self.trace_sums = None

    def _phase_add(self, name: str, dt: float):
        self.phase_times[name] = self.phase_times.get(name, 0.0) + dt

    def _cache_budget(self) -> float:
        """Bytes the per-block stats cache may take: half of the free
        device memory on the card (the rest holds the totals, the staged
        block and the working buffers); no limit on the CPU."""
        if self.dev.type != "cuda":
            return float("inf")
        free, _ = torch.cuda.mem_get_info(self.dev)
        return 0.5 * free

    def _plan_cache(self) -> int:
        """How many leading blocks pass 1 caches (reference
        engine.py:160-203): J, or cfg.cache_blocks when set; when the full
        cache exceeds the budget, as many blocks as fit beside a reserve of
        4 block-equivalents (hybrid), and full streaming only when not one
        fits (cfg.streaming is then switched on)."""
        cfg = self.cfg
        if cfg.streaming:
            return 0
        if cfg.cache_blocks >= 0:
            limit = min(cfg.cache_blocks, self.J)
            if limit < self.J:
                self.log._log(
                    f"Note: stats cache capped at {limit}/{self.J} blocks "
                    "(--cache_blocks); the rest is recomputed in pass 2 "
                    "(hybrid)")
            return limit
        per_block = self.stats_block_bytes()
        cache_bytes = self.J * per_block
        budget = self._cache_budget()
        if cache_bytes <= budget:
            return self.J
        fit = int(budget // per_block) - 4
        if fit >= 1:
            self.log._log(
                f"Note: per-block stats cache (~{cache_bytes / 1e9:.1f} GB) "
                f"exceeds the device memory budget; caching {fit}/{self.J} "
                "blocks and recomputing the rest in pass 2 (hybrid)")
            return fit
        self.log._log(
            f"Note: per-block stats cache (~{cache_bytes / 1e9:.1f} GB) "
            "exceeds the device memory budget; using streaming (two-pass) "
            "mode")
        self.cfg = dataclasses.replace(cfg, streaming=True)
        return 0

    def stats_block_bytes(self) -> int:
        """Device bytes of one block's cached stats."""
        return (self.E_geno * self.b2 * self.n_pad
                * torch.finfo(self.dtype).bits // 8)

    def _open_checkpoint(self):
        """The run's Checkpoint (reference engine.py:204-217), or None
        without cfg.checkpoint_dir. Its lock is per rank under
        torch.distributed; when another live run holds the directory this
        run logs a WARNING and does not checkpoint."""
        if not self.cfg.checkpoint_dir:
            return None
        from ..parallel.distributed import world
        rank, size = world()
        lock = ".lock" if size == 1 else f".lock.r{rank}"
        try:
            with span("checkpoint_open"):
                return Checkpoint(self.cfg.checkpoint_dir,
                                  self._fingerprint(), self.log,
                                  lock_name=lock)
        except CheckpointBusy as e:
            # sharing a live run's directory would interleave commits and
            # could reset its state; run un-checkpointed instead
            self.log._log(f"WARNING: {e}; this run will NOT checkpoint")
            return None

    def _fingerprint(self) -> dict:
        """Everything that shapes the checkpointed numerics (reference
        engine.py:236-269): dataset identity and shapes, the estimation
        hyperparameters, the dtype, mm_mode, device type and block mode (the
        card's split2 and the CPU's plain f32 products differ in their last
        bits). No cache split: a hybrid run resumes under any split (the
        reload is tolerant, pass 2 recomputes what is missing). A stored
        checkpoint whose fingerprint differs is discarded."""
        path = getattr(self.data.bed, "path", None)
        try:
            size = os.path.getsize(path) if path else None
            mtime = int(os.path.getmtime(path)) if path else None
        except OSError:
            size = mtime = None
        return {
            # size alone is a pure function of (num_snp, num_indv): mtime
            # and a sampled content hash pin the .bed's identity without
            # reading all of it
            "bed": [str(path), size, mtime, self._bed_sample_sha(path)],
            "num_snp": int(self.data.num_snp),
            "num_indv": int(self.data.num_indv),
            "J": self.J, "B": self.B, "K": self.K,
            "E_geno": self.E_geno, "num_nxe": self.num_nxe,
            "b2": self.b2, "T_traits": self.T_traits,
            "seed": self.cfg.seed, "dtype": self.cfg.dtype,
            "mm_mode": self.mm_mode, "device": self.dev.type,
            "mode": self.mode, "n_pad": int(self.n_pad),
            "model": self.spec.model, "genie_model": self.spec.genie_model,
            "streaming": self.cfg.streaming,
            "impute": self.cfg.geno_impute_method,
            # the probes carry the residualized phenotype and the annot
            # drives the bins: same shapes with other content must not
            # resume
            "aux_sha": self._aux_sha(),
        }

    @staticmethod
    def _bed_sample_sha(path) -> str | None:
        """sha256 over 1 MB samples at the start, middle and end of the
        .bed (reference engine.py:271-290)."""
        if not path:
            return None
        h = hashlib.sha256()
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                for off in sorted({0, max(0, size // 2 - 2**19),
                                   max(0, size - 2**20)}):
                    f.seek(off)
                    h.update(f.read(2**20))
        except OSError:
            return None
        return h.hexdigest()[:16]

    def _aux_sha(self) -> str:
        h = hashlib.sha256()
        for arr in (self.data.pheno, self.data.cov, self.data.env,
                    self.data.annot):
            if arr is not None:
                a = np.ascontiguousarray(np.asarray(arr, np.float64))
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
        return h.hexdigest()[:16]

    def _init_host_cache(self) -> dict | None:
        """Host-RAM cache of the cleaned blocks for streaming pass 2
        (reference engine.py:462-498): pass 1 keeps each block's staged
        words and annot rows, pass 2 serves them instead of reading and
        cleaning the .bed again — bitwise the same bytes (the fills are
        deterministic). On only when streaming; cfg.host_cache_gb -1 =
        auto (when the estimate fits half of MemAvailable), 0 = off, > 0 =
        a budget in GB. The buffers stay pinned, so pass 2's copies run as
        fast as pass 1's."""
        gb = self.cfg.host_cache_gb
        if not self.cfg.streaming or gb == 0:
            return None
        est = float((self.data.num_snp + self.J * ROW_TILE)
                    * (self.n_pad // 4))
        budget = gb * 1e9 if gb > 0 else 0.5 * mem_available_bytes()
        if est > budget:
            self.log._debug(f"host block cache off: needs ~{est / 1e9:.2f} "
                            f"GB, budget {budget / 1e9:.2f} GB")
            return None
        self.log._debug(f"host block cache on (~{est / 1e9:.2f} GB): "
                        "streaming pass 2 will not read the .bed again")
        return {}

    # ------------------------------------------------------------------ setup
    def _build_static_arrays(self):
        d = self.data
        self.Y_resid = d.resid_pheno() if d.pheno is not None else np.zeros(
            (d.num_indv, 0))
        st = self.static = static_arrays_from_numpy(
            d.Z, d.Uzb, d.cov, d.Q, self.Y_resid, d.bed.keep_idx,
            d.bed.num_indiv, self.dev, dtype=self.dtype,
            env=d.env if d.num_env else None)
        # border-trace rows estimated stochastically: GENIE rows k >= K
        # (reference genie.py:84-94); exact tr K = N elsewhere
        mask = np.zeros(self.E, dtype=bool)
        if self.spec.model == "genie":
            mask[self.K:] = True
        self.stoch_mask = torch.as_tensor(mask, device=self.dev)
        with span("stage1_colsum"):
            self.csum = stage1_colsum(self.spec.components, st.P, st.env,
                                      st.valid_mask)
        if self.num_nxe:
            with span("nxe_stats"):
                self.nxe = nxe_stats(st.env, st.Z, st.Uzb, st.Y, self.b2,
                                     self.B)

    def _block_range(self, j: int):
        """Contiguous SNP blocks; last absorbs remainder (reference base.py:362-379)."""
        step = self.data.num_snp // self.J
        start = j * step
        end = start + step if j < self.J - 1 else self.data.num_snp
        return start, end

    def _build_M_matrix(self) -> np.ndarray:
        """M (J+1, E): leave-one-out SNP counts per estimate; last row =
        full-genome counts (reference base.py:450, rhe.py:16); each NxE
        row counts 1 in every sample (genie.py:79-82)."""
        n_comp = len(self.spec.components)
        M = np.ones((self.J + 1, self.E), dtype=np.int64)
        last = np.concatenate([self.data.len_bin] * n_comp)
        M[self.J, :self.E_geno] = last
        for j in range(self.J):
            s, e = self._block_range(j)
            m_blk = self.data.annot[s:e].sum(axis=0)
            M[j, :self.E_geno] = last - np.concatenate([m_blk] * n_comp)
        return M

    # ------------------------------------------------------------- block pass
    def _load_block(self, j: int):
        """Block j's host side, from the host cache when it holds the block
        (counted in phase_times["host_cache_hits"]), else read and kept
        there when the cache is on. Returns (words, annot, seconds)."""
        cache = self._host_cache
        if cache is not None and j in cache:
            self._phase_add("host_cache_hits", 1.0)
            return (*cache[j], 0.0)
        words, annot, dt = self._load_block_uncached(j)
        self._phase_add("blocks_read", 1.0)
        if cache is not None:
            cache[j] = (words, annot)
        return words, annot, dt

    def _load_block_uncached(self, j: int):
        """Host side of block j (runs on the prefetch thread): packed .bed
        rows, imputation fills, and the missing codes rewritten with the
        (integral) fills into a zero-padded (m_pad, n_pad/4) byte buffer —
        pinned when the engine runs on the card — viewed as int32 words.
        Returns (words, annot (m_pad, K) in the working dtype, seconds
        spent)."""
        t0 = time.perf_counter()
        s, e = self._block_range(j)
        m = e - s
        bed = self.data.bed
        with span("host_read"):
            packed = bed.read_packed_block(s, e)
            if self.cfg.geno_impute_method == "binary":
                sums, nmiss = bed.packed_col_stats(packed)
        with span("clean"):
            if self.cfg.geno_impute_method == "binary":
                fill = imputation_fills(sums, nmiss, self.data.num_indv,
                                        self.cfg.seed)
            else:
                fill = np.zeros(m)
            m_pad = pad_to(m, ROW_TILE)
            pin = self.dev.type == "cuda"
            out = torch.empty((m_pad, self.n_pad // 4), dtype=torch.uint8,
                              pin_memory=pin)
            out_np = out.numpy()
            clean_packed(packed, fill, out=out_np)
            out_np[m:] = 0
            annot = torch.zeros((m_pad, self.K), dtype=self.dtype,
                                pin_memory=pin)
            annot[:m] = torch.from_numpy(self.data.annot[s:e]).to(self.dtype)
        return out.view(torch.int32), annot, time.perf_counter() - t0

    def _to_device(self, words, annot):
        """Non-blocking copies from pinned memory, timed by CUDA events
        into h2d_s."""
        if self.dev.type == "cpu":
            return words, annot
        with self._timer.span("h2d", "h2d_s", always=True):
            words = words.to(self.dev, non_blocking=True)
            annot = annot.to(self.dev, non_blocking=True)
        return words, annot

    def _blocks(self, indices):
        """Yield (words, annot) on the device for each block index, with
        the host read + clean running one block ahead on a background
        thread (the role of the reference's worker pool, base.py). Each
        block opens a `pyrhe.block` span that holds the consumer's work on
        it: the span ends when the consumer calls _end_block() or asks for
        the next block."""
        indices = list(indices)
        if not indices:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(self._load_block, indices[0])
            for pos in range(len(indices)):
                self._block_span = span("block")
                self._block_span.__enter__()
                try:
                    with span("prefetch_wait"):
                        t0 = time.perf_counter()
                        words, annot, dt = nxt.result()
                        self._phase_add("prefetch_wait_s",
                                        time.perf_counter() - t0)
                    if pos + 1 < len(indices):
                        nxt = ex.submit(self._load_block, indices[pos + 1])
                    self._phase_add("host_read_s", dt)
                    yield self._to_device(words, annot)
                finally:
                    self._end_block()

    def _end_block(self):
        """End the open `pyrhe.block` span, if any."""
        ctx, self._block_span = self._block_span, None
        if ctx is not None:
            ctx.__exit__(None, None, None)

    def _stat_kw(self) -> dict:
        return dict(n_indiv=self.data.num_indv, b2=self.b2,
                    components=self.spec.components, csum=self.csum)

    def _block_stats(self, words, annot):
        """Per-block stats in the kernels' (E_geno, b2, N) layout, in the
        working dtype."""
        st = self.static
        args = (words, annot, st.P, st.env, st.valid_mask)
        with self._timer.span("block_stats", "block_stats_s"):
            if self.mode == "exact":
                XXP, yXXy, _ = block_stats_core(*args, **self._stat_kw())
            else:
                XXP, yXXy, _ = block_stats_pallas_core(
                    *args, mode=self.mode, **self._stat_kw())
        return XXP.transpose(1, 2), yXXy

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _end_pass(self, name: str, t0: float):
        """Wait for the pass's device work, then add its wall to
        phase_times[name] and its device timers to theirs (h2d_s always)."""
        with span("sync"):
            self._sync()
        self._phase_add(name, time.perf_counter() - t0)
        times = self._timer.resolve()
        self._phase_add("h2d_s", times.pop("h2d_s", 0.0))
        for key, dt in times.items():
            self._phase_add(key, dt)

    def precompute(self):
        """Pass 1: accumulate the totals in block order; the stats of the
        first cache_limit blocks are kept for pass 2 (none when streaming).
        In a kernel mode the other blocks add into the totals in place
        through the aliased kernels (ops/moments.acc_scan_stats); mode
        "exact" adds their standard stats, whose dtype the f32 acc kernels
        do not take (reference engine._acc_fast_path). Bitwise the same
        totals either way. Resumes from the checkpoint when it holds one."""
        t0 = time.perf_counter()
        with span("precompute"):
            self._tot = self._pass1(self._ckpt, 0, self.J, self.cache_limit)
            self._end_pass("pass1_s", t0)

    def _pass1(self, ck, lo: int, hi: int, cache_until: int):
        """Totals (tot_X (E_geno, b2, n_pad), tot_y (E_geno, T)) over the
        blocks [lo, hi), resumed from ck's stored state when there is one;
        blocks below cache_until keep their stats in self._cache and stage
        them into ck. At the checkpoint_every cadence the totals are saved
        and ("precompute", j) committed; at the end ("assemble", lo)."""
        st = self.static
        tot_X = torch.zeros((self.E_geno, self.b2, self.n_pad),
                            dtype=self.dtype, device=self.dev)
        tot_y = torch.zeros((self.E_geno, self.T_traits), dtype=self.dtype,
                            device=self.dev)
        start = self._resume_pass1(ck, lo, hi, tot_X, tot_y)
        if start >= hi:
            return tot_X, tot_y
        every = max(1, self.cfg.checkpoint_every)

        def covered(j):
            """Blocks [lo, j) are in the totals: a snapshot at the cadence
            (the one at hi follows the loop). The copy to the host waits
            for the block's work in stream order."""
            if ck is not None and j < hi and (j - start) % every == 0:
                ck.save_totals(tot_X, tot_y, j)
                ck.commit("precompute", j)

        blocks = self._blocks(range(start, hi))
        split = max(start, min(cache_until, hi))
        for j in range(start, split):
            XXP, yXXy = self._block_stats(*next(blocks))
            tot_X.add_(XXP)
            tot_y.add_(yXXy)
            self._cache[j] = (XXP, yXXy)
            if ck is not None:
                ck.stage_block(j, XXP, yXXy)
            covered(j + 1)
        rest = _ticking(blocks, split, covered)
        if self.mode == "exact":
            for words, annot in rest:
                XXP, yXXy = self._block_stats(words, annot)
                tot_X.add_(XXP)
                tot_y.add_(yXXy)
        else:
            acc_scan_stats(rest, st.P, st.env, st.valid_mask, tot_X, tot_y,
                           K=self.K, mode=self.mode,
                           timed=lambda: self._timer.span("block_stats",
                                                          "block_stats_s"),
                           **self._stat_kw())
        if ck is not None:
            ck.save_totals(tot_X, tot_y, hi)
            ck.commit("assemble", lo)
        return tot_X, tot_y

    def _resume_pass1(self, ck, lo, hi, tot_X, tot_y) -> int:
        """Resume bookkeeping of pass 1 (reference engine.py:685-726):
        loads the stored totals into tot_X / tot_y and the stored block
        stats into self._cache, and returns the first block still to read
        (hi when pass 1 is complete, lo when starting fresh). The start is
        totals.npz's own next_j, not meta's: a crash between the totals
        save and the commit leaves the file one interval ahead, and its
        next_j is what its content covers. Block files are reloaded
        tolerantly (a hybrid run wrote only its budgeted blocks; pass 2
        recomputes a hole), and not below the sample pass 2 resumes at."""
        state = ck.state() if ck is not None else None
        if state is None:
            return lo
        ld = ck.load_totals()
        if ld is None:
            return lo
        phase = state[0]
        start = hi if phase in ("assemble", "done") else ld[2]
        if start <= lo:
            return lo
        tot_X.copy_(torch.from_numpy(ld[0]))
        tot_y.copy_(torch.from_numpy(ld[1]))
        self.log._log(
            f"Resuming precompute from checkpoint: {start - lo}/{hi - lo} "
            f"jackknife blocks already covered ({ck.dir})")
        first = lo
        if phase != "precompute":
            asm = ck.load_assemble()
            first = asm[2] if asm is not None else lo
        for j, (X, y) in ck.load_blocks_partial(upto=start,
                                                 start=first).items():
            self._cache[j] = (torch.from_numpy(X).to(self.dev),
                              torch.from_numpy(y).to(self.dev))
        return start

    # --------------------------------------------------------------- assembly
    def _loo_blocks(self, start: int = 0, hi: int | None = None):
        """Per-block stats of blocks [start, hi) (hi default J) for pass 2,
        in block order
        (reference engine.py:1104-1129): cached blocks are popped (so
        device memory falls as samples are assembled), each run of uncached
        ones is recomputed through one prefetching _blocks walk. Cached
        blocks below start (assembled before a resume) are dropped."""
        hi = self.J if hi is None else hi
        for k in [k for k in self._cache if k < start]:
            del self._cache[k]
        j = start
        while j < hi:
            if j in self._cache:
                with span("block"):
                    stats = self._cache.pop(j)
                yield stats
                j += 1
                continue
            stop = min((k for k in self._cache if k > j), default=hi)
            for words, annot in self._blocks(range(j, stop)):
                stats = self._block_stats(words, annot)
                self._end_block()           # the sample is no block work
                yield stats
            j = stop

    def _assemble_one(self, X, y, j, drop=None):
        """(T, q) of sample j from the (E_geno, b2, N) stats X, y less the
        block stats drop = (bX, by) when given, with the NxE rows appended
        (reference engine._loo_stats); one `pyrhe.sample` span, timed into
        assemble_s. The stats' subtraction and NxE rows are read inside
        pass 2's kernel (assemble_Tq_core); `loo_sub` forms y's."""
        st = self.static
        with self._timer.span("sample", "assemble_s"):
            with span("loo_sub"):
                if drop is not None:
                    y = y - drop[1]
                if self.num_nxe:
                    y = torch.cat([y, self.nxe[1]])
            with span("assemble_Tq"):
                return assemble_Tq_core(
                    X, None if drop is None else drop[0],
                    self.nxe[0] if self.num_nxe else None, y, self.M_dev[j],
                    st.Z.T, st.Uzb.T if self.use_cov else None,
                    None if st.C is None else st.C.T, st.Q, st.q_last,
                    self.stoch_mask, num_random_vec=self.B,
                    n_indiv=self.data.num_indv,
                    n_cov=self.data.cov.shape[1] if self.use_cov else 0)

    def _pass2(self, ck, tot_X, tot_y, lo: int, hi: int):
        """Lists of the (T, q) of the leave-one-out samples [lo, hi), in
        order, resumed from ck's partial (T, q) when it holds them; at the
        checkpoint_every cadence the partial (T, q) is saved and
        ("assemble", j) committed, in every cache mode."""
        Ts, qs, start = self._resume_pass2(ck, lo)
        every = max(1, self.cfg.checkpoint_every)
        for j, drop in enumerate(self._loo_blocks(start, hi), start):
            T, q = self._assemble_one(tot_X, tot_y, j, drop)
            Ts.append(T)
            qs.append(q)
            if ck is not None and (j + 1 - start) % every == 0:
                ck.save_assemble(torch.stack(Ts), torch.stack(qs), j + 1)
                ck.commit("assemble", j + 1)
        return Ts, qs

    def _resume_pass2(self, ck, lo: int):
        """(Ts, qs, first sample to build) from ck's partial (T, q)
        (reference engine.py:1043-1061), or empty lists and lo."""
        state = ck.state() if ck is not None else None
        if state is None or state[0] not in ("assemble", "done"):
            return [], [], lo
        ld = ck.load_assemble()
        if ld is None or ld[2] <= lo:
            return [], [], lo
        T_part, q_part, start = ld
        self.log._log(
            f"Resuming assemble from checkpoint: {start - lo} jackknife "
            f"samples already built ({ck.dir})")
        return (list(torch.from_numpy(T_part).to(self.dev)),
                list(torch.from_numpy(q_part).to(self.dev)), start)

    def assemble(self):
        """Pass 2: T_all (J+1, E+1, E+1) and q_all (J+1, E+1, T) float64,
        one leave-one-out sample at a time on the device; sample J is the
        full data. With a checkpoint the results are saved and ("done", J)
        committed."""
        t0 = time.perf_counter()
        tot_X, tot_y = self._tot
        with span("assemble"):
            Ts, qs = self._pass2(self._ckpt, tot_X, tot_y, 0, self.J)
            T, q = self._assemble_one(tot_X, tot_y, self.J)
            with span("results"):
                self.T_all = torch.stack(Ts + [T]).cpu().numpy().astype(
                    np.float64)
                self.q_all = torch.stack(qs + [q]).cpu().numpy().astype(
                    np.float64)
            self._end_pass("pass2_s", t0)
        if self._ckpt is not None:
            self._ckpt.save_results(self.T_all, self.q_all)
            self._ckpt.commit("done", self.J)
        if self.cfg.get_trace:
            self.trace_sums = self._compute_trace_sums()
        return self.T_all, self.q_all

    def _compute_trace_sums(self):
        """SUMRHE LD-sum matrix (J+1, E, E) from the assembled T (reference
        base.py:598-599)."""
        n = self.data.num_indv
        Mf = self.M_mat.astype(np.float64)
        MM = Mf[:, :, None] * Mf[:, None, :]
        tr = self.T_all[:, :self.E, :self.E]
        return np.where(MM != 0, S.calc_lsum(tr, n, Mf[:, :, None],
                                             Mf[:, None, :]), 0.0)

    # ----------------------------------------------------------- XtXz export
    def get_XtXz(self, output: str, jackknife_blocks: bool = True):
        """X^T X z sumstat export (reference engine.py:1215-1282): per-block
        SNP-side probes Z_j from np.random.default_rng([seed, j]) over the
        block's m SNPs; pass A forms Xz_j = g_j^T Z_j and Xz_total over the
        imputed, UNstandardized dosages; pass B one wide product per block,
        g_i [Xz_total | Xz_1 .. Xz_J]. Writes `<output>.txt.bin` (num_snp,
        B) float64 and, per jackknife block j, `<output>.jack_j.txt.bin`:
        g_i (Xz_total - Xz_j) with block j's own rows deleted; logs the
        trace estimates ||XtXz||^2 / (B M^2). Products run at the engine's
        mm_mode (ops/moments.mm). Returns the (num_snp, B) results."""
        B, J, d = self.B, self.J, self.data
        kw = dict(mm_mode=self.mm_mode, out_dtype=self.dtype)
        Xz = []
        for j, g in enumerate(self._iter_raw_blocks()):
            s, e = self._block_range(j)
            Z = np.random.default_rng([self.cfg.seed, j]).normal(
                size=(e - s, B))
            Xz.append(mm(g.T, torch.as_tensor(Z, dtype=self.dtype,
                                              device=self.dev), **kw))
        Xz_all = torch.stack(Xz)                      # (J, n_pad, B)
        Xz_total = Xz_all.sum(dim=0)                  # (n_pad, B)
        wide = torch.cat([Xz_total[:, :, None]]
                         + ([Xz_all.permute(1, 2, 0)] if jackknife_blocks
                            else []), dim=2).reshape(self.n_pad, -1)
        results = np.zeros((d.num_snp, B))
        cross = (np.zeros((d.num_snp, J, B)) if jackknife_blocks else None)
        for j, g in enumerate(self._iter_raw_blocks()):
            s, e = self._block_range(j)
            out = mm(g, wide, **kw).cpu().numpy().astype(np.float64)
            out = out.reshape(e - s, B, -1)
            results[s:e] = out[:, :, 0]
            if jackknife_blocks:
                cross[s:e] = out[:, :, 1:].transpose(0, 2, 1)

        trace_est = np.square(results).sum() / (B * d.num_snp ** 2)
        self.log._debug(f"The trace estimate is {trace_est}")
        with open(f"{output}.txt.bin", "wb") as f:
            results.tofile(f)
        if jackknife_blocks:
            for j in range(J):
                s, e = self._block_range(j)
                loo = np.delete(results - cross[:, j, :], np.s_[s:e], axis=0)
                jk_trace = np.square(loo).sum() / (B * loo.shape[0] ** 2)
                self.log._debug(f"The trace estimate of {j}-th jackknife "
                                f"block is {jk_trace}")
                with open(f"{output}.jack_{j}.txt.bin", "wb") as f:
                    loo.tofile(f)
        return results

    def _iter_raw_blocks(self, dtype: torch.dtype | None = None):
        """Yield each block's imputed, UNstandardized dosages (m, n_pad) on
        the device in dtype (default the working dtype), plane-permuted,
        zero at dropped and padding individuals (ops/decode)."""
        dtype = dtype or self.dtype
        for j, (words, _) in enumerate(self._blocks(range(self.J))):
            s, e = self._block_range(j)
            yield imputed_dosages(words, e - s, self.static.valid_mask, dtype)

    def unpermute(self, x) -> np.ndarray:
        """(n_pad, ...) rows in the plane-permuted padded order -> (N, ...)
        host rows of the kept individuals in file order."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        natural = np.empty_like(x)
        natural[self.static.perm] = x
        keep = self.data.bed.keep_idx
        return natural[:self.data.num_indv] if keep is None else natural[keep]

    # -------------------------------------------------------------- estimate
    def run_precompute_and_assemble(self):
        """Both passes, or none when the checkpoint holds a finished run's
        results (reference engine.py:1299-1313): they are reloaded, no
        block is read, and the trace sums are recomputed from them."""
        res = stored_results(self._ckpt)
        if res is not None:
            self.T_all, self.q_all = res
            self.log._log("Resumed completed (T, q) from checkpoint "
                          f"({self._ckpt.dir}); skipping both passes")
            if self.cfg.get_trace:
                self.trace_sums = self._compute_trace_sums()
            return
        self.precompute()
        self.assemble()

    def run_sharded(self):
        """Both passes sharded over the jackknife blocks of the current
        torch.distributed world (parallel/sharded.ShardedRunner; one
        process per GPU, or one process without a process group): every
        rank ends with the same T_all / q_all (and trace sums)."""
        from ..parallel.sharded import ShardedRunner
        self.T_all, self.q_all = ShardedRunner(self).run()
        if self.cfg.get_trace:
            self.trace_sums = self._compute_trace_sums()
        return self.T_all, self.q_all

    def estimate(self, trait: int = 0, method: str = "QR"):
        """Returns (sigma_jackknife (J, E+1), sigma_total (E+1,)).

        num_jack == 1 substitutes the full-data sample for the single
        jackknife sample (reference base.py:654-655)."""
        q = self.q_all[:, :, trait]
        T = self.T_all
        if self.J == 1:
            T = T.copy()
            q = q.copy()
            T[0], q[0] = T[1], q[1]
        sigma = S.solve_all(T, q, method=method)
        return sigma[:-1], sigma[-1]
