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

The device is CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..io.bed import clean_packed
from ..ops.decode import imputed_dosages
from ..ops.kernels import ROW_TILE, TN, pad_to, plane_permutation
from ..ops.moments import (acc_scan_stats, block_stats_core,
                           block_stats_pallas_core, mm, nxe_stats)
from ..utils.logger import Logger
from ..utils.types import GenoImputeMethod
from . import solver as S
from .data import DataBundle
from .normal_eq import assemble_Tq_core


def unported(what: str, item: int) -> NotImplementedError:
    """The error for a feature of pyrhe_tpu the port does not run yet."""
    return NotImplementedError(
        f"{what} is not ported to pyrhe_tpu_torch yet (ROADMAP.md, Queue 1 "
        f"item {item}); the JAX package (run_rhe.py) runs it")


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
    checkpoint_dir: str | None = None   # checkpoint/resume: item 9
    checkpoint_every: int = 1
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


def check_ported(cfg: RunConfig) -> None:
    """Raise for the settings the port does not run yet."""
    resolve_mm_mode(cfg)
    if cfg.checkpoint_dir:
        raise unported("checkpoint/resume (--checkpoint_dir)", 9)


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

    def put(x):
        x = np.asarray(x, np.float64)
        out = np.zeros((n_pad,) + x.shape[1:])
        if keep_idx is None:
            out[:x.shape[0]] = x
        else:
            out[keep_idx] = x
        return torch.as_tensor(out[perm], dtype=dtype, device=device)

    cols = [Z] + ([Uzb] if cov is not None else []) + (
        [Y_resid] if Y_resid.shape[1] else [])
    Zd = put(Z)
    keep = np.zeros(n_pad, dtype=bool)
    if keep_idx is None:
        keep[:Z.shape[0]] = True
    else:
        keep[keep_idx] = True
    return StaticArrays(
        P=put(np.concatenate(cols, axis=1)), Z=Zd,
        Uzb=put(Uzb) if cov is not None else torch.zeros_like(Zd),
        C=put(cov) if cov is not None else None,
        Q=(torch.as_tensor(Q, dtype=dtype, device=device)
           if cov is not None else None),
        valid_mask=torch.as_tensor(keep[perm], dtype=dtype, device=device),
        q_last=torch.as_tensor((np.asarray(Y_resid) ** 2).sum(axis=0),
                               dtype=dtype, device=device),
        Y=put(Y_resid), perm=perm, n_pad=n_pad,
        env=put(env) if env is not None else None)


class Engine:
    def __init__(self, data: DataBundle, spec: ModelSpec, cfg: RunConfig,
                 log: Logger | None = None):
        check_ported(cfg)
        GenoImputeMethod(cfg.geno_impute_method)  # raises on unknown value
        self.data = data
        self.spec = spec
        self.cfg = cfg
        self.log = log or Logger(debug_mode=False)

        self.dev = pick_device(cfg.device)
        # f32 products in full f32 (matters for the plain versions and
        # any torch product on the card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = DTYPES[cfg.dtype]
        self.mm_mode = resolve_mm_mode(cfg)
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
        self.cache_limit = self._plan_cache()
        self._build_static_arrays()
        self._cache: dict[int, tuple] = {}
        self._host_cache = self._init_host_cache()
        self._tot = None
        self.M_mat = self._build_M_matrix()
        self.trace_sums = None
        # Cumulative per-phase seconds: host_read_s runs on the prefetch
        # thread overlapped with device work; h2d_s is device time of the
        # copies (CUDA events); pass1_s / pass2_s are wall time of each
        # pass, ending in a device synchronize; host_cache_hits counts the
        # blocks served from the host cache.
        self.phase_times: dict[str, float] = {}
        self._h2d_events: list = []

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
        per_block = (self.E_geno * self.b2 * self.n_pad
                     * torch.finfo(self.dtype).bits // 8)
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
        if self.num_nxe:
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
    def _fill_from_stats(self, sums, nmiss, n_total, m_block):
        """Per-SNP HWE imputation draws, reproducing the reference's RNG
        discipline exactly: reseed per block, one uniform draw per SNP
        whether or not it has missing entries (base.py:265-289,510)."""
        n_obs = n_total - nmiss
        p = np.divide(sums, n_obs, out=np.zeros_like(sums),
                      where=n_obs > 0) * 0.5
        rs = np.random.RandomState(self.cfg.seed)
        rval = rs.random_sample(m_block)
        d0 = (1 - p) ** 2
        d1 = 2 * p * (1 - p)
        return np.where(rval < d0, 0.0,
                        np.where(rval < d0 + d1, 1.0, 2.0))

    def _load_block(self, j: int):
        """Block j's host side, from the host cache when it holds the block
        (counted in phase_times["host_cache_hits"]), else read and kept
        there when the cache is on. Returns (words, annot, seconds)."""
        cache = self._host_cache
        if cache is not None and j in cache:
            self._phase_add("host_cache_hits", 1.0)
            return (*cache[j], 0.0)
        words, annot, dt = self._load_block_uncached(j)
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
        packed = bed.read_packed_block(s, e)
        if self.cfg.geno_impute_method == "binary":
            sums, nmiss = bed.packed_col_stats(packed)
            fill = self._fill_from_stats(sums, nmiss, self.data.num_indv, m)
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
        """Non-blocking copies from pinned memory, timed by CUDA events."""
        if self.dev.type == "cpu":
            return words, annot
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        words = words.to(self.dev, non_blocking=True)
        annot = annot.to(self.dev, non_blocking=True)
        ev[1].record()
        self._h2d_events.append(ev)
        return words, annot

    def _blocks(self, indices):
        """Yield (words, annot) on the device for each block index, with
        the host read + clean running one block ahead on a background
        thread (the role of the reference's worker pool, base.py)."""
        indices = list(indices)
        if not indices:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(self._load_block, indices[0])
            for pos in range(len(indices)):
                words, annot, dt = nxt.result()
                if pos + 1 < len(indices):
                    nxt = ex.submit(self._load_block, indices[pos + 1])
                self._phase_add("host_read_s", dt)
                yield self._to_device(words, annot)

    def _stat_kw(self) -> dict:
        return dict(n_indiv=self.data.num_indv, b2=self.b2,
                    components=self.spec.components)

    def _block_stats(self, words, annot):
        """Per-block stats in the kernels' (E_geno, b2, N) layout, in the
        working dtype."""
        st = self.static
        args = (words, annot, st.P, st.env, st.valid_mask)
        if self.mode == "exact":
            XXP, yXXy, _ = block_stats_core(*args, **self._stat_kw())
        else:
            XXP, yXXy, _ = block_stats_pallas_core(*args, mode=self.mode,
                                                   **self._stat_kw())
        return XXP.transpose(1, 2), yXXy

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _end_pass(self, name: str, t0: float):
        self._sync()
        self._phase_add(name, time.perf_counter() - t0)
        self._phase_add("h2d_s", sum(a.elapsed_time(b)
                                     for a, b in self._h2d_events) / 1e3)
        self._h2d_events = []

    def precompute(self):
        """Pass 1: accumulate the totals in block order; the stats of the
        first cache_limit blocks are kept for pass 2 (none when streaming).
        In a kernel mode the other blocks add into the totals in place
        through the aliased kernels (ops/moments.acc_scan_stats); mode
        "exact" adds their standard stats, whose dtype the f32 acc kernels
        do not take (reference engine._acc_fast_path). Bitwise the same
        totals either way."""
        t0 = time.perf_counter()
        st = self.static
        tot_X = torch.zeros((self.E_geno, self.b2, self.n_pad),
                            dtype=self.dtype, device=self.dev)
        tot_y = torch.zeros((self.E_geno, self.T_traits), dtype=self.dtype,
                            device=self.dev)
        blocks = self._blocks(range(self.J))
        for j in range(self.cache_limit):
            XXP, yXXy = self._block_stats(*next(blocks))
            tot_X.add_(XXP)
            tot_y = tot_y + yXXy
            self._cache[j] = (XXP, yXXy)
        if self.mode == "exact":
            for words, annot in blocks:
                XXP, yXXy = self._block_stats(words, annot)
                tot_X.add_(XXP)
                tot_y = tot_y + yXXy
        else:
            tot_X, tot_y = acc_scan_stats(
                blocks, st.P, st.env, st.valid_mask, tot_X, tot_y, K=self.K,
                mode=self.mode, **self._stat_kw())
        self._tot = (tot_X, tot_y)
        self._end_pass("pass1_s", t0)

    # --------------------------------------------------------------- assembly
    def _loo_blocks(self):
        """Per-block stats for pass 2, in block order (reference
        engine.py:1104-1129): cached blocks are popped (so device memory
        falls as samples are assembled), each run of uncached ones is
        recomputed through one prefetching _blocks walk."""
        j = 0
        while j < self.J:
            if j in self._cache:
                yield self._cache.pop(j)
                j += 1
                continue
            stop = min((k for k in self._cache if k > j), default=self.J)
            for words, annot in self._blocks(range(j, stop)):
                yield self._block_stats(words, annot)
            j = stop

    def _assemble_one(self, X, y, j):
        """(T, q) of sample j from its (E_geno, b2, N) stats, with the NxE
        rows appended (reference engine._loo_stats)."""
        st = self.static
        if self.num_nxe:
            X = torch.cat([X, self.nxe[0]])
            y = torch.cat([y, self.nxe[1]])
        return assemble_Tq_core(
            X.transpose(1, 2), y, torch.as_tensor(self.M_mat[j],
                                                  device=self.dev),
            st.Z, st.Uzb, st.C, st.Q, st.q_last, self.stoch_mask,
            num_random_vec=self.B, n_indiv=self.data.num_indv,
            n_cov=self.data.cov.shape[1] if self.use_cov else 0)

    def assemble(self):
        """Pass 2: T_all (J+1, E+1, E+1) and q_all (J+1, E+1, T) float64,
        one leave-one-out sample at a time on the device; sample J is the
        full data."""
        t0 = time.perf_counter()
        tot_X, tot_y = self._tot
        Ts, qs = [], []
        for j, (bX, by) in enumerate(self._loo_blocks()):
            T, q = self._assemble_one(tot_X - bX, tot_y - by, j)
            Ts.append(T)
            qs.append(q)
        T, q = self._assemble_one(tot_X, tot_y, self.J)
        Ts.append(T)
        qs.append(q)
        self.T_all = torch.stack(Ts).cpu().numpy().astype(np.float64)
        self.q_all = torch.stack(qs).cpu().numpy().astype(np.float64)
        self._end_pass("pass2_s", t0)
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
        self.precompute()
        self.assemble()

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
