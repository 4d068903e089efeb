"""The RHE estimation engine on PyTorch: one device, blocks one at a time.

Port of pyrhe_tpu/core/engine.py for RHE, RHE-DOM and GENIE in float32.
Orchestrates the method-of-moments pipeline over jackknife blocks:

  pass 1   for each SNP block j: host .bed read + imputation fills +
           missing-code clean (one block ahead, on a background thread)
           -> pinned host buffer -> non-blocking copy to the device ->
           decode + standardize + fused products (ops/moments) ->
           accumulate totals; cache per-block stats unless streaming.
  pass 2   per-sample leave-one-out stats (total - block, GENIE's
           analytic NxE rows appended) -> assemble (T, q) on the device,
           one jackknife sample at a time; the SUMRHE trace sums from the
           assembled T when asked for (get_trace).
  solve    QR per sample + jackknife SEs + h2/enrichment (core/solver.py,
           host float64).

Streaming mode (cfg.streaming) recomputes block stats in pass 2 instead of
caching them (O(E*N*B) device memory independent of J), and its pass 1
adds each block straight into the totals through the aliased stage-2
kernels (ops/kernels.ytg_acc_matmul, ytg_acc2_matmul for dominance). Both
modes give bitwise-equal (T, q).

Every trait's residualized phenotype is an extra probe column, so all
traits share one precompute and only q differs per trait.

The device is CUDA unless the caller asks for the CPU: there the fused
products run as their plain PyTorch versions in f32 (no split), as the
reference runs its Pallas kernels in interpret mode. On the card the
probe-side operands are split into bf16 hi/lo halves (mm_mode split2).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..io.bed import clean_packed
from ..ops.kernels import ROW_TILE, TN, pad_to, plane_permutation
from ..ops.moments import acc_scan_stats, block_stats_pallas_core, nxe_stats
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
    (use_pallas, stage_streams): the port always runs its kernels and
    stages one block at a time."""
    num_random_vec: int = 10
    num_jack: int = 100
    seed: int = 0
    geno_impute_method: str = "binary"
    dtype: str = "float32"          # float32 (float64 | bfloat16: item 15)
    streaming: bool = False
    get_trace: bool = False         # SUMRHE trace sums (engine.trace_sums)
    trace_dir: str | None = None
    device: str = "auto"            # auto (= cuda) | cuda[:i] | cpu
    mm_mode: str = "auto"           # auto | split2 (exact | bf16: item 15)
    checkpoint_dir: str | None = None   # checkpoint/resume: item 9
    checkpoint_every: int = 1
    cache_blocks: int = -1          # -1 only (hybrid cache: item 8)
    host_cache_gb: float = -1.0     # -1 / 0 only (host cache: item 8)


def check_ported(cfg: RunConfig) -> None:
    """Raise for the settings the port does not run yet."""
    if cfg.dtype != "float32":
        raise unported(f"dtype {cfg.dtype!r}", 15)
    if cfg.mm_mode not in ("auto", "split2"):
        raise unported(f"mm_mode {cfg.mm_mode!r}", 15)
    if cfg.checkpoint_dir:
        raise unported("checkpoint/resume (--checkpoint_dir)", 9)
    if cfg.cache_blocks >= 0:
        raise unported("the hybrid stats cache (--cache_blocks)", 8)
    if cfg.host_cache_gb > 0:
        raise unported("the host packed-block cache (--host_cache_gb)", 8)


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
        # the card splits the probe side into bf16 hi/lo halves (split2);
        # the CPU runs the plain f32 products unsplit
        self.split = self.dev.type == "cuda"

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

        # The stats cache holds J blocks of (E_geno, b2, n_pad) f32 on the
        # device; when that exceeds half of the free device memory, run
        # streaming (the hybrid split of the reference is item 8).
        cache_bytes = cfg.num_jack * self.E_geno * self.n_pad * 4 * self.b2
        if not cfg.streaming and self.dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.dev)
            if cache_bytes > 0.5 * free:
                self.log._log(
                    f"Note: per-block stats cache (~{cache_bytes / 1e9:.1f}"
                    " GB) exceeds the device memory budget; using"
                    " streaming (two-pass) mode")
                self.cfg = dataclasses.replace(cfg, streaming=True)
        self._build_static_arrays()
        self._cache: dict[int, tuple] = {}
        self._tot = None
        self.M_mat = self._build_M_matrix()
        self.trace_sums = None
        # Cumulative per-phase seconds: host_read_s runs on the prefetch
        # thread overlapped with device work; h2d_s is device time of the
        # copies (CUDA events); pass1_s / pass2_s are wall time of each
        # pass, ending in a device synchronize.
        self.phase_times: dict[str, float] = {}
        self._h2d_events: list = []

    def _phase_add(self, name: str, dt: float):
        self.phase_times[name] = self.phase_times.get(name, 0.0) + dt

    # ------------------------------------------------------------------ setup
    def _build_static_arrays(self):
        d = self.data
        self.Y_resid = d.resid_pheno() if d.pheno is not None else np.zeros(
            (d.num_indv, 0))
        st = self.static = static_arrays_from_numpy(
            d.Z, d.Uzb, d.cov, d.Q, self.Y_resid, d.bed.keep_idx,
            d.bed.num_indiv, self.dev, env=d.env if d.num_env else None)
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
        """Host side of block j (runs on the prefetch thread): packed .bed
        rows, imputation fills, and the missing codes rewritten with the
        (integral) fills into a zero-padded (m_pad, n_pad/4) byte buffer —
        pinned when the engine runs on the card — viewed as int32 words.
        Returns (words, annot (m_pad, K) f32, seconds spent)."""
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
        annot = torch.zeros((m_pad, self.K), dtype=torch.float32,
                            pin_memory=pin)
        annot[:m] = torch.from_numpy(self.data.annot[s:e].astype(np.float32))
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
        return dict(n_indiv=self.data.num_indv, b2=self.b2, split=self.split,
                    components=self.spec.components)

    def _block_stats(self, words, annot):
        """Per-block stats in the kernels' (E_geno, b2, N) layout."""
        st = self.static
        XXP, yXXy, _ = block_stats_pallas_core(
            words, annot, st.P, st.env, st.valid_mask, **self._stat_kw())
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
        """Pass 1: accumulate totals (and cache block stats unless
        streaming). Streaming adds each block into the totals in place
        through the aliased kernel (ops/moments.acc_scan_stats)."""
        t0 = time.perf_counter()
        st = self.static
        tot_X = torch.zeros((self.E_geno, self.b2, self.n_pad),
                            dtype=torch.float32, device=self.dev)
        tot_y = torch.zeros((self.E_geno, self.T_traits),
                            dtype=torch.float32, device=self.dev)
        if self.cfg.streaming:
            tot_X, tot_y = acc_scan_stats(
                self._blocks(range(self.J)), st.P, st.env, st.valid_mask,
                tot_X, tot_y, K=self.K, **self._stat_kw())
        else:
            for j, (words, annot) in enumerate(self._blocks(range(self.J))):
                XXP, yXXy = self._block_stats(words, annot)
                tot_X = tot_X + XXP
                tot_y = tot_y + yXXy
                self._cache[j] = (XXP, yXXy)
        self._tot = (tot_X, tot_y)
        self._end_pass("pass1_s", t0)

    # --------------------------------------------------------------- assembly
    def _loo_blocks(self):
        """Per-block stats for pass 2: popped from the cache (so device
        memory falls as samples are assembled) or recomputed (streaming)."""
        if self.cfg.streaming:
            for words, annot in self._blocks(range(self.J)):
                yield self._block_stats(words, annot)
        else:
            for j in range(self.J):
                yield self._cache.pop(j)

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
