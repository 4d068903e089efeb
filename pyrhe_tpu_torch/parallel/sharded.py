"""The two passes sharded over the jackknife blocks of a torch.distributed
world: one process per GPU.

Port of pyrhe_tpu/parallel/sharded.py in torch idiom; every rank runs the
engine's own block passes (Engine._pass1 / _pass2), so the same kernels
and the same checkpointing serve both paths:

  plan        rank r owns the contiguous blocks [r*J_loc, min(J, (r+1)*
              J_loc)), J_loc = ceil(J / D). A rank with no block
              contributes zero totals. There is no zero-block padding:
              uniform shapes across devices are a need of SPMD programs,
              not of one process per GPU.
  pass 1      each rank reads only its own blocks (Engine._blocks: one
              block of read-ahead, the host block cache when streaming);
              its first blocks keep their stats up to a per-rank budget
              (--cache_blocks counts per rank), the rest go into the
              partial totals through the aliased acc kernels.
  merge       all_gather of the partial totals, summed in rank order on
              every rank; not all_reduce, whose summation order NCCL picks.
              Every rank then holds bitwise the same totals, gloo and NCCL
              agree, and at world size 1 the run is bitwise the sequential
              engine's.
  pass 2      each rank assembles the (T, q) of its own samples; they are
              all_gathered, padded to J_loc. Sample J (the full data) is
              assembled on every rank, so T_all / q_all are the same
              float64 host arrays on every rank.
  checkpoint  each rank in <checkpoint_dir>/shard_<r>_of_<D>/, fingerprinted
              with [D, J_loc] and [rank, D]: the merge order depends on D,
              so a run of another world size starts fresh.

Without a process group the world is one rank and no collective runs.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.checkpoint import Checkpoint, CheckpointBusy
from ..core.engine import stored_results
from ..utils.trace import span
from . import distributed


class ShardedRunner:
    """Drives an Engine's two passes over the blocks of this rank. Every
    rank constructs the same Engine (same files, same config) and calls
    run()."""

    def __init__(self, engine):
        self.eng = engine
        self.rank, self.D = distributed.world()
        self.grouped = dist.is_available() and dist.is_initialized()
        if self.grouped:
            want = distributed.backend_for(engine.dev.type)
            if dist.get_backend() != want:
                raise RuntimeError(
                    f"the engine runs on {engine.dev.type}, which needs the "
                    f"{want} backend; the process group runs "
                    f"{dist.get_backend()}")
        J = engine.J
        self.J_loc = -(-J // self.D)
        self.lo = min(J, self.rank * self.J_loc)
        self.hi = min(J, self.lo + self.J_loc)

    def _cache_keep(self) -> int:
        """How many of this rank's leading blocks pass 1 caches (the
        sharded twin of Engine._plan_cache, reference
        sharded.py:664-695): none when streaming, cfg.cache_blocks per
        rank when set, else as many as fit the device budget beside a
        reserve of 4 blocks."""
        eng = self.eng
        n = self.hi - self.lo
        if eng.cfg.streaming:
            return 0
        if eng.cfg.cache_blocks >= 0:
            keep = min(eng.cfg.cache_blocks, n)
        else:
            per_block = eng.stats_block_bytes()
            budget = eng._cache_budget()
            if n * per_block <= budget:
                return n
            keep = max(0, min(n, int(budget // per_block) - 4))
        if keep < n:
            eng.log._log(
                f"Note: sharded stats cache capped at {keep}/{n} blocks of "
                f"rank {self.rank}; the rest is recomputed in pass 2 "
                "(hybrid)")
        return keep

    def _make_ckpt(self):
        """This rank's Checkpoint in <dir>/shard_<rank>_of_<D>/ (reference
        sharded.py:236-256), or None without a checkpoint_dir or when
        another live run holds it."""
        eng = self.eng
        root = eng.cfg.checkpoint_dir
        if not root:
            return None
        sub = os.path.join(root, f"shard_{self.rank}_of_{self.D}")
        if not os.path.isdir(sub) and os.path.isdir(root):
            other = sorted({int(m.group(1)) for m in (
                re.fullmatch(r"shard_\d+_of_(\d+)", n)
                for n in os.listdir(root)) if m})
            if other:
                eng.log._log(
                    f"Note: checkpoint in {root} was written under world "
                    f"size {other}, not {self.D}; the totals' merge order "
                    "depends on it, so this run starts fresh")
        fp = dict(eng._fingerprint())
        fp.update({"sharded_plan": [self.D, self.J_loc],
                   "process": [self.rank, self.D]})
        try:
            return Checkpoint(sub, fp, eng.log)
        except CheckpointBusy as e:
            eng.log._log(f"WARNING: {e}; sharded run will NOT checkpoint")
            return None

    # ---------------------------------------------------------- collectives
    def _all_gather(self, t: torch.Tensor) -> list:
        """Every rank's t, in rank order."""
        if not self.grouped:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.D)]
        dist.all_gather(parts, t.contiguous())
        return parts

    def _merge(self, tot):
        """The partial totals of every rank summed in rank order."""
        out = []
        for t in tot:
            parts = self._all_gather(t)
            s = parts[0]
            for p in parts[1:]:
                s = s + p
            out.append(s)
        return out

    def _all_agree(self, flag: bool) -> bool:
        """flag on every rank (a rank whose stored results are missing or
        corrupt makes every rank run the passes, so no rank waits in a
        collective alone)."""
        if not self.grouped:
            return flag
        t = torch.tensor([int(flag)], device=self.eng.dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def _gather(self, parts: list, full: torch.Tensor) -> np.ndarray:
        """(J+1, ...) float64 host array: every rank's samples (padded to
        J_loc for the all_gather), then the full-data sample."""
        loc = torch.zeros((self.J_loc,) + tuple(full.shape),
                          dtype=full.dtype, device=full.device)
        if parts:
            loc[:len(parts)] = torch.stack(parts)
        J = self.eng.J
        rows = [p[:min(J, (r + 1) * self.J_loc) - min(J, r * self.J_loc)]
                for r, p in enumerate(self._all_gather(loc))]
        return torch.cat(rows + [full[None]]).cpu().numpy().astype(
            np.float64)

    # ------------------------------------------------------------------ run
    def run(self):
        """Both passes; returns (T_all (J+1, E+1, E+1), q_all (J+1, E+1,
        T)) float64 host arrays, the same on every rank."""
        eng = self.eng
        ck = self._make_ckpt()
        res = stored_results(ck)
        if self._all_agree(res is not None):
            eng.log._log("Resumed completed (T, q) from sharded checkpoint "
                         f"({ck.dir}); skipping both passes")
            return res
        keep = self._cache_keep()
        t0 = time.perf_counter()
        with span("precompute"):
            tot = eng._pass1(ck, self.lo, self.hi, self.lo + keep)
            tot_X, tot_y = eng._tot = self._merge(tot)
            eng._end_pass("pass1_s", t0)
        t0 = time.perf_counter()
        with span("assemble"):
            Ts, qs = eng._pass2(ck, tot_X, tot_y, self.lo, self.hi)
            T_full, q_full = eng._assemble_one(tot_X, tot_y, eng.J)
            with span("results"):
                T_all = self._gather(Ts, T_full)
                q_all = self._gather(qs, q_full)
            eng._end_pass("pass2_s", t0)
        if ck is not None:
            ck.save_results(T_all, q_all)
            ck.commit("done", self.hi)
        return T_all, q_all
