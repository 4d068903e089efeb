"""Crash-safe checkpoint/resume for the estimation pipeline.

The port's own copy of pyrhe_tpu/core/checkpoint.py (numpy + stdlib; the
engine passes torch tensors, which are copied to the host when they are
written). The reference implementation has no mid-run recovery: a worker
failure kills the whole job. At biobank scale a pass over the .bed is hours
of wall clock, so the engine takes periodic, atomic snapshots of its state
that a fresh process resumes from bit-exactly.

Layout of a checkpoint directory (all writes are tmp-file + fsync +
os.replace, and `meta.json` — the commit record — is always written LAST,
so a crash mid-save leaves the previous consistent state):

  meta.json            magic, config/data fingerprint, phase, next_j
  totals.npz           running (tot_X, tot_y) accumulators, in the
                       kernels' plane-permuted (E_geno, b2, n_pad) layout
  block_<j>.npz        per-block stats cache entries  (cached and hybrid)
  assemble.npz         partial (T, q) samples          (pass 2, every mode)
  results.npz          final float64 (T_all, q_all)    (phase "done")

Phases advance precompute -> assemble -> done; `next_j` is the first
jackknife block NOT yet covered by the stored state for the current
phase. Resume validates a fingerprint of everything that shapes the
numerics (dataset shapes + .bed identity, J/B/K, dtype, mm_mode, device
type, seed, model, streaming); a mismatch starts fresh after clearing OUR
files (only files matching the names above are ever touched).

The magic differs from the JAX package's: its stats are (E, N, b2) in
natural individual order, so one of its directories reads as a mismatch
and starts fresh. Its chunk files (`stage_chunk`, `load_chunks_prefix`)
belong to its chunked Pallas pass; the port runs one block at a time and
has no chunk files.
"""
from __future__ import annotations

import json
import os
import re
import zipfile

import numpy as np

_MAGIC = "pyrhe_tpu_torch-checkpoint-v1"
# everything this module writes, including its own in-flight .tmp names,
# so reset() after a crash mid-write does not orphan temp files forever
_OURS = re.compile(
    r"^(meta\.json|totals\.npz|assemble\.npz|results\.npz|"
    r"block_\d+\.npz)(\.tmp)?$")

# Structural corruption only: a partially-copied / truncated /
# power-lossed data file (bad zip, short read, missing key/file) means the
# stored state is unusable and resume must fall back to a fresh start.
# Transient I/O errors (stale NFS handle, EINTR, EMFILE) are deliberately
# NOT here — resetting on those would destroy hours of state that a plain
# retry would have preserved; they propagate so the operator can retry.
_LOAD_ERRORS = (zipfile.BadZipFile, KeyError, ValueError, EOFError,
                FileNotFoundError)


class CheckpointBusy(RuntimeError):
    """Another live process holds this checkpoint directory's lock."""


def _host(x) -> np.ndarray:
    """A host numpy array of x: a torch tensor (on any device) is copied to
    the host, which waits for the work that produces it."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _atomic_save_npz(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())   # os.replace alone is not durable
    os.replace(tmp, path)


class Checkpoint:
    def __init__(self, directory: str, fingerprint: dict, log=None,
                 lock_name: str = ".lock"):
        self.dir = directory
        self.fingerprint = fingerprint
        self.log = log
        self._lock_name = lock_name   # per-rank under torch.distributed:
        # every rank of ONE job legitimately opens the shared dir, but a
        # second JOB (same rank) must still be excluded
        os.makedirs(directory, exist_ok=True)
        self._lock_fd = self._acquire_lock()
        self._pending: list = []   # staged block saves (see stage_block)
        self._meta = self._read_meta()

    # fds of directory locks this PROCESS already holds, keyed by realpath:
    # flock treats a second open in the same process as a conflicting
    # holder, but sequential resume within one process (run -> resume, or
    # the test suite) is legitimate — only OTHER live processes must be
    # excluded. Held for process lifetime; released by the OS on exit.
    _PROC_LOCKS: dict = {}

    def _acquire_lock(self):
        """Exclusive advisory lock on the directory: two simultaneous runs
        sharing one --checkpoint_dir would interleave saves/commits (and a
        config mismatch in the second would reset() the first's state from
        under it). flock is released automatically if the holder dies."""
        path = os.path.join(self.dir, self._lock_name)
        key = os.path.realpath(path)
        if key in Checkpoint._PROC_LOCKS:
            return Checkpoint._PROC_LOCKS[key]
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass   # non-POSIX: no advisory locking available
        except OSError as e:
            import errno
            if e.errno in (errno.EWOULDBLOCK, errno.EAGAIN, errno.EACCES):
                os.close(fd)
                raise CheckpointBusy(
                    f"checkpoint directory {self.dir} is locked by another "
                    "live run; refusing to share it")
            # flock unsupported on this filesystem (ENOTSUP/ENOLCK on some
            # NFS/overlay mounts): proceed unlocked rather than misreport
            # the run as busy and silently lose checkpointing entirely
            if self.log is not None:
                self.log._log(
                    f"Note: advisory locking unavailable on {self.dir} "
                    f"({e}); proceeding without a checkpoint lock")
        Checkpoint._PROC_LOCKS[key] = fd
        return fd

    # ---------------------------------------------------------------- meta
    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _read_meta(self):
        """Load and validate meta.json; on any mismatch, clear our files
        and start fresh (returns None)."""
        path = self._path("meta.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            meta = {}
        if (meta.get("magic") != _MAGIC
                or meta.get("fingerprint") != self.fingerprint):
            if self.log is not None:
                self.log._log(
                    f"Note: checkpoint in {self.dir} does not match this "
                    "run's configuration/dataset; starting fresh")
            self.reset()
            return None
        return meta

    def reset(self) -> None:
        """Remove every file this module could have written (and nothing
        else — the directory may be shared). Tolerates a file another rank
        of the same job removed first."""
        for name in os.listdir(self.dir):
            if _OURS.match(name):
                try:
                    os.remove(self._path(name))
                except FileNotFoundError:
                    pass
        self._meta = None

    def state(self):
        """(phase, next_j) of the stored state, or None if starting fresh."""
        if self._meta is None:
            return None
        return self._meta["phase"], int(self._meta["next_j"])

    def commit(self, phase: str, next_j: int) -> None:
        """Atomically record that all data files for `phase` up to block
        `next_j` are on disk. Flushes staged block saves first so a
        committed meta never points at data files that were not written."""
        self.flush_pending()
        meta = {"magic": _MAGIC, "fingerprint": self.fingerprint,
                "phase": phase, "next_j": int(next_j)}
        tmp = self._path("meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path("meta.json"))
        self._meta = meta

    def _load_or_reset(self, loader):
        """Run a load; on any corruption (missing/truncated data file from
        a partial directory copy or power loss) log, clear our state, and
        return the start-fresh sentinel instead of crashing."""
        try:
            return loader()
        except _LOAD_ERRORS as e:
            if self.log is not None:
                self.log._log(
                    f"Note: checkpoint in {self.dir} is missing or corrupt "
                    f"({type(e).__name__}: {e}); starting fresh")
            self.reset()
            return None

    # ------------------------------------------------------------- payloads
    # Data files are SELF-DESCRIBING (they carry their own next_j) because
    # a crash between a data save and the meta commit leaves the file one
    # interval AHEAD of meta; resume trusts the file's next_j (its content
    # matches it by construction — block files are saved before the
    # totals that cover them), while meta gates fingerprint and phase.
    def save_totals(self, tot_X, tot_y, next_j: int) -> None:
        # data files before the totals that cover them (resume invariant)
        self.flush_pending()
        _atomic_save_npz(self._path("totals.npz"), tot_X=_host(tot_X),
                         tot_y=_host(tot_y), next_j=np.int64(next_j))

    def load_totals(self):
        """(tot_X, tot_y, next_j), or None if no totals were saved."""
        path = self._path("totals.npz")
        if not os.path.exists(path):
            return None

        def _load():
            with np.load(path) as z:
                return z["tot_X"], z["tot_y"], int(z["next_j"])
        return self._load_or_reset(_load)

    # Per-block stats are STAGED, not written immediately: the cadence
    # flag (--checkpoint_every) must throttle the dominant checkpoint I/O
    # (the stats slabs), not just the small totals/meta writes. Staged
    # entries keep the tensors referenced (they live in the engine's stats
    # cache anyway) and are flushed by save_totals/commit.
    def stage_block(self, j: int, XXP, yXXy) -> None:
        self._pending.append((j, XXP, yXXy))

    def flush_pending(self) -> None:
        for j, XXP, yXXy in self._pending:
            _atomic_save_npz(self._path(f"block_{j:06d}.npz"),
                             XXP=_host(XXP), yXXy=_host(yXXy))
        self._pending.clear()

    def load_blocks_partial(self, upto: int, start: int = 0):
        """{j: (XXP, yXXy)} for whichever block files in [start, upto)
        exist and load. A missing or corrupt file is simply skipped instead
        of resetting state: under a cache_limit only the budgeted blocks
        were ever staged, and pass 2 recomputes any hole; blocks below
        start (pass 2 already assembled them) are not read at all."""
        out = {}
        for j in range(start, upto):
            path = self._path(f"block_{j:06d}.npz")
            if not os.path.exists(path):
                continue
            try:
                with np.load(path) as z:
                    out[j] = (z["XXP"], z["yXXy"])
            except _LOAD_ERRORS:
                continue
        return out

    def save_assemble(self, T_part, q_part, next_j: int) -> None:
        _atomic_save_npz(self._path("assemble.npz"), T=_host(T_part),
                         q=_host(q_part), next_j=np.int64(next_j))

    def load_assemble(self):
        """(T_part, q_part, next_j), or None if nothing was saved."""
        path = self._path("assemble.npz")
        if not os.path.exists(path):
            return None

        def _load():
            with np.load(path) as z:
                return z["T"], z["q"], int(z["next_j"])
        return self._load_or_reset(_load)

    def save_results(self, T_all, q_all) -> None:
        _atomic_save_npz(self._path("results.npz"),
                         T_all=np.asarray(T_all, np.float64),
                         q_all=np.asarray(q_all, np.float64))

    def load_results(self):
        """(T_all, q_all), or None (state cleared) if missing/corrupt."""
        def _load():
            with np.load(self._path("results.npz")) as z:
                return z["T_all"], z["q_all"]
        return self._load_or_reset(_load)
