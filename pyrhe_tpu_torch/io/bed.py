"""PLINK .bed access: mmap + native C++ 2-bit decoder (NumPy fallback).

Host layer of the PyTorch port, carried over from pyrhe_tpu/io/bed.py
(importing that module would import jax through the package root). The
C++ decoder is NOT duplicated: `_load_native` compiles the reference
package's `pyrhe_tpu/io/_native/bed_decode.cpp` by file path into the
port's git-ignored build directory, so the host decoder keeps one source.

Replaces the reference's `bed_reader` dependency (reference base.py:10,100)
and its post-read 0<->2 allele flip (base.py:347-355): our decoder emits the
flipped (A2-count) dosage convention directly. 255 marks a missing genotype.

Two access paths:
  - read_block(): decoded uint8 dosages on host (C++ lib, threaded)
  - read_packed_block(): raw 2-bit packed bytes, for on-device decode
    (16x less host->device traffic; see pyrhe_tpu_torch.ops.kernels).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

_MAGIC = bytes([0x6C, 0x1B, 0x01])
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(os.path.dirname(_PKG_DIR), "pyrhe_tpu", "io",
                         "_native", "bed_decode.cpp")
_NATIVE_DIR = os.path.join(_PKG_DIR, "_build", "native")
_LUT = np.array([0, 255, 1, 2], dtype=np.uint8)  # 2-bit code -> dosage

_lib = None
_lib_tried = False


def _load_native():
    """Compile (once) and load the C++ decoder; return None on any failure.

    The library is built into a temporary file and renamed into place, so
    concurrent processes (parallel test workers) never load a half-written
    library."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    so_path = os.path.join(_NATIVE_DIR, "libbeddecode.so")
    src_path = _SRC_PATH
    try:
        if (not os.path.exists(so_path)) or (
            os.path.getmtime(so_path) < os.path.getmtime(src_path)
        ):
            os.makedirs(_NATIVE_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", "-o", tmp, src_path],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(so_path)
        lib.bed_decode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.bed_col_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bed_encode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.bed_packed_col_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.bed_clean_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.bed_synth_block.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint16,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain issues
        print(f"[pyrhe_tpu_torch] native bed decoder unavailable ({e}); "
              f"using NumPy fallback", file=sys.stderr)
        _lib = None
    return _lib


def decode_packed(packed: np.ndarray, n_indiv: int) -> np.ndarray:
    """NumPy fallback: (m, bytes_per_snp) packed uint8 -> (m, n_indiv) dosage."""
    m = packed.shape[0]
    codes = (packed[:, :, None] >> np.array([0, 2, 4, 6], dtype=np.uint8)) & 3
    return _LUT[codes.reshape(m, -1)[:, :n_indiv]]


def synth_packed_block(seed: int, snp0: int, m: int, n_indiv: int,
                       mafs: np.ndarray, miss_rate: float = 0.0,
                       w: np.ndarray | None = None,
                       y: np.ndarray | None = None,
                       n_threads: int = 0) -> np.ndarray | None:
    """Native HWE genotype synthesis straight into packed .bed bytes.

    mafs: (m,) per-SNP minor-allele frequencies for SNPs snp0..snp0+m.
    When w is given, y (float64 (n_indiv,)) accumulates sum_j w[j] *
    dosage_ij from the true pre-missing genotypes. Deterministic in
    (seed, snp0) — any block range reproduces the same data. Returns the
    (m, bytes_per_snp) packed array, or None if the native lib is missing
    (callers fall back to the NumPy generator)."""
    lib = _load_native()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    p = np.asarray(mafs, np.float64)
    t2 = np.round(p * p * 65536).clip(0, 65535).astype(np.uint16)
    t12 = np.round((p * p + 2 * p * (1 - p)) * 65536).clip(0, 65535) \
        .astype(np.uint16)
    out = np.empty((m, (n_indiv + 3) // 4), dtype=np.uint8)
    w_arr = None if w is None else np.ascontiguousarray(w, np.float32)
    lib.bed_synth_block(
        ctypes.c_uint64(seed), snp0, m, n_indiv,
        t2.ctypes.data, t12.ctypes.data,
        ctypes.c_uint16(int(round(miss_rate * 65536))),
        None if w_arr is None else w_arr.ctypes.data, out.ctypes.data,
        None if y is None else y.ctypes.data, n_threads)
    return out


def encode_dosage(dosage: np.ndarray) -> np.ndarray:
    """(m, n) uint8 dosage (255 = missing) -> (m, bytes_per_snp) packed bed bytes."""
    dosage = np.ascontiguousarray(dosage, dtype=np.uint8)
    m, n = dosage.shape
    bps = (n + 3) // 4
    lib = _load_native()
    out = np.empty((m, bps), dtype=np.uint8)
    if lib is not None:
        lib.bed_encode_block(
            dosage.ctypes.data, m, n, out.ctypes.data)
        return out
    # NumPy fallback
    code = np.where(dosage == 255, 1, np.array([0, 2, 3], dtype=np.uint8)[
        np.minimum(dosage, 2)]).astype(np.uint8)
    padded = np.zeros((m, bps * 4), dtype=np.uint8)
    padded[:, :n] = code
    padded = padded.reshape(m, bps, 4)
    out = (padded[:, :, 0] | (padded[:, :, 1] << 2) |
           (padded[:, :, 2] << 4) | (padded[:, :, 3] << 6))
    return out.astype(np.uint8)


class BedFile:
    """mmap'd SNP-major PLINK .bed with block decode.

    Parameters
    ----------
    path: path to the .bed file
    num_indiv: individuals in the companion .fam
    num_snp: SNPs in the companion .bim
    keep_idx: optional sorted original-row indices of individuals to KEEP
        (i.e. after removing phenotype/covariate-missing individuals, like
        np.delete(..., missing_indv) in reference base.py:343-344).
    """

    def __init__(self, path: str, num_indiv: int, num_snp: int,
                 keep_idx: np.ndarray | None = None,
                 num_threads: int | None = None):
        self.path = path
        self.num_indiv = num_indiv
        self.num_snp = num_snp
        self.bytes_per_snp = (num_indiv + 3) // 4
        with open(path, "rb") as f:
            magic = f.read(3)
        if magic != _MAGIC:
            raise ValueError(
                f"{path}: bad .bed magic {magic!r} (expected SNP-major v1.00)")
        expected = 3 + self.bytes_per_snp * num_snp
        actual = os.path.getsize(path)
        if actual < expected:
            raise ValueError(
                f"{path}: file too small ({actual} < {expected} bytes) for "
                f"N={num_indiv}, M={num_snp}")
        self._mm = np.memmap(path, dtype=np.uint8, mode="r", offset=3,
                             shape=(num_snp, self.bytes_per_snp))
        if keep_idx is not None:
            keep_idx = np.ascontiguousarray(keep_idx, dtype=np.int64)
            # dropped individuals' byte/bit addresses, precomputed for the
            # packed_col_stats keep correction (real cohorts drop a small
            # number of pheno/cov-missing individuals, so subtracting their
            # per-SNP contributions beats a masked full re-count)
            drop = np.setdiff1d(np.arange(num_indiv, dtype=np.int64),
                                keep_idx)
            self._drop_byte = (drop // 4).astype(np.int64)
            self._drop_shift = (2 * (drop % 4)).astype(np.uint8)
        self.keep_idx = keep_idx
        self.n_keep = num_indiv if keep_idx is None else len(keep_idx)
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)

    def read_packed_block(self, start: int, end: int) -> np.ndarray:
        """Raw packed bytes for SNPs [start, end): (m, bytes_per_snp) uint8."""
        return np.asarray(self._mm[start:end])

    def read_block(self, start: int, end: int) -> np.ndarray:
        """Decoded dosages for SNPs [start, end): (m, n_keep) uint8, 255=missing."""
        packed = np.ascontiguousarray(self._mm[start:end])
        m = end - start
        lib = _load_native()
        if lib is not None:
            out = np.empty((m, self.n_keep), dtype=np.uint8)
            keep_ptr = (self.keep_idx.ctypes.data
                        if self.keep_idx is not None else None)
            lib.bed_decode_block(packed.ctypes.data, m, self.num_indiv,
                                 keep_ptr, self.n_keep, out.ctypes.data,
                                 self.num_threads)
            return out
        out = decode_packed(packed, self.num_indiv)
        if self.keep_idx is not None:
            out = out[:, self.keep_idx]
        return np.ascontiguousarray(out)

    def packed_col_stats(self, packed: np.ndarray):
        """Per-SNP (observed dosage sum, missing count) straight from packed
        bytes (byte-LUT in C++; no decode), over the KEPT individuals when
        keep_idx is set: the full-population counts are corrected by
        subtracting each dropped individual's 2-bit code — exact integer
        arithmetic, bit-identical to col_stats over the filtered decode."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        m = packed.shape[0]
        lib = _load_native()
        if lib is not None and packed.shape[1] == self.bytes_per_snp:
            sums = np.empty(m, dtype=np.float64)
            nmiss = np.empty(m, dtype=np.int64)
            lib.bed_packed_col_stats(packed.ctypes.data, m, self.num_indiv,
                                     sums.ctypes.data, nmiss.ctypes.data,
                                     self.num_threads)
            if self.keep_idx is not None and len(self._drop_byte):
                codes = (packed[:, self._drop_byte]
                         >> self._drop_shift[None, :]) & 3   # (m, n_drop)
                miss = codes == 1
                dose = _LUT[codes].astype(np.int64)
                sums -= np.where(miss, 0, dose).sum(axis=1)
                nmiss -= miss.sum(axis=1)
            return sums, nmiss
        decoded = decode_packed(packed, self.num_indiv)
        if self.keep_idx is not None:
            decoded = decoded[:, self.keep_idx]
        return self.col_stats(decoded)

    def col_stats(self, dosage: np.ndarray):
        """Per-SNP (observed dosage sum, missing count) for a decoded block."""
        dosage = np.ascontiguousarray(dosage, dtype=np.uint8)
        m, n = dosage.shape
        lib = _load_native()
        if lib is not None:
            sums = np.empty(m, dtype=np.float64)
            nmiss = np.empty(m, dtype=np.int64)
            lib.bed_col_stats(dosage.ctypes.data, m, n,
                              sums.ctypes.data, nmiss.ctypes.data)
            return sums, nmiss
        miss = dosage == 255
        sums = np.where(miss, 0, dosage).sum(axis=1).astype(np.float64)
        return sums, miss.sum(axis=1).astype(np.int64)


_DOSE2CODE = np.array([0b00, 0b10, 0b11], dtype=np.uint8)


def clean_packed(packed: np.ndarray, fill: np.ndarray,
                 out: np.ndarray | None = None,
                 num_threads: int | None = None) -> np.ndarray:
    """Replace missing codes (0b01) with each SNP's integral fill dosage
    (values in {0,1,2}) directly in the packed bytes, so device kernels
    decode with no missing branch. Optionally writes into a wider
    zero-padded `out` (rows zero-extended) in the same pass.

    Returns the cleaned array (== `out` when given)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    m, bps = packed.shape
    fill_arr = np.asarray(fill)
    # the whole clean=True SWAR-decode path assumes integral fills in
    # {0,1,2}; a non-integral impute mode must never silently truncate here
    if not np.array_equal(fill_arr, np.rint(fill_arr)):
        raise ValueError("clean_packed requires integral fill dosages "
                         "(got non-integral imputation values)")
    fill_code = _DOSE2CODE[fill_arr.astype(np.int64)]
    if out is None:
        out = np.empty_like(packed)
    assert out.shape[1] >= bps and out.shape[0] >= m and out.dtype == np.uint8
    lib = _load_native()
    if lib is not None:
        lib.bed_clean_packed(
            packed.ctypes.data, m, bps,
            np.ascontiguousarray(fill_code).ctypes.data,
            out.ctypes.data, out.shape[1],
            num_threads or min(8, os.cpu_count() or 1))
        return out
    # NumPy fallback: per-row LUT select
    luts = _clean_luts()
    out[:m, :bps] = luts[fill_code][np.arange(m)[:, None],
                                    packed.astype(np.int64)]
    out[:m, bps:] = 0
    return out


_CLEAN_LUTS = None


def _clean_luts():
    global _CLEAN_LUTS
    if _CLEAN_LUTS is None:
        luts = np.zeros((4, 256), dtype=np.uint8)
        for f in range(4):
            for b in range(256):
                v = 0
                for i in range(4):
                    code = (b >> (2 * i)) & 3
                    if code == 1:
                        code = f
                    v |= code << (2 * i)
                luts[f, b] = v
        _CLEAN_LUTS = luts
    return _CLEAN_LUTS


def write_bed(path: str, dosage_snp_major: np.ndarray) -> None:
    """Write a PLINK .bed from an (M, N) uint8 dosage matrix (255 = missing)."""
    packed = encode_dosage(dosage_snp_major)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(packed.tobytes())
