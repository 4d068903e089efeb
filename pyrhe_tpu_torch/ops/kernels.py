"""Fused 2-bit decode + moment products: CUDA kernels and plain versions.

Port of pyrhe_tpu/ops/kernels.py for the clean int32-word path, the only
one the engine runs. A block of cleaned .bed bytes (no missing codes,
io/bed.clean_packed) is viewed as little-endian int32 words, 16 two-bit
codes per word, and decoded to dosages {0, 1, 2} by a SWAR trick:

    h = (w >> 1) & 0x55555555;  d = h + (h & w);  plane p = (d >> 2p) & 3

Decoded columns are in plane order: word k, plane p is column
(k // 128) * 2048 + p * 128 + k % 128, so every N-indexed array is permuted
once on the host (plane_permutation) and nothing is ever un-permuted:
downstream quantities are reductions over individuals.

`square=True` decodes g² instead, dosage² in {0, 1, 4} (v + (v & 2) per
field), for the dominance component of RHE-DOM.

Each of the four products has
  - a CUDA C++ kernel for Hopper (csrc/rhe_kernels.cu), built with nvcc on
    first use and bound through ctypes;
  - a plain PyTorch version with the same contract (decode to a dense
    (m_pad, n_pad) f32 tile, one f32 product, the same epilogue order),
    which the CPU tests use and chip_smoke.py holds the kernel against.
A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `launches[name]` counts kernel
launches per entry of KERNELS (the square variants apart).

Pass 2 adds sample_contract, a kernel with no TPU counterpart: one
jackknife sample's length-N contractions (core/normal_eq.py) in one read of
its stats, with its plain version sample_contract_plain.

The Pallas wrappers' `fill`, `clean`, `word`, `interpret`, `tm`/`tn`,
`dtype` and `planewise` arguments are gone: the clean word path never
reads `fill`, decode is always clean and word-wise, and `planewise` was an
MXU tiling choice with no counterpart here. The operand dtype (float32, or
bfloat16 for the split2 hi/lo halves) is the tensor's own; products of a
bf16 operand and a dosage are exact in f32, so the plain versions upcast
before multiplying and every kernel accumulates in f32: bf16 operands on
the tensor cores (gp and the ytg family), f32 operands in f32 FMAs on the
CUDA cores (the tensor cores would round them to TF32).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .decode import PLANES, TN, decode_words

ROW_TILE = 32       # SNP rows: the kernels take m_pad % ROW_TILE == 0
GP_ROWS = 128       # SNP rows per gp block (csrc/rhe_kernels.cu GP_ROWS)
GP_BLOCKS = 512     # gp_splits aims at no more than this many row x K blocks

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "rhe_kernels.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "kernels")
_SO = os.path.join(BUILD_DIR, "librhe_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def plane_permutation(n_pad: int, tn: int = TN,
                      planes: int = PLANES) -> np.ndarray:
    """pi such that natural-index array[pi] matches the kernels' decoded
    order: within each tile of tn individuals, the bit planes are laid out
    contiguously. n_pad must be a multiple of tn.

    planes=4: byte-lane decode — plane p holds code p of each byte.
    planes=16: int32-word decode (4 packed bytes per lane) — plane
    p = 4*byte_in_word + code_in_byte, each plane tn/16 long."""
    assert n_pad % tn == 0 and planes in (4, 16)
    out = []
    for t0 in range(0, n_pad, tn):
        idx = np.arange(t0, t0 + tn).reshape(tn // planes, planes)
        out.extend(idx[:, p] for p in range(planes))
    return np.concatenate(out)


def pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def gp_splits(m_pad: int, n_pad: int) -> tuple[int, int]:
    """(periods per split, S): gp_matmul's split-K partition over
    individuals. Split s takes the whole plane-permutation periods
    [s * per, min((s + 1) * per, n_pad / TN)), i.e. words
    [s * per * 128, ...) of every row; every split is non-empty. S grows
    until the grid holds about GP_BLOCKS blocks of GP_ROWS rows (or one
    period per split), and depends on the shapes alone, never on the card,
    so the result is the same on any card and on every call."""
    periods = n_pad // TN
    cap = max(1, GP_BLOCKS // -(-m_pad // GP_ROWS))
    per = -(-periods // cap)
    return per, -(-periods // per)


def gp_workspace_shape(m_pad: int, n_pad: int, W: int) -> tuple:
    """Shape of gp_matmul's f32 partials, (S, m_pad, W); empty when
    S == 1 (the kernel then writes the output itself)."""
    S = gp_splits(m_pad, n_pad)[1]
    return (S, m_pad, W) if S > 1 else (0,)


# ------------------------------------------------------------------ build
def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/rhe_kernels.cu with nvcc for sm_90a into BUILD_DIR
    (when the library is missing or older than the source) and load it.
    verbose=True adds `-Xptxas -v` and prints the compiler's report of
    registers, shared memory and spills."""
    global _lib
    if _lib is not None and not verbose:
        return _lib
    stale = (not os.path.exists(_SO)
             or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
    if stale or verbose:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, _SRC]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                                   f"{res.stdout}{res.stderr}")
            if verbose:
                print(res.stdout + res.stderr, end="")
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(_SO)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rhe_gp.argtypes = [P, P, I, I, P, P, L, L, I, I, I, P]
    lib.rhe_ytg.argtypes = [P, P, I, I, P, L, L, I, P]
    lib.rhe_ytg_acc.argtypes = [P, P, I, P, P, P, P, L, L, I, I, P]
    lib.rhe_ytg_acc2.argtypes = [P, P, P, I, P, P, P, L, L, I, I, P]
    lib.rhe_sample_contract.argtypes = [P] * 6 + [I, P, P, L] + [I] * 5 + [P]
    lib.rhe_sample_contract_plan.argtypes = [L, I, I, I,
                                             ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.rhe_gp, lib.rhe_ytg, lib.rhe_ytg_acc, lib.rhe_ytg_acc2,
               lib.rhe_sample_contract, lib.rhe_sample_contract_plan):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ contracts
def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"words must be a 2-D int32 tensor, got "
                        f"{words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    m_pad, nw = words.shape
    if m_pad % ROW_TILE or (nw * PLANES) % TN:
        raise ValueError(f"words shape {tuple(words.shape)}: need m_pad % "
                         f"{ROW_TILE} == 0 and n_pad % {TN} == 0")


def _check_operand(x: torch.Tensor, name: str, words: torch.Tensor,
                   dtypes=(torch.float32, torch.bfloat16)) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {x.dtype}")
    if x.device != words.device:
        raise ValueError(f"{name} is on {x.device}, words on {words.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_device(words: torch.Tensor) -> bool:
    """True: launch the kernel; False: CPU tensors take the plain version."""
    if words.device.type == "cpu":
        return False
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    return True


# ------------------------------------------------------- plain versions
def gp_plain(words: torch.Tensor, C: torch.Tensor,
             square: bool = False) -> torch.Tensor:
    return decode_words(words, square) @ C.float()


def ytg_plain(words: torch.Tensor, Yt: torch.Tensor,
              square: bool = False) -> torch.Tensor:
    return Yt.float() @ decode_words(words, square)


def sum_halves(a, split):
    """Σ_halves of a stage-2 product whose operand was hi/lo-stacked on
    rows (split), else the product itself."""
    if not split:
        return a
    Q = a.shape[0] // 2
    return a[:Q] + a[Q:]


def ytg_acc_plain(words, Yt, rank1, scale, mask, tot, split):
    a = sum_halves(ytg_plain(words, Yt), split)
    return tot.add_(((a - rank1) * scale) * mask)


def ytg_acc2_plain(words, Yt1, Yt2, rank1, mask, tot, split):
    a1 = sum_halves(ytg_plain(words, Yt1), split)
    a2 = sum_halves(ytg_plain(words, Yt2, square=True), split)
    return tot.add_(((a1 + a2) - rank1) * mask)


# -------------------------------------------------------------- wrappers
def gp_matmul(words: torch.Tensor, C: torch.Tensor,
              square: bool = False) -> torch.Tensor:
    """GP = g @ C (G2P = g² @ C when square) with in-kernel decode
    (stage 1). Replaces pyrhe_tpu/ops/kernels.py gp_matmul / _gp_kernel.

    words: (m_pad, n_pad/16) int32; C: (n_pad, W) f32, or bf16 hi|lo
    halves side by side when split; returns (m_pad, W) f32.

    Bound on the H100: bytes (m·N/4 of words and N·W·2 of bf16 C, against
    2·m·N·W flops on the bf16 tensor cores). Design: a deterministic
    split-K over individuals (gp_splits): each block takes 128 SNP rows,
    64 columns and a contiguous range of whole 2048-individual periods,
    stages words and C rows in shared memory with cp.async and runs
    mma.sync bf16 (dosages are exact in bf16) with f32 accumulators into
    an (S, m_pad, W) workspace from torch.empty; a second kernel sums the
    S partials in split order. No atomics, so every launch is
    deterministic and the result depends on the shapes alone. f32 C takes
    the same grid with an f32 FMA loop on the CUDA cores."""
    _check_words(words)
    _check_operand(C, "C", words)
    m_pad, nw = words.shape
    if C.dim() != 2 or C.shape[0] != nw * PLANES:
        raise ValueError(f"C shape {tuple(C.shape)} does not match words "
                         f"{tuple(words.shape)}")
    if not _launch_device(words):
        return gp_plain(words, C, square)
    lib = build()
    W = C.shape[1]
    n_pad = nw * PLANES
    per, S = gp_splits(m_pad, n_pad)
    out = torch.empty((m_pad, W), dtype=torch.float32, device=words.device)
    part = torch.empty(gp_workspace_shape(m_pad, n_pad, W),
                       dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        _check(lib.rhe_gp(words.data_ptr(), C.data_ptr(),
                          int(C.dtype == torch.bfloat16), int(square),
                          part.data_ptr(), out.data_ptr(), m_pad, nw, W,
                          per, S, _stream(words)),
               "gp_matmul")
    launches["gp_matmul_square" if square else "gp_matmul"] += 1
    return out


def ytg_matmul(words: torch.Tensor, Yt: torch.Tensor,
               square: bool = False) -> torch.Tensor:
    """XXG^T = Yt @ g (Yt @ g² when square) with in-kernel decode
    (transposed stage 2). Replaces pyrhe_tpu/ops/kernels.py ytg_matmul /
    _ytg_kernel.

    words: (m_pad, n_pad/16) int32; Yt: (Qr, m_pad) f32, or bf16 hi/lo
    halves stacked on rows when split; returns (Qr, n_pad) f32 in plane
    order.

    Bound on the H100: operations, 2·Qr·m·N flops on the bf16 tensor
    cores (66.5 µs at Qr 320, m 1024, N 100352); the words and the f32
    output (4·Qr·N bytes) take somewhat less. Design for bf16 Yt:
    mma.sync m16n8k16 with A = Yt rows and B = dosages (n = 8 consecutive
    words at one plane); a block of 8 warps takes 64 Yt rows x 16 words
    (256 output columns) and loops over all SNP rows in increasing order,
    staging 64 SNP rows of words and Yt at a time with cp.async in a
    4-stage ring; per 16 SNP rows each thread decodes 4 words once and
    forms the bf16 operands of its 4 planes, each feeding 4 m16 tiles.
    No split-K and no atomics. f32 Yt takes an FMA loop on the CUDA
    cores. Both main loops are shared with ytg_acc_matmul and
    ytg_acc2_matmul, so they agree bitwise."""
    _check_words(words)
    _check_operand(Yt, "Yt", words)
    m_pad, nw = words.shape
    if Yt.dim() != 2 or Yt.shape[1] != m_pad:
        raise ValueError(f"Yt shape {tuple(Yt.shape)} does not match words "
                         f"{tuple(words.shape)}")
    if not _launch_device(words):
        return ytg_plain(words, Yt, square)
    lib = build()
    Qr = Yt.shape[0]
    out = torch.empty((Qr, nw * PLANES), dtype=torch.float32,
                      device=words.device)
    with torch.cuda.device(words.device):
        _check(lib.rhe_ytg(words.data_ptr(), Yt.data_ptr(),
                           int(Yt.dtype == torch.bfloat16), int(square),
                           out.data_ptr(), m_pad, nw, Qr, _stream(words)),
               "ytg_matmul")
    launches["ytg_matmul_square" if square else "ytg_matmul"] += 1
    return out


def ytg_acc_matmul(words: torch.Tensor, Yt: torch.Tensor,
                   rank1: torch.Tensor, scale: torch.Tensor,
                   mask: torch.Tensor, tot: torch.Tensor, *,
                   split: bool) -> torch.Tensor:
    """tot <- tot + mask ⊙ (scale ⊙ (Σ_halves Yt @ g − rank1)), updated in
    place and returned. Replaces pyrhe_tpu/ops/kernels.py ytg_acc_matmul /
    _ytg_acc_kernel (whose aliased totals become an in-place update).

    Yt: (2Q, m_pad) hi/lo-stacked when split else (Q, m_pad); rank1:
    (Q, 1) f32; scale, mask: (1, n_pad) f32; tot: (Q, n_pad) f32.

    Bound on the H100: as ytg_matmul (operations on the bf16 tensor
    cores), plus one read-modify-write of the totals (8·Q·N bytes).
    Design: the ytg main loop, with a row map that puts the hi and lo rows
    of one output row at rows r and r + 8 of one m16 tile, so one thread
    holds both halves of its output rows; the epilogue rounds each step
    on its own
    (no FMA contraction) in the order of the materializing path's tensor
    ops — (hi + lo) − rank1, × scale, × mask, then tot + — so the result is
    bitwise equal to ytg_matmul followed by that transform. Multiplying by
    scale = 1.0 is an IEEE identity, so additive components need no
    branch."""
    _check_words(words)
    _check_operand(Yt, "Yt", words)
    for name, t in (("rank1", rank1), ("scale", scale), ("mask", mask),
                    ("tot", tot)):
        _check_operand(t, name, words, dtypes=(torch.float32,))
    m_pad, nw = words.shape
    n_pad = nw * PLANES
    Qr = Yt.shape[0]
    Q = Qr // 2 if split else Qr
    if (Yt.dim() != 2 or Yt.shape[1] != m_pad or (split and Qr % 2)
            or rank1.shape != (Q, 1) or scale.shape != (1, n_pad)
            or mask.shape != (1, n_pad) or tot.shape != (Q, n_pad)):
        raise ValueError(
            f"ytg_acc_matmul shapes: words {tuple(words.shape)}, Yt "
            f"{tuple(Yt.shape)}, rank1 {tuple(rank1.shape)}, scale "
            f"{tuple(scale.shape)}, mask {tuple(mask.shape)}, tot "
            f"{tuple(tot.shape)}, split={split}")
    if not _launch_device(words):
        return ytg_acc_plain(words, Yt, rank1, scale, mask, tot, split)
    lib = build()
    with torch.cuda.device(words.device):
        _check(lib.rhe_ytg_acc(words.data_ptr(), Yt.data_ptr(),
                               int(Yt.dtype == torch.bfloat16),
                               rank1.data_ptr(), scale.data_ptr(),
                               mask.data_ptr(), tot.data_ptr(), m_pad, nw,
                               Q, int(split), _stream(words)),
               "ytg_acc_matmul")
    launches["ytg_acc_matmul"] += 1
    return tot


def ytg_acc2_matmul(words: torch.Tensor, Yt1: torch.Tensor,
                    Yt2: torch.Tensor, rank1: torch.Tensor,
                    mask: torch.Tensor, tot: torch.Tensor, *,
                    split: bool) -> torch.Tensor:
    """tot <- tot + mask ⊙ ((Σ_halves Yt1 @ g + Σ_halves Yt2 @ g²) − rank1),
    updated in place and returned: the dominance component's aliased stage
    2. Replaces pyrhe_tpu/ops/kernels.py ytg_acc2_matmul /
    _ytg_acc2_kernel.

    Yt1, Yt2: (2Q, m_pad) hi/lo-stacked when split else (Q, m_pad), of one
    dtype; rank1: (Q, 1) f32; mask: (1, n_pad) f32; tot: (Q, n_pad) f32.

    Bound on the H100: as ytg_acc_matmul with twice the flops per
    decoded word (133 µs at phase-3 shapes). Design: one launch of the
    ytg_acc main loop and row map reads and decodes each word once and
    feeds two accumulator sets (Yt1·g and Yt2·g², Yt tiles staged side by
    side in shared memory; 4 planes a warp, so 64 accumulators a thread
    in all), each the same mma (or FMA) chain over m as the standalone
    ytg_matmul / square ytg_matmul launch for its row;
    the epilogue rounds ((hi1 + lo1) + (hi2 + lo2)) − rank1, × mask, then
    tot + step by step, so the result is bitwise equal to two ytg_matmul
    calls followed by the materializing path's tensor ops."""
    _check_words(words)
    _check_operand(Yt1, "Yt1", words)
    _check_operand(Yt2, "Yt2", words, dtypes=(Yt1.dtype,))
    for name, t in (("rank1", rank1), ("mask", mask), ("tot", tot)):
        _check_operand(t, name, words, dtypes=(torch.float32,))
    m_pad, nw = words.shape
    n_pad = nw * PLANES
    Qr = Yt1.shape[0]
    Q = Qr // 2 if split else Qr
    if (Yt1.dim() != 2 or Yt1.shape[1] != m_pad or Yt2.shape != Yt1.shape
            or (split and Qr % 2) or rank1.shape != (Q, 1)
            or mask.shape != (1, n_pad) or tot.shape != (Q, n_pad)):
        raise ValueError(
            f"ytg_acc2_matmul shapes: words {tuple(words.shape)}, Yt1 "
            f"{tuple(Yt1.shape)}, Yt2 {tuple(Yt2.shape)}, rank1 "
            f"{tuple(rank1.shape)}, mask {tuple(mask.shape)}, tot "
            f"{tuple(tot.shape)}, split={split}")
    if not _launch_device(words):
        return ytg_acc2_plain(words, Yt1, Yt2, rank1, mask, tot, split)
    lib = build()
    with torch.cuda.device(words.device):
        _check(lib.rhe_ytg_acc2(words.data_ptr(), Yt1.data_ptr(),
                                Yt2.data_ptr(),
                                int(Yt1.dtype == torch.bfloat16),
                                rank1.data_ptr(), mask.data_ptr(),
                                tot.data_ptr(), m_pad, nw, Q, int(split),
                                _stream(words)),
               "ytg_acc2_matmul")
    launches["ytg_acc2_matmul"] += 1
    return tot


# ------------------------------------------------ pass-2 contractions
PLAN_KEYS = ("na", "nk", "ntiles", "tpt", "tg", "nchunks", "ncs", "smem")


def sample_contract_plan(E: int, ncov: int, N: int, f64: bool) -> dict:
    """sample_contract's partition at these shapes, as the kernel computes
    it (csrc/rhe_kernels.cu sc_plan; needs the built library): 4-row tiles
    of the stats rows (na) and of the [C^T | z | u] rows (nk), the tiles
    (ntiles), tiles a thread (tpt) and a group (tg), blocks along N
    (nchunks), individuals a stage (ncs) and a block's dynamic shared
    memory (smem, bytes). Raises ValueError past the card's shared memory
    a block."""
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    if build().rhe_sample_contract_plan(N, E, ncov, int(f64), plan):
        raise ValueError(f"sample_contract: E = {E} rows with ncov = {ncov} "
                         f"need {plan[-1]} bytes of shared memory a block")
    return dict(zip(PLAN_KEYS, plan))


def _check_sample_args(tot, drop, nxe, Ct, Zt, Ut, B):
    if tot.dtype not in (torch.float32, torch.float64) or tot.dim() != 3:
        raise TypeError(f"tot must be a 3-D float32 or float64 tensor, got "
                        f"{tot.dtype} {tuple(tot.shape)}")
    E_geno, b2, N = tot.shape
    ncov = 0 if Ct is None else Ct.shape[0]
    want = {"tot": (E_geno, b2, N), "drop": (E_geno, b2, N),
            "nxe": (None, b2, N), "Ct": (ncov, N), "Zt": (B, N),
            "Ut": (B, N)}
    for name, t in (("tot", tot), ("drop", drop), ("nxe", nxe), ("Ct", Ct),
                    ("Zt", Zt), ("Ut", Ut)):
        if t is None:
            continue
        if t.dtype != tot.dtype or t.device != tot.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, tot "
                            f"{tot.dtype} on {tot.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape = tuple(t.shape)
        if len(shape) != len(want[name]) or any(
                w is not None and w != g for w, g in zip(want[name], shape)):
            raise ValueError(f"{name} shape {shape}, expected {want[name]} "
                             f"(None: any)")
    if b2 != (2 * B if ncov else B) or (Ut is None) != (ncov == 0):
        raise ValueError(f"b2 = {b2} with B = {B} and ncov = {ncov} (Ut "
                         f"{'absent' if Ut is None else 'given'}): b2 is 2B "
                         "with covariates (and Uzb), else B")


def sample_contract_plain(tot, drop, nxe, Ct, Zt, Ut, B):
    """sample_contract's contract in plain PyTorch: X = tot - drop (tot
    without a drop) with the NxE rows appended, then multiply+reduce in the
    stats' dtype for G1 (one row of X at a time), the projections C^T X and
    the border products, cast to float64."""
    X = tot if drop is None else tot - drop
    if nxe is not None:
        X = torch.cat([X, nxe])
    XXz = X[:, :B]
    f64 = torch.float64
    G1 = torch.stack([torch.sum(x[None] * XXz, dim=(1, 2)) for x in XXz])
    zd = torch.sum(XXz * Zt[None], dim=(1, 2))
    if Ct is None:
        P = X.new_zeros((X.shape[0], 0, B), dtype=f64)
        return G1.to(f64), P, P, zd.to(f64), None

    def project(A):
        return torch.stack([torch.sum(Ct[:, None, :] * a[None], dim=-1)
                            for a in A])                  # (E, ncov, B)

    return (G1.to(f64), project(XXz).to(f64), project(X[:, B:]).to(f64),
            zd.to(f64), torch.sum(XXz * Ut[None], dim=(1, 2)).to(f64))


def sample_contract(tot: torch.Tensor, drop: torch.Tensor | None,
                    nxe: torch.Tensor | None, Ct: torch.Tensor | None,
                    Zt: torch.Tensor, Ut: torch.Tensor | None, *, B: int):
    """One jackknife sample's length-N contractions in one pass over its
    stats. Replaces no TPU kernel: pyrhe_tpu/core/normal_eq.py's _gram,
    project_cov and _dotvec run as XLA multiply+reduce.

    The sample's stats X (E, b2, N) are tot - drop (tot: (E_geno, b2, N)
    totals, drop: the left-out block's stats or None) with the NxE rows nxe
    (num_nxe, b2, N) or None appended. Ct (ncov, N) is C^T or None (no
    covariates, b2 = B), Zt and Ut (B, N) the probes and projected probes
    transposed (Ut None without covariates); all of tot's dtype, float32 or
    float64, contiguous. Returns float64 (G1 (E, E), P (E, ncov, B),
    R (E, ncov, B), zd (E,), ud (E,) or None):
      G1[e, f] = <X[e, :B], X[f, :B]>,  P[e, :, b] = C^T X[e, b],
      R[e, :, b] = C^T X[e, B + b],  zd[e] = <X[e, :B], Z^T>,
      ud[e] = <X[e, :B], Uzb^T>.

    Bound on the H100: bytes, the stats read once (GENIE E = 26, b2 = 20,
    N = 100,352 f32, tot and drop: 418 MB, 125 µs at 3.35 TB/s; RHE k = 50:
    642 MB, 192 µs). Design (csrc/rhe_kernels.cu sample_contract_kernel):
    a grid over (N chunk, b), each block staging its chunk's rows of that b
    in shared memory with tot - drop formed on the load, 4 x 4 output tiles
    (half of G1's) shared by lanes over the chunk, products and sums in the
    stats' dtype over at most 256 terms a lane, lane partials summed in
    float64, then an ordered float64 merge over chunks and b in a second
    kernel. No atomics, no tensor cores: deterministic, and the same for
    the same shapes. A float64 run takes the same kernel in float64."""
    _check_sample_args(tot, drop, nxe, Ct, Zt, Ut, B)
    if not _launch_device(tot):
        return sample_contract_plain(tot, drop, nxe, Ct, Zt, Ut, B)
    lib = build()
    E_geno, b2, N = tot.shape
    E = E_geno + (0 if nxe is None else nxe.shape[0])
    ncov = 0 if Ct is None else Ct.shape[0]
    f64 = torch.float64
    plan = sample_contract_plan(E, ncov, N, tot.dtype == f64)
    part = torch.empty((B * plan["nchunks"], plan["ntiles"] * 16), dtype=f64,
                       device=tot.device)
    n_p = E * ncov * B
    out = torch.empty(E * E + 2 * n_p + 2 * E, dtype=f64, device=tot.device)
    with torch.cuda.device(tot.device):
        _check(lib.rhe_sample_contract(
            *(None if t is None else t.data_ptr()
              for t in (tot, drop, nxe, Ct, Zt, Ut)),
            int(tot.dtype == f64), part.data_ptr(), out.data_ptr(), N, E,
            E_geno, B, b2, ncov, _stream(tot)), "sample_contract")
    launches["sample_contract"] += 1
    G1, P, R, zd, ud = torch.split(out, [E * E, n_p, n_p, E, E])
    return (G1.view(E, E), P.view(E, ncov, B), R.view(E, ncov, B), zd,
            ud if ncov else None)


# Every kernel variant, as counted in `launches`.
KERNELS = ("gp_matmul", "gp_matmul_square", "ytg_matmul",
           "ytg_matmul_square", "ytg_acc_matmul", "ytg_acc2_matmul",
           "sample_contract")
launches = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launches[name] = 0
