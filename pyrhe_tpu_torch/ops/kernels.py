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

Each of the three products has
  - a CUDA C++ kernel for Hopper (csrc/rhe_kernels.cu), built with nvcc on
    first use and bound through ctypes;
  - a plain PyTorch version with the same contract (decode to a dense
    (m_pad, n_pad) f32 tile, one f32 product, the same epilogue order),
    which the CPU tests use and chip_smoke.py holds the kernel against.
A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `launches` on each wrapper counts
kernel launches.

The Pallas wrappers' `fill`, `clean`, `word`, `interpret`, `tm`/`tn`,
`dtype` and `planewise` arguments are gone: the clean word path never
reads `fill`, decode is always clean and word-wise, and `planewise` was an
MXU tiling choice with no counterpart here. The operand dtype (float32, or
bfloat16 for the split2 hi/lo halves) is the tensor's own; products of a
bf16 operand and a dosage are exact in f32, so both the kernels and the
plain versions upcast before multiplying and accumulate in f32.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

TN = 2048           # plane-permutation period (individuals); n_pad multiple
ROW_TILE = 32       # SNP rows: the kernels take m_pad % ROW_TILE == 0
PLANES = 16         # codes per int32 word

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
    lib.rhe_gp.argtypes = [P, P, I, P, L, L, I, P]
    lib.rhe_ytg.argtypes = [P, P, I, P, L, L, I, P]
    lib.rhe_ytg_acc.argtypes = [P, P, I, P, P, P, P, L, L, I, I, P]
    for fn in (lib.rhe_gp, lib.rhe_ytg, lib.rhe_ytg_acc):
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
def decode_words(words: torch.Tensor) -> torch.Tensor:
    """(m_pad, n_pad/16) int32 cleaned words -> (m_pad, n_pad) f32
    dosages in plane order."""
    m_pad, nw = words.shape
    w = words.to(torch.int64) & 0xFFFFFFFF
    h = (w >> 1) & 0x55555555
    d = h + (h & w)
    shifts = torch.arange(0, 2 * PLANES, 2, device=words.device)
    planes = (d[:, :, None] >> shifts) & 3                 # (m, nw, 16)
    return (planes.view(m_pad, nw // (TN // PLANES), TN // PLANES, PLANES)
            .permute(0, 1, 3, 2).reshape(m_pad, nw * PLANES)
            .to(torch.float32))


def gp_plain(words: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return decode_words(words) @ C.float()


def ytg_plain(words: torch.Tensor, Yt: torch.Tensor) -> torch.Tensor:
    return Yt.float() @ decode_words(words)


def ytg_acc_plain(words, Yt, rank1, scale, mask, tot, split):
    a = ytg_plain(words, Yt)
    if split:
        Q = a.shape[0] // 2
        a = a[:Q] + a[Q:]
    return tot.add_(((a - rank1) * scale) * mask)


# -------------------------------------------------------------- wrappers
def gp_matmul(words: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """GP = g @ C with in-kernel decode (stage 1). Replaces
    pyrhe_tpu/ops/kernels.py gp_matmul / _gp_kernel.

    words: (m_pad, n_pad/16) int32; C: (n_pad, W) f32, or bf16 hi|lo
    halves side by side when split; returns (m_pad, W) f32.

    Bound on the H100: f32 FMAs on the CUDA cores (2·m·N·W flops against
    m·N/4 + 4·N·W bytes, far above the card's flop/byte balance), and the
    grid: one block per 16 SNP rows x 24 columns keeps the whole reduction
    over N inside the block (deterministic, no atomics, no split-K), which
    at m_pad = 1024 is 64-128 blocks for 132 SMs. Design: each warp keeps
    4 rows x 12 columns of accumulators in registers over 32 words per
    step, C rows are staged once per step in shared memory for all eight
    warps, and the dosage-to-float conversion is a mantissa OR."""
    _check_words(words)
    _check_operand(C, "C", words)
    m_pad, nw = words.shape
    if C.dim() != 2 or C.shape[0] != nw * PLANES:
        raise ValueError(f"C shape {tuple(C.shape)} does not match words "
                         f"{tuple(words.shape)}")
    if not _launch_device(words):
        return gp_plain(words, C)
    lib = build()
    W = C.shape[1]
    out = torch.empty((m_pad, W), dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        _check(lib.rhe_gp(words.data_ptr(), C.data_ptr(),
                          int(C.dtype == torch.bfloat16), out.data_ptr(),
                          m_pad, nw, W, _stream(words)), "gp_matmul")
    gp_matmul.launches += 1
    return out


def ytg_matmul(words: torch.Tensor, Yt: torch.Tensor) -> torch.Tensor:
    """XXG^T = Yt @ g with in-kernel decode (transposed stage 2). Replaces
    pyrhe_tpu/ops/kernels.py ytg_matmul / _ytg_kernel.

    words: (m_pad, n_pad/16) int32; Yt: (Qr, m_pad) f32, or bf16 hi/lo
    halves stacked on rows when split; returns (Qr, n_pad) f32 in plane
    order.

    Bound on the H100: f32 FMAs on the CUDA cores (2·Qr·m·N flops, Qr up
    to 320) plus the in-register decode; the output write (4·Qr·N bytes)
    is small beside them. Design: one block per 256 decoded columns x 32
    Yt rows with the loop over SNP rows inside the block; each thread
    decodes one word per SNP row and spends it on 8 rows x 4 planes of
    FMAs, reading its 8 Yt values as two broadcast 16-byte loads from a
    transposed shared-memory tile. The main loop is shared with
    ytg_acc_matmul, so the two agree bitwise."""
    _check_words(words)
    _check_operand(Yt, "Yt", words)
    m_pad, nw = words.shape
    if Yt.dim() != 2 or Yt.shape[1] != m_pad:
        raise ValueError(f"Yt shape {tuple(Yt.shape)} does not match words "
                         f"{tuple(words.shape)}")
    if not _launch_device(words):
        return ytg_plain(words, Yt)
    lib = build()
    Qr = Yt.shape[0]
    out = torch.empty((Qr, nw * PLANES), dtype=torch.float32,
                      device=words.device)
    with torch.cuda.device(words.device):
        _check(lib.rhe_ytg(words.data_ptr(), Yt.data_ptr(),
                           int(Yt.dtype == torch.bfloat16), out.data_ptr(),
                           m_pad, nw, Qr, _stream(words)), "ytg_matmul")
    ytg_matmul.launches += 1
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

    Bound on the H100: as ytg_matmul, plus one read-modify-write of the
    totals (8·Q·N bytes). Design: the ytg main loop and launch geometry,
    with each tile's hi and lo rows interleaved so one thread holds both
    halves of its output rows; the epilogue rounds each step on its own
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
    ytg_acc_matmul.launches += 1
    return tot


KERNELS = (gp_matmul, ytg_matmul, ytg_acc_matmul)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
