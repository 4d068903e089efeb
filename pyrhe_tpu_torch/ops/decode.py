"""Decode of the staged genotype words into dosages on the device.

Port of pyrhe_tpu/ops/decode.py for the port's one staging format: a block
of .bed rows whose missing codes were already rewritten with the SNP's
imputation fill on the host (io/bed.clean_packed; the fills are integral:
an HWE draw for "binary", 0 for "mean"), padded to (m_pad, n_pad/4) bytes
and viewed as int32 words of 16 two-bit codes. Decoding the words therefore
yields the imputed, unstandardized dosages; the reference's separate
`impute` step is the clean on the host.

Codes decode by a SWAR trick, h = (w >> 1) & 0x55555555; d = h + (h & w);
plane p = (d >> 2p) & 3, and come out in plane order: word k, plane p is
column (k // 128) * 2048 + p * 128 + k % 128 (ops/kernels.plane_permutation).
"""
from __future__ import annotations

import torch

TN = 2048           # plane-permutation period (individuals)
PLANES = 16         # codes per int32 word


def decode_words(words: torch.Tensor, square: bool = False,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(m, n_pad/16) int32 cleaned words -> (m, n_pad) dosages (dosage²,
    {0, 1, 4}, when square) in plane order, in dtype (exact in any float
    dtype)."""
    m, nw = words.shape
    w = words.to(torch.int64) & 0xFFFFFFFF
    h = (w >> 1) & 0x55555555
    d = h + (h & w)
    shifts = torch.arange(0, 2 * PLANES, 2, device=words.device)
    planes = (d[:, :, None] >> shifts) & 3                 # (m, nw, 16)
    if square:
        planes = planes + (planes & 2)                     # 0,1,2 -> 0,1,4
    return (planes.view(m, nw // (TN // PLANES), TN // PLANES, PLANES)
            .permute(0, 1, 3, 2).reshape(m, nw * PLANES).to(dtype))


def imputed_dosages(words: torch.Tensor, m: int, valid_mask: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The block's m real SNP rows as imputed, unstandardized dosages
    (m, n_pad) in dtype, zero at the columns of dropped and padding
    individuals (valid_mask 0), which the staged words still carry."""
    return decode_words(words[:m], dtype=dtype) * valid_mask.to(dtype)
