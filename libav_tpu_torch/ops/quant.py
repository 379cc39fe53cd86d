"""MPEG-1/2 inverse quantisation and mismatch control (counterpart of
`libav_tpu/ops/quant.py` mpeg1_dequant_intra/inter, mpeg2_dequant_intra/
inter and mpeg2_mismatch_control; reference: mpegvideo.c
dct_unquantize_mpeg1_* / dct_unquantize_mpeg2_*).

Elementwise int32 over (B, 64) coefficients, as in the JAX package: with
int16 levels, qscale <= 112 and matrix entries <= 255 no product leaves
int32. The scans stay the JAX package's numpy tables
(`libav_tpu.ops.quant` zigzag_scan, alternate_scan).
"""

from __future__ import annotations

import torch


def _operands(coeffs, qscale, qmat):
    c = coeffs.to(torch.int32)
    q = torch.as_tensor(qscale, dtype=torch.int32, device=c.device)
    while q.dim() < c.dim():
        q = q[..., None]
    m = torch.as_tensor(qmat, dtype=torch.int32, device=c.device)
    return c, q, m


def _with_dc(lvl: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    out = lvl.clone()
    out[..., 0] = dc[..., 0]
    return out


def mpeg1_dequant_intra(coeffs, qscale, qmat):
    """MPEG-1 intra: |level| = ((|c| q m) >> 3 - 1) | 1 (oddified), DC
    = c * 8 (ISO 11172-2 §2.4.4.1)."""
    c, q, m = _operands(coeffs, qscale, qmat)
    mag = (c.abs() * q * m) >> 3
    mag = (mag - 1) | 1
    lvl = torch.where(c != 0, torch.sign(c) * mag, 0)
    return _with_dc(lvl, c * 8)


def mpeg1_dequant_inter(coeffs, qscale, qmat):
    """MPEG-1 inter: |level| = (((2|c| + 1) q m) >> 4 - 1) | 1."""
    c, q, m = _operands(coeffs, qscale, qmat)
    mag = ((2 * c.abs() + 1) * q * m) >> 4
    mag = (mag - 1) | 1
    return torch.where(c != 0, torch.sign(c) * mag, 0)


def mpeg2_dequant_intra(coeffs, qscale, qmat):
    """MPEG-2 intra: sign(c) ((|c| q m) >> 4); the DC passes through
    unscaled (ISO 13818-2 §7.4.2.1)."""
    c, q, m = _operands(coeffs, qscale, qmat)
    lvl = torch.sign(c) * ((c.abs() * q * m) >> 4)
    return _with_dc(lvl, c)


def mpeg2_dequant_inter(coeffs, qscale, qmat):
    """MPEG-2 inter: sign(c) (((2|c| + 1) q m) >> 5) for c != 0."""
    c, q, m = _operands(coeffs, qscale, qmat)
    mag = ((2 * c.abs() + 1) * q * m) >> 5
    return torch.where(c != 0, torch.sign(c) * mag, 0)


def mpeg2_mismatch_control(blocks: torch.Tensor) -> torch.Tensor:
    """Toggle the LSB of coefficient [7, 7] of every (8, 8) block whose
    sum is even (ISO 13818-2 §7.4.4). torch.sum widens to int64; only the
    parity is read, which the width does not change."""
    s = blocks.reshape(blocks.shape[0], 64).sum(dim=-1)
    out = blocks.clone()
    out[:, 7, 7] = blocks[:, 7, 7] ^ ((s & 1) == 0).to(blocks.dtype)
    return out
