"""MPEG-1/2, H.263 and MPEG-4 matrix inverse quantisation, MPEG-2
mismatch control, the MPEG-4 DC scaler and the scans (counterpart of
`libav_tpu/ops/quant.py` mpeg1_dequant_intra/inter,
mpeg2_dequant_intra/inter, mpeg2_mismatch_control, h263_dequant,
mpeg4_dc_scaler, mpeg4_mq_dequant_intra/inter, dezigzag and the JPEG
encoder's jpeg_quant; reference: mpegvideo.c dct_unquantize_mpeg1_* /
_mpeg2_* / _h263_* and the bitexact MPEG-4 matrix pair). The JAX module's encoder-side `mpeg_quant` has no
caller in the port and is left out.

Elementwise int32 over (B, 64) coefficients, as in the JAX package: with
int16 levels, qscale <= 112 and matrix entries <= 255 no product leaves
int32. The scans, the DC scaler and the h263 reference are the JAX
package's numpy code, copied (`libav_tpu/ops/quant.py` zigzag_scan,
alternate_scan, alternate_horizontal_scan, mpeg4_dc_scaler,
h263_dequant_ref).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def zigzag_scan() -> np.ndarray:
    """Zigzag scan order: zigzag_scan()[i] = raster index of i-th scanned
    coeff (reference: ff_zigzag_direct). Generated, not tabulated."""
    order = []
    for s in range(15):
        idxs = [(s - j, j) for j in range(s + 1) if 0 <= s - j < 8 and 0 <= j < 8]
        if s % 2 == 1:
            idxs.reverse()  # odd diagonals run top-right -> bottom-left
        order += [r * 8 + c for r, c in idxs]
    return np.array(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def alternate_horizontal_scan() -> np.ndarray:
    """MPEG-4 alternate horizontal scan, used for intra blocks whose AC
    prediction came from the block above (ISO 14496-2 Table 12-2;
    reference: ff_alternate_horizontal_scan, mpegvideodata.c:82)."""
    t = [
        0,  1,  2,  3,  8,  9, 16, 17, 10, 11,  4,  5,  6,  7, 15, 14,
        13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
        30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
        46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63,
    ]
    return np.array(t, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def alternate_scan() -> np.ndarray:
    """MPEG-2 alternate (vertical) scan for interlaced content
    (reference: ff_alternate_vertical_scan)."""
    t = [
        0,  8, 16, 24,  1,  9,  2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
        41, 33, 26, 18,  3, 11,  4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
        51, 59, 20, 28,  5, 13,  6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
        53, 61, 22, 30,  7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63,
    ]
    return np.array(t, dtype=np.int32)


def raster_positions(scan: np.ndarray = None) -> torch.Tensor:
    """pos[raster index] = scan position, int64 on the CPU, for
    `dezigzag` (default: the zigzag scan)."""
    s = zigzag_scan() if scan is None else np.asarray(scan)
    pos = np.empty(64, np.int64)
    pos[s] = np.arange(64)
    return torch.as_tensor(pos)


def dezigzag(coeffs_scan_order: torch.Tensor,
             pos: torch.Tensor = None) -> torch.Tensor:
    """(B, 64) scan-order coeffs -> (B, 8, 8) raster blocks; pos is
    `raster_positions(scan)` on the coefficients' device (default: the
    zigzag scan's)."""
    if pos is None:
        pos = raster_positions().to(coeffs_scan_order.device)
    return coeffs_scan_order[..., pos].reshape(
        *coeffs_scan_order.shape[:-1], 8, 8)


def jpeg_quant_ref(coeffs: np.ndarray, qmat: np.ndarray) -> np.ndarray:
    """Golden: round-half-away division (JPEG Annex encoder convention)."""
    c = coeffs.astype(np.int64)
    q = qmat.astype(np.int64)
    return (np.sign(c) * ((np.abs(c) + q // 2) // q)).astype(np.int32)


def jpeg_quant(coeffs: torch.Tensor, qmat: torch.Tensor) -> torch.Tensor:
    """sign(c) * ((|c| + q // 2) // q), int32 (the JAX package's
    jpeg_quant); qmat broadcasts against coeffs."""
    c = coeffs.to(torch.int32)
    q = qmat.to(torch.int32)
    return torch.sign(c) * torch.div(c.abs() + q // 2, q,
                                     rounding_mode="floor")


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


def h263_dequant(coeffs, qscale, dc_scaler, intra: bool):
    """H.263 / MPEG-4 quant_type 0 (reference: mpegvideo.c
    dct_unquantize_h263_intra/inter): |rec| = q (2|L| + 1) - (1 if q is
    even), the intra DC = L * dc_scaler, clipped to [-2048, 2047]."""
    c, q, _ = _operands(coeffs, qscale, 1)
    lvl = torch.sign(c) * (q * (2 * c.abs() + 1) - (1 - (q & 1)))
    if intra:
        d = torch.as_tensor(dc_scaler, dtype=torch.int32, device=c.device)
        while d.dim() < c.dim():
            d = d[..., None]
        lvl = _with_dc(lvl, c * d)
    return lvl.clamp(-2048, 2047)


def h263_dequant_ref(coeffs: np.ndarray, qscale, dc_scaler,
                     intra: bool) -> np.ndarray:
    c = coeffs.astype(np.int64)
    q = np.asarray(qscale, dtype=np.int64)
    while q.ndim < c.ndim:
        q = q[..., None]
    even = 1 - (q & 1)
    lvl = np.sign(c) * (q * (2 * np.abs(c) + 1) - even)
    if intra:
        d = np.asarray(dc_scaler, dtype=np.int64)
        while d.ndim < c.ndim:
            d = d[..., None]
        mask = np.zeros(64, dtype=bool)
        mask[0] = True
        lvl = np.where(mask, c * d, lvl)
    return np.clip(lvl, -2048, 2047).astype(np.int32)


def mpeg4_dc_scaler(qscale, luma: bool):
    """ISO 14496-2 §7.4.1 table 7-2 DC scaler, on an int (-> int) or a
    numpy array (-> int32 array)."""
    q = np.asarray(qscale)
    if luma:
        s = np.where(q < 5, 8,
                     np.where(q < 9, 2 * q,
                              np.where(q < 25, q + 8, 2 * q - 16)))
    else:
        s = np.where(q < 5, 8,
                     np.where(q < 25, (q + 13) // 2, q - 6))
    return s.astype(np.int32) if s.ndim else int(s)


def dc_scaler(qscale: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
    """mpeg4_dc_scaler on tensors: per-element qscale, luma flags."""
    q = qscale.to(torch.int32)
    lum = torch.where(q < 5, 8, torch.where(q < 9, 2 * q, torch.where(
        q < 25, q + 8, 2 * q - 16)))
    chroma = torch.where(q < 5, 8, torch.where(q < 25, (q + 13) // 2, q - 6))
    return torch.where(luma, lum, chroma).to(torch.int32)


# ---------------------------------------------------------------------- #
# The MPEG-4 quant_type 1 pair
# ---------------------------------------------------------------------- #

def _toggle_63(deq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """block[63] ^= s & 1 (s is a sum, widened by torch; its parity is
    the int32 sum's)."""
    out = deq.clone()
    out[:, 63] = deq[:, 63] ^ (s & 1).to(deq.dtype)
    return out


def mpeg4_mq_dequant_intra(coeffs, qs, qmat, dcs):
    """MPEG-4 quant_type=1 intra dequant, bitexact variant (reference
    mpegvideo.c:142 dct_unquantize_mpeg2_intra_bitexact as wired for
    MPEG-4): AC = sign*((|l|*qscale*M)>>3), DC = l*dc_scaler, then the
    parity fix block[63] ^= (sum_AC - 1) & 1. coeffs (B, 64) and qmat
    (64,) in the same scan order, qs and dcs (B,); slot 63 is raster 63
    in every scan."""
    c, q, m = _operands(coeffs, qs, qmat)
    deq = torch.sign(c) * ((c.abs() * q * m) >> 3)
    deq[:, 0] = c[:, 0] * torch.as_tensor(dcs, dtype=torch.int32,
                                          device=c.device)
    return _toggle_63(deq, deq[:, 1:].sum(dim=1) - 1)


def mpeg4_mq_dequant_inter(coeffs, qs, qmat):
    """MPEG-4 quant_type=1 inter dequant (reference mpegvideo.c:175
    dct_unquantize_mpeg2_inter_c): sign*(((2|l|+1)*qscale*M)>>4) for
    nonzero l, then block[63] ^= (sum - 1) & 1."""
    c, q, m = _operands(coeffs, qs, qmat)
    deq = torch.sign(c) * (((2 * c.abs() + 1) * q * m) >> 4)
    return _toggle_63(deq, deq.sum(dim=1) - 1)
