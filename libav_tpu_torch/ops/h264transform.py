"""H.264 transforms and quantisation (counterpart of
`libav_tpu/ops/h264transform.py`: idct4x4, idct8x8_h264 and the DC
transforms that `codecs/h264/device.py` runs inline, and the encoder's
fdct4x4, quant_mf, dequant_scale, quant4x4, dequant4x4, dequant8x8_tab,
the 8x8 transform matrices and their numpy `_ref` twins; spec ISO
14496-10 §8.5).

The integer transforms are exact int32 with two's-complement wrap, as in
the JAX package. The 4x4 forward transform and the luma DC Hadamard are
written as butterflies: CUDA has no int32 matmul, and the JAX einsum with
preferred_element_type=int32 has no torch counterpart on the card.

The encoder's 8x8 forward transform is float32 in the JAX package (an
einsum, then round(c8 / step8)). `fdct8x8_h264_xla` writes out the order
in which XLA sums those dots, so that the levels are the same bit for
bit: `tools/check_fdct8_order.py` holds it against XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# LevelScale V matrix (14496-10 table 8-15): rows qp%6, columns the three
# position classes (0: (0,0),(0,2),(2,0),(2,2); 1: (1,1),(1,3),(3,1),(3,3);
# 2: others)
_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Encoder MF multipliers (the standard values, spec §8.5.9 inverse
# relation)
_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# normAdjust8x8 class values (spec Table in 8.5.13), class index per
# (i%4, j%4) position
_V8_CLS = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                   dtype=np.int32).reshape(4, 4)
_V8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _pos_class() -> np.ndarray:
    cls = np.full((4, 4), 2, dtype=np.int32)
    for (i, j) in [(0, 0), (0, 2), (2, 0), (2, 2)]:
        cls[i, j] = 0
    for (i, j) in [(1, 1), (1, 3), (3, 1), (3, 3)]:
        cls[i, j] = 1
    return cls


@functools.lru_cache(maxsize=None)
def dequant_scale(qp: int) -> np.ndarray:
    """(4,4) dequant multiplier for AC path: V[qp%6, class] << (qp//6)."""
    return (_V[qp % 6][_pos_class()] << (qp // 6)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def quant_mf(qp: int) -> np.ndarray:
    """(4,4) encoder multiplier MF[qp%6, class]; qbits = 15 + qp//6."""
    return _MF[qp % 6][_pos_class()].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pos_class8() -> np.ndarray:
    """(8,8) normAdjust8x8 class per position."""
    ii, jj = np.mgrid[0:8, 0:8]
    return _V8_CLS[ii % 4, jj % 4]


def dequant8x8_tab(qp: int, w=None) -> np.ndarray:
    """(8,8) LS8 = W * normAdjust8x8 of spec 8.5.13 (flat W = 16 by
    default); callers apply the qp/6 shift branch."""
    v = _V8[qp % 6][_pos_class8()]
    if w is None:
        w = np.full((8, 8), 16, np.int32)
    return (v * w.reshape(8, 8)).astype(np.int32)


_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2],
                [1, -1, -1, 1], [1, -2, 2, -1]], dtype=np.int64)


def fdct4x4_ref(blocks: np.ndarray) -> np.ndarray:
    """Golden forward core transform Cf X Cf^T (no scaling)."""
    x = blocks.astype(np.int64)
    return (_CF @ x @ _CF.T).astype(np.int32)


def _fdct4_1d(x0, x1, x2, x3):
    """Rows of Cf applied to (x0..x3)."""
    s03, d03 = x0 + x3, x0 - x3
    s12, d12 = x1 + x2, x1 - x2
    return s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12


def fdct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Batched forward core transform Cf X Cf^T. (B, 4, 4) -> int32."""
    x = blocks.to(torch.int32)
    f = torch.stack(_fdct4_1d(*(x[:, i, :] for i in range(4))), dim=1)
    return torch.stack(_fdct4_1d(*(f[:, :, j] for j in range(4))), dim=2)


def quant4x4_ref(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Golden scalar quant: level = (|W|*MF + f) >> qbits (spec §8.5.9
    informative encoder relation)."""
    mf = quant_mf(qp).astype(np.int64)
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    ww = w.astype(np.int64)
    lv = (np.abs(ww) * mf + f) >> qbits
    return (np.sign(ww) * lv).astype(np.int32)


def quant(w: torch.Tensor, mf, f: int, qbits: int) -> torch.Tensor:
    """sign(w) * ((|w| * mf + f) >> qbits), int32 (the encoder programs'
    inline quantiser); mf a scalar or a tensor broadcasting against w."""
    return torch.sign(w) * ((w.abs() * mf + f) >> qbits)


def quant4x4(w: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    mf = torch.as_tensor(quant_mf(qp), device=w.device)
    qbits = 15 + qp // 6
    return quant(w.to(torch.int32), mf, (1 << qbits) // (3 if intra else 6),
                 qbits)


def dequant4x4_ref(levels: np.ndarray, qp: int) -> np.ndarray:
    return (levels.astype(np.int64) * dequant_scale(qp)).astype(np.int32)


def dequant4x4(levels: torch.Tensor, qp: int) -> torch.Tensor:
    return levels.to(torch.int32) * torch.as_tensor(dequant_scale(qp),
                                                    device=levels.device)


def idct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Batched exact inverse 4x4 transform (8.5.12.2). (B, 4, 4) -> int32."""
    d = blocks.to(torch.int32)
    e0 = d[:, :, 0] + d[:, :, 2]
    e1 = d[:, :, 0] - d[:, :, 2]
    e2 = (d[:, :, 1] >> 1) - d[:, :, 3]
    e3 = d[:, :, 1] + (d[:, :, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0 = f[:, 0, :] + f[:, 2, :]
    g1 = f[:, 0, :] - f[:, 2, :]
    g2 = (f[:, 1, :] >> 1) - f[:, 3, :]
    g3 = f[:, 1, :] + (f[:, 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def _idct8_1d(d):
    """One 8-point inverse pass (spec 8.5.12.2 butterflies) over a list of
    8 tensors."""
    a0 = d[0] + d[4]
    a2 = d[0] - d[4]
    a4 = (d[2] >> 1) - d[6]
    a6 = (d[6] >> 1) + d[2]
    b0 = a0 + a6
    b2 = a2 + a4
    b4 = a2 - a4
    b6 = a0 - a6
    a1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    a3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    a5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    a7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    b1 = (a7 >> 2) + a1
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    b7 = a7 - (a1 >> 2)
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7]


def idct8x8_h264(blocks: torch.Tensor) -> torch.Tensor:
    """Batched exact inverse 8x8 transform, horizontal pass first (the
    normative order). (B, 8, 8) -> int32."""
    d = blocks.to(torch.int32)
    f = torch.stack(_idct8_1d([d[:, :, k] for k in range(8)]), dim=-1)
    h = torch.stack(_idct8_1d([f[:, k, :] for k in range(8)]), dim=-2)
    return (h + 32) >> 6


def _hadamard4_1d(x0, x1, x2, x3):
    """Rows of [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]] applied to
    (x0..x3)."""
    s0, s1 = x0 + x1, x0 - x1
    s2, s3 = x2 + x3, x2 - x3
    return s0 + s2, s0 - s2, s1 - s3, s1 + s3


def hadamard4x4(dc: torch.Tensor) -> torch.Tensor:
    """H @ dc @ H^T for (B, 4, 4) int32 (spec 8.5.10), as butterflies."""
    d = dc.to(torch.int32)
    cols = _hadamard4_1d(*(d[:, i, :] for i in range(4)))     # over rows
    f = torch.stack(cols, dim=1)
    rows = _hadamard4_1d(*(f[:, :, j] for j in range(4)))     # over cols
    return torch.stack(rows, dim=2)


def chroma_dc_2x2(dc: torch.Tensor) -> torch.Tensor:
    """2x2 chroma DC transform (spec 8.5.11) on the (..., 4) raster DC
    levels [a, b, c, d] -> (..., 4) [f00, f01, f10, f11]."""
    a, b, c, d = (dc[..., k] for k in range(4))
    return torch.stack([a + b + c + d, a - b + c - d,
                        a + b - c - d, a - b - c + d], dim=-1)


@functools.lru_cache(maxsize=None)
def _idct8_matrix() -> np.ndarray:
    """T: the exact linear part of one idct8 pass (shifts treated as
    exact halving, which they are in the float model)."""
    T = np.zeros((8, 8))
    for k in range(8):
        dd = [np.array([1.0 if i == k else 0.0]) for i in range(8)]
        a0 = dd[0] + dd[4]
        a2 = dd[0] - dd[4]
        a4 = dd[2] / 2 - dd[6]
        a6 = dd[6] / 2 + dd[2]
        b0 = a0 + a6
        b2 = a2 + a4
        b4 = a2 - a4
        b6 = a0 - a6
        a1 = -dd[3] + dd[5] - dd[7] - dd[7] / 2
        a3 = dd[1] + dd[7] - dd[3] - dd[3] / 2
        a5 = -dd[1] + dd[7] + dd[5] + dd[5] / 2
        a7 = dd[3] + dd[5] + dd[1] + dd[1] / 2
        b1 = a7 / 4 + a1
        b3 = a3 + a5 / 4
        b5 = a3 / 4 - a5
        b7 = a7 - a1 / 4
        T[:, k] = [v[0] for v in (b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                                  b6 - b1, b4 - b3, b2 - b5, b0 - b7)]
    return T


@functools.lru_cache(maxsize=None)
def _fdct8_matrix() -> np.ndarray:
    """F = 8 * T^-1, so the encoder target d* = (F X F^T) / 64 feeds the
    normative inverse with r = (T d T^T)/64 ~= X."""
    return np.linalg.inv(_idct8_matrix()) * 8.0


def fdct8x8_h264_ref(x: np.ndarray) -> np.ndarray:
    """Golden float64 forward 8x8 transform F X F^T."""
    M = _fdct8_matrix()
    return M @ x.astype(np.float64) @ M.T


def step8(qp: int, w=None) -> np.ndarray:
    """(8,8) float32 quantiser step of the 8x8 transform: LS8 * 2^(qp/6 -
    6), as the JAX encoder computes it."""
    ls8 = dequant8x8_tab(qp, w)
    return (ls8.astype(np.float64) * (2.0 ** (qp // 6 - 6))).astype(
        np.float32)


def _dot8_xla(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i x[..., i] * w[..., i] over the last axis (8) in the order of
    XLA's CPU dot: two interleaved FMA chains, acc_k = fma(x_{k+4},
    w_{k+4}, f32(x_k w_k)) for k = 0..3, then (acc_0 + acc_1) + (acc_2 +
    acc_3). The FMA is a float64 product, exact for float32 factors,
    added to the rounded product and rounded once to float32."""
    p = x.double() * w.double()
    acc = (p[..., :4].float().double() + p[..., 4:]).float()
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def fdct8x8_h264_xla(resid: torch.Tensor, qp: int,
                     with_coefficients: bool = False):
    """The JAX encoder's 8x8 forward transform and quantiser on (..., 8,
    8) residuals: round_half_even(einsum(F, X, F) * f32(1 / step8)) ->
    int32 levels (and the float32 coefficients first, with
    with_coefficients=True), with the float32 sums of `_dot8_xla`. XLA
    contracts the residual's rows first (T = F X) and its columns second
    (C = T F^T),
    and folds the division by the constant step into a multiply by its
    float32 reciprocal."""
    F8 = torch.as_tensor(_fdct8_matrix().astype(np.float32),
                         device=resid.device)
    x = resid.to(torch.float32)
    # T[..., k, j] = sum_i F[k, i] x[..., i, j]
    xt = x.transpose(-1, -2)                       # [..., j, i]
    t = _dot8_xla(xt[..., None, :, :], F8[:, None, :])  # [..., k, j]
    # C[..., k, l] = sum_j T[..., k, j] F[l, j]
    c = _dot8_xla(t[..., :, None, :], F8[None, :, :])   # [..., k, l]
    recip = torch.as_tensor(np.float32(1) / step8(qp), device=resid.device)
    lv = torch.round(c * recip).to(torch.int32)
    return (c, lv) if with_coefficients else lv
