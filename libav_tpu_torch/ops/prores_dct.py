"""ProRes 10-bit transforms (counterpart of `libav_tpu/ops/prores_dct.py`;
reference: libavcodec/simple_idct.c:222 ff_prores_idct — the BIT_DEPTH=10
simple_idct with in-transform dequant — and jfdctint_template.c
ff_jpeg_fdct_islow_10, the FDCT fdctdsp.c:31 picks for
bits_per_raw_sample==10, which proresenc.c uses).

The constants, `idct_matrix_int10`, `_jfdct_linear_forms`, `_jfdct_mats`
and the numpy goldens `prores_idct_ref` and `fdct10_ref` are the JAX
package's. `prores_idct` and `fdct10` are torch programs on the device of
their input, bit-exact to the goldens: each pass of the reference's
per-block butterflies is an exact integer linear form with one rounding
shift per output coefficient. The JAX programs compute each pass as an
int32 einsum that wraps; torch has no integer matmul on CUDA, and a
single product (a dequantised coefficient up to 2^15 times a matrix entry
up to 92,682) overflows int32, so each pass here is eight multiply-adds
in int64, wrapped to int32 where XLA's int32 sum wraps: after the bias is
added, before the shift.

10-bit simple_idct fixed point (simple_idct_template.c BIT_DEPTH==10):
  W[k] = round(2^16 * sqrt(2) * cos(k*pi/16)) with W4 = 65535 (not 65536),
  ROW_SHIFT=15 (+2 extra for ProRes), COL_SHIFT=20, DC_SHIFT=1.
jfdctint 10-bit (jfdctint_template.c): CONST_BITS=13, PASS1_BITS=1,
OUT_SHIFT=2 — output scaled 4x the orthonormal DCT-II (flat 512 block
-> DC 0x4000, the bias proresenc.c:365 subtracts).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRORES_BITS = 10
PRORES_BIAS = 1 << (PRORES_BITS - 1)          # 512
PRORES_CLIP_MIN = 1 << (PRORES_BITS - 8)      # 4
PRORES_CLIP_MAX = (1 << PRORES_BITS) - PRORES_CLIP_MIN - 1  # 1019

ROW_SHIFT10 = 15
COL_SHIFT10 = 20
DC_SHIFT10 = 1
PRORES_EXTRA_SHIFT = 2                         # ff_prores_idct row pass


def _wrap16(x):
    return ((x.astype(np.int64) + 0x8000) & 0xFFFF) - 0x8000


def _wrap32(x):
    return ((x.astype(np.int64) + 0x80000000) & 0xFFFFFFFF) - 0x80000000


@functools.lru_cache(maxsize=None)
def idct_matrix_int10() -> np.ndarray:
    """10-bit simple_idct effective matrix: same cosine table as the 8-bit
    one but at 2^16 scale, with the reference's W4=65535 substitution
    (simple_idct_template.c:46 '#define W4 65535')."""
    M = np.zeros((8, 8), dtype=np.int64)
    for x in range(8):
        for u in range(8):
            cu = 1.0 / math.sqrt(2) if u == 0 else 1.0
            v = (2 ** 16) * math.sqrt(2) * cu * math.cos(
                (2 * x + 1) * u * math.pi / 16)
            M[x, u] = math.floor(v + 0.5) if v >= 0 else -math.floor(-v + 0.5)
    M = np.where(M == 65536, 65535, np.where(M == -65536, -65535, M))
    return M


_COL_BIAS10 = 65535 * ((1 << (COL_SHIFT10 - 1)) // 65535)   # W4*((1<<19)/W4)


def prores_idct_ref(blocks: np.ndarray, qmat: np.ndarray) -> np.ndarray:
    """Golden reference for ff_prores_idct + proresdsp.c put_pixels:
    dequant (int16 wraparound), 10-bit rows with extra_shift=2 and the
    DC-only shortcut, 10-bit cols, then bias+clip to 10-bit unsigned.

    blocks: (..., 64) int in raster block order; qmat broadcastable
    (..., 64) int (already scaled by the slice scale factor, int16-wrapped
    like the reference's int16_t qmat_luma_scaled).  Returns (..., 8, 8)
    uint16."""
    M = idct_matrix_int10()
    x = _wrap16(np.asarray(blocks).astype(np.int64) *
                np.asarray(qmat).astype(np.int64))
    x = x.reshape(x.shape[:-1] + (8, 8))
    shift = ROW_SHIFT10 + PRORES_EXTRA_SHIFT
    y = _wrap32(np.einsum("...ij,kj->...ik", x, M)
                + (1 << (ROW_SHIFT10 - 1))) >> shift
    dc_only = (x[..., 1:] == 0).all(axis=-1)
    # DC_SHIFT - extra_shift = -1 -> temp = (dc >> 1) & 0xffff
    dc_row = _wrap16(x[..., 0] >> 1)
    y = np.where(dc_only[..., None], dc_row[..., None], y)
    y = _wrap16(y)
    z = _wrap32(np.einsum("ki,...ij->...kj", M, y)
                + _COL_BIAS10) >> COL_SHIFT10
    z = _wrap16(z)
    return np.clip(z + PRORES_BIAS, PRORES_CLIP_MIN,
                   PRORES_CLIP_MAX).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _idct_matrix(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idct_matrix_int10(), dtype=torch.int64) \
        .to(device)


def _t_wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _t_wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def prores_idct(blocks: torch.Tensor, qmat: torch.Tensor) -> torch.Tensor:
    """blocks (B, 64) int, qmat (B, 64) or (64,) int, on one device ->
    (B, 8, 8) int32 samples in [4, 1019], equal to prores_idct_ref (which
    gives them as uint16)."""
    M = _idct_matrix(blocks.device)
    x = _t_wrap16(blocks.to(torch.int64) * qmat.to(torch.int64))
    x = x.reshape(-1, 8, 8)
    shift = ROW_SHIFT10 + PRORES_EXTRA_SHIFT
    # rows: y[b, i, k] = sum_j x[b, i, j] * M[k, j]
    y = sum(x[..., j, None] * M[:, j] for j in range(8))
    y = _t_wrap32(y + (1 << (ROW_SHIFT10 - 1))) >> shift
    dc_only = (x[..., 1:] == 0).all(dim=-1)
    dc_row = _t_wrap16(x[..., 0] >> 1)
    y = _t_wrap16(torch.where(dc_only[..., None], dc_row[..., None], y))
    # cols: z[b, k, j] = sum_i M[k, i] * y[b, i, j]
    z = sum(M[:, i, None] * y[..., i, None, :] for i in range(8))
    z = _t_wrap16(_t_wrap32(z + _COL_BIAS10) >> COL_SHIFT10)
    return (z + PRORES_BIAS).clamp(PRORES_CLIP_MIN, PRORES_CLIP_MAX) \
        .to(torch.int32)


# ---------------------------------------------------------------------- #
# jfdctint 10-bit forward DCT (jfdctint_template.c, CONST_BITS=13,
# PASS1_BITS=1, OUT_SHIFT=2)
# ---------------------------------------------------------------------- #

_FIX = {
    "0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
    "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
    "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
    "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172,
}

CONST_BITS = 13
PASS1_BITS = 1
OUT_SHIFT = 2


def _jfdct_linear_forms():
    """Evaluate one jfdctint 1-D pass symbolically: each input x_j is the
    j-th unit vector of an 8-dim integer space, so every intermediate is
    its exact integer-coefficient linear form and each output's pre-shift
    form pops out as a matrix row (the rounding shift is applied once per
    output, after full accumulation — exactly the C's DESCALE placement).

    Returns A (8, 8) int64 with rows in output-coefficient order: out_k is
    DESCALE(A[k] . x, shift_k) for k not in {0, 4}, and (A[k] . x) for
    k in {0, 4} (row pass scales those by 2^PASS1_BITS inside A, the col
    pass DESCALEs them by OUT_SHIFT — see the per-pass wrappers)."""
    e = np.eye(8, dtype=np.int64)
    x = [e[j] for j in range(8)]
    F = _FIX
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0] = tmp10 + tmp11
    out[4] = tmp10 - tmp11
    z1 = (tmp12 + tmp13) * F["0_541196100"]
    out[2] = z1 + tmp13 * F["0_765366865"]
    out[6] = z1 - tmp12 * F["1_847759065"]
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * F["1_175875602"]
    t4 = tmp4 * F["0_298631336"]
    t5 = tmp5 * F["2_053119869"]
    t6 = tmp6 * F["3_072711026"]
    t7 = tmp7 * F["1_501321110"]
    z1 = z1 * -F["0_899976223"]
    z2 = z2 * -F["2_562915447"]
    z3 = z3 * -F["1_961570560"]
    z4 = z4 * -F["0_390180644"]
    z3 = z3 + z5
    z4 = z4 + z5
    out[7] = t4 + z1 + z3
    out[5] = t5 + z2 + z4
    out[3] = t6 + z2 + z3
    out[1] = t7 + z1 + z4
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _jfdct_mats():
    A = _jfdct_linear_forms()
    even = np.array([1 if k in (0, 4) else 0 for k in range(8)], bool)
    # row pass: out{0,4} = L << PASS1_BITS (exact); others
    # DESCALE(L, CONST_BITS - PASS1_BITS)
    row_A = A.copy()
    row_A[even] <<= PASS1_BITS
    row_shift = np.where(even, 0, CONST_BITS - PASS1_BITS)
    row_bias = np.where(even, 0, 1 << (CONST_BITS - PASS1_BITS - 1))
    # col pass: out{0,4} = DESCALE(L, OUT_SHIFT); others
    # DESCALE(L, CONST_BITS + OUT_SHIFT)
    col_shift = np.where(even, OUT_SHIFT, CONST_BITS + OUT_SHIFT)
    col_bias = (1 << (col_shift - 1)).astype(np.int64)
    return (row_A, row_shift.astype(np.int64), row_bias.astype(np.int64),
            A, col_shift.astype(np.int64), col_bias)


def fdct10_ref(blocks: np.ndarray) -> np.ndarray:
    """Golden ff_jpeg_fdct_islow_10: (..., 8, 8) int pixel blocks (raw
    unsigned 10-bit samples, as proresenc.c:1123 feeds them) ->
    (..., 8, 8) int16 coefficients scaled 4x orthonormal."""
    row_A, row_s, row_b, col_A, col_s, col_b = _jfdct_mats()
    x = np.asarray(blocks).astype(np.int64)
    # rows: data[k] = (int16_t) form
    y = np.einsum("kj,...ij->...ik", row_A, x)
    y = _wrap16((y + row_b) >> row_s)
    # cols (bias/shift vary with the output coefficient k, axis -2)
    z = np.einsum("kj,...ji->...ki", col_A, y)
    z = _wrap16((z + col_b[:, None]) >> col_s[:, None])
    return z.astype(np.int16)


@functools.lru_cache(maxsize=None)
def _fdct_consts(device: torch.device):
    row_A, row_s, row_b, col_A, col_s, col_b = _jfdct_mats()
    return tuple(torch.as_tensor(a, dtype=torch.int64).to(device)
                 for a in (row_A, row_s, row_b, col_A, col_s[:, None],
                           col_b[:, None]))


def fdct10(blocks: torch.Tensor) -> torch.Tensor:
    """ff_jpeg_fdct_islow_10 on (B, 8, 8) int samples -> (B, 8, 8) int32
    (int16-valued), equal to fdct10_ref."""
    rA, rs, rb, cA, cs, cb = _fdct_consts(blocks.device)
    x = blocks.to(torch.int64)
    # rows: y[b, i, k] = sum_j rA[k, j] x[b, i, j]
    y = sum(x[..., j, None] * rA[:, j] for j in range(8))
    y = _t_wrap16(_t_wrap32(y + rb) >> rs)
    # cols (bias and shift by output coefficient k, axis -2):
    # z[b, k, i] = sum_j cA[k, j] y[b, j, i]
    z = sum(cA[:, j, None] * y[..., j, None, :] for j in range(8))
    z = _t_wrap16(_t_wrap32(z + cb) >> cs)
    return z.to(torch.int32)
