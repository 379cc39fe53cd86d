"""Batched exact 8x8 forward DCT (counterpart of `libav_tpu/ops/fdct.py`
fdct8x8_int, fdct8x8_int_ref and fdct_matrix_int; reference:
jfdctint_template.c, the `-dct fastint` integer FDCT).

One constant 8x8 integer matrix D (the transpose of the IDCT matrix of
ops/idct.py) applied to every block in two passes, each rounded and
shifted by 14 bits, so the output is 8x the orthonormal DCT-II, as the
quantisers expect:

    y = (D @ x + 2^13) >> 14        z = (y @ D^T + 2^13) >> 14

torch has no integer matmul on CUDA, so each pass is eight multiply-adds,
as in `idct8x8_int_plain`. int32 holds both passes without wrapping for
the encoders' inputs (pixels 0..255 or residuals in +-255): the first
pass stays under 8 * 255 * 22,725 ~ 4.6e7, the second under
8 * 2,834 * 22,725 ~ 5.2e8.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libav_tpu_torch.ops.idct import idct_matrix_int

FDCT_ROW_SHIFT = 14
FDCT_COL_SHIFT = 14


def fdct_matrix_int() -> np.ndarray:
    return idct_matrix_int().T.copy()


def fdct8x8_int_ref(blocks: np.ndarray) -> np.ndarray:
    """Golden reference. blocks: (..., 8, 8) int (pixel-domain, signed)."""
    D = fdct_matrix_int().astype(np.int64)
    x = blocks.astype(np.int64)
    y = np.einsum("ki,...ij->...kj", D, x) + (1 << (FDCT_ROW_SHIFT - 1))
    y >>= FDCT_ROW_SHIFT
    z = np.einsum("...ij,kj->...ik", y, D) + (1 << (FDCT_COL_SHIFT - 1))
    z >>= FDCT_COL_SHIFT
    return z.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _matrix(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fdct_matrix_int(), dtype=torch.int32).to(device)


def fdct8x8_int(blocks: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) int -> (B, 8, 8) int32, equal to fdct8x8_int_ref."""
    D = _matrix(blocks.device)
    x = blocks.to(torch.int32)
    # y[b, k, j] = sum_i D[k, i] x[b, i, j]
    y = sum(D[:, i, None] * x[..., i, None, :] for i in range(8))
    y = (y + (1 << (FDCT_ROW_SHIFT - 1))) >> FDCT_ROW_SHIFT
    # z[b, i, k] = sum_j y[b, i, j] D[k, j]
    z = sum(y[..., j, None] * D[:, j] for j in range(8))
    return (z + (1 << (FDCT_COL_SHIFT - 1))) >> FDCT_COL_SHIFT
