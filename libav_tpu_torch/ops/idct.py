"""Bit-exact 8x8 inverse DCT, `-idct simple` (counterpart of
`libav_tpu/ops/idct.py` idct8x8_int, its Pallas kernel
`_idct8x8_int_pallas`, idct_put and idct_add; reference:
simple_idct_template.c, BIT_DEPTH 8).

Kernel K2 is `csrc/mpv_idct.cu`. The plain PyTorch version beside it,
`idct8x8_int_plain`, is the JAX package's formula:

    x = wrap16(blocks)
    rows: y = wrap16((x @ M^T + 2^(ROW_SHIFT-1)) >> ROW_SHIFT), or
          wrap16(x0 << 3) for a row whose AC coefficients are all zero
    cols: z = (M @ y + _COL_BIAS) >> COL_SHIFT

with both sums wrapping in int32, as the C accumulates. torch has no
integer matmul on CUDA, and torch.sum of int32 widens to int64 and so
never wraps: the sums are eight multiply-adds in int64, then wrapped to
int32 explicitly. `>>` on a negative integer tensor is arithmetic.

`idct8x8_int` runs the plain version for a tensor on the CPU, launches
the kernel for a tensor on a CUDA device, and raises for anything else:
there is no fallback and no size threshold.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from libav_tpu.ops.idct import (COL_SHIFT, ROW_SHIFT, _COL_BIAS,
                                simple_idct_matrix)
from libav_tpu_torch._kernels import (check_int32, library, ptr, raise_on,
                                      stream)


@functools.lru_cache(maxsize=None)
def _matrix(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(simple_idct_matrix(), dtype=torch.int64) \
        .to(device)


@functools.lru_cache(maxsize=None)
def kernel_constants() -> np.ndarray:
    """[M (64, row-major) | ROW_SHIFT | COL_SHIFT | _COL_BIAS] as int32,
    from the JAX package's numbers; the kernel takes them by value."""
    return np.concatenate([simple_idct_matrix().reshape(-1),
                           [ROW_SHIFT, COL_SHIFT, _COL_BIAS]]) \
        .astype(np.int32)


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def idct8x8_int_plain(blocks: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) int -> (B, 8, 8) int32, bit-exact to
    libav_tpu.ops.idct.idct8x8_int_ref."""
    M = _matrix(blocks.device)
    x = _wrap16(blocks.to(torch.int64))
    # rows: y[b, i, k] = sum_j x[b, i, j] * M[k, j]
    y = sum(x[..., j, None] * M[:, j] for j in range(8))
    y = _wrap32(y + (1 << (ROW_SHIFT - 1))) >> ROW_SHIFT
    dc_only = (x[..., 1:] == 0).all(dim=-1)
    dc_row = _wrap16(x[..., 0] << 3)
    y = _wrap16(torch.where(dc_only[..., None], dc_row[..., None], y))
    # cols: z[b, k, j] = sum_i M[k, i] * y[b, i, j]
    z = sum(M[:, i, None] * y[..., i, None, :] for i in range(8))
    z = _wrap32(z + _COL_BIAS) >> COL_SHIFT
    return z.to(torch.int32)


def idct8x8_int(blocks: torch.Tensor) -> torch.Tensor:
    """K2 on (B, 8, 8) int32 blocks -> (B, 8, 8) int32. CPU tensors take
    `idct8x8_int_plain`; CUDA tensors launch the kernel."""
    if blocks.device.type == "cpu":
        return idct8x8_int_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"idct8x8_int: no kernel for {blocks.device}")
    dev = blocks.device
    n = blocks.shape[0]
    check_int32("blocks", blocks, dev, (n, 8, 8))
    if blocks.data_ptr() % 16:
        raise ValueError("idct8x8_int: blocks must be 16-byte aligned")
    out = torch.empty_like(blocks)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = library().mpv_idct8x8(
            ptr(blocks), ptr(out), n,
            kernel_constants().ctypes.data_as(ctypes.c_void_p), stream(dev))
    raise_on(err, "idct8x8_int")
    idct8x8_int.launches += 1
    return out


idct8x8_int.launches = 0


def idct_put(blocks: torch.Tensor, bias: int = 0) -> torch.Tensor:
    """IDCT then clamp to uint8 (reference: idctdsp.c idct_put)."""
    z = idct8x8_int(blocks) + bias
    return z.clamp(0, 255).to(torch.uint8)


def idct_add(blocks: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """IDCT residual added to the prediction, clamped (reference:
    idctdsp.c add_pixels_clamped)."""
    z = idct8x8_int(blocks) + pred.to(torch.int32)
    return z.clamp(0, 255).to(torch.uint8)
