"""H.264 inverse transforms (counterpart of `libav_tpu/ops/h264transform.py`
idct4x4, idct8x8_h264 and the DC transforms that `codecs/h264/device.py`
runs inline; spec ISO 14496-10 §8.5).

All exact int32 with two's-complement wrap, as in the JAX package. The
luma DC Hadamard is written as butterflies: CUDA has no int32 matmul, and
the JAX einsum with preferred_element_type=int32 has no torch counterpart
on the card.
"""

from __future__ import annotations

import torch


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
