"""Vector float primitives (reference: libavutil/float_dsp.c
AVFloatDSPContext — vector_fmul, vector_fmac_scalar, scalarproduct,
butterflies; and libavcodec/audiodsp.* vector_clip).

Counterpart of `libav_tpu/ops/float_dsp.py`: the same named entry points
as torch programs on their operands' device. The elementwise ones round
each float32 operation once, as XLA's do, so they equal the JAX ops
exactly; `scalarproduct` sums in torch's order, which is not XLA's (a
few float32 ulps of the sum apart). No codec of either package calls
them.
"""

from __future__ import annotations

import torch


def vector_fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """reference: float_dsp.h vector_fmul"""
    return a * b


def vector_fmac_scalar(dst: torch.Tensor, src: torch.Tensor,
                       mul: float) -> torch.Tensor:
    """dst += src * mul"""
    return dst + src * mul


def vector_fmul_scalar(src: torch.Tensor, mul: float) -> torch.Tensor:
    return src * mul


def vector_fmul_add(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    return a * b + c


def vector_fmul_reverse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """reference: vector_fmul_reverse (window application)"""
    return a * b.flip(-1)


def vector_fmul_window(src0: torch.Tensor, src1: torch.Tensor,
                       win: torch.Tensor) -> torch.Tensor:
    """Windowed overlap butterfly (reference: vector_fmul_window):
    dst[i] = src0[i]*win[len-1-i] - src1[len-1-i]*win[i] and mirror."""
    n = win.shape[-1] // 2
    w0 = win[..., :n]
    w1 = win[..., n:]
    s1r = src1.flip(-1)
    left = src0 * w1.flip(-1) - s1r * w0
    right = (src0 * w0.flip(-1) + s1r * w1).flip(-1)
    return torch.cat([left, right], dim=-1)


def scalarproduct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """reference: scalarproduct_float / audiodsp scalarproduct_int16"""
    return (a * b).sum(dim=-1)


def butterflies(a: torch.Tensor, b: torch.Tensor):
    """reference: butterflies_float: (a+b, a-b)"""
    return a + b, a - b


def vector_clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """reference: audiodsp.h vector_clip_int32 / vector_clipf"""
    return x.clamp(lo, hi)
