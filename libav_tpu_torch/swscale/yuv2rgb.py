"""Planar 8-bit YUV -> interleaved rgb24/bgr24, BT.601 (counterpart of
`libav_tpu/swscale/__init__.py` SwsContext._yuv_rgb_jit; reference:
libswscale/yuv2rgb.c coefficients).

The JAX package runs this as one XLA-fused float32 elementwise program,
and its bytes are the bar. Kernel `sws_yuv2rgb` (`csrc/sws_yuv2rgb.cu`)
is one launch per frame on the card; `yuv2rgb_plain` is its PyTorch
twin. Both follow the rounding steps of XLA's CPU code for that program,
which contracts some multiply-adds into FMAs. With ys = y - oy, uc = u -
128, vc = v - 128 (all exact) and every product or sum outside an fma
rounded to float32:

    rb_form 0:  r = fma(ys, ky, kru*vc)          b = fma(ys, ky, kbv*uc)
    rb_form 1:  r = fma(kru, vc, ys*ky)          b = fma(kbv, uc, ys*ky)
    g_form 0:   g = fma(ys, ky, kgu*uc) + kgv*vc
    g_form 1:   g = fma(kgv, vc, fma(kgu, uc, ys*ky))
    g_form 2:   g = fma(kgv, vc, fma(ys, ky, kgu*uc))

then round half to even and clip to [0, 255]. In full range ky is 1, so
rb_form 0 is the unfused ys + kbv*uc there.

Which form XLA takes depends on the format, the range and the width
(`forms`), read from its object code (jax 0.9.0, XLA_FLAGS=
--xla_dump_to): the fusion writes r, g and b in three loops over the
pixels of a row, and LLVM unrolls the r and b loops by the largest of 3,
2 and 1 that divides the width, the g loop by 2 or 1. With horizontally
subsampled chroma an even unroll puts two pixels of one chroma sample in
one iteration: the code generator merges their chroma products, a
product with two uses is not contracted, and the luma product is fused
instead (forms 0). Otherwise the first product of each add is fused
(rb_form 1; g_form 1 in full range, where XLA's ys*ky is no product at
all, and 2 in limited range). Checked on XLA's outputs, 0 differing
bytes, at 1920x1080, 1920x1088, 1280x720, 640x480, 241x135, 135x241,
53x37, 37x53, 71x97, 97x71 and widths 33-35, 44, 50, 62, 66, 176, 854,
960, 1000 and 1366, for 4:2:0, 4:2:2 and 4:4:4 in both ranges.

The wrapper `yuv2rgb` runs the plain version for planes on the CPU,
launches the kernel for planes on a CUDA device, and raises for anything
else: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from libav_tpu_torch._kernels import (count_launch, library, ptr,
                                      raise_on, stream)


class _Consts(ctypes.Structure):
    _fields_ = [("ky", ctypes.c_float), ("oy", ctypes.c_float),
                ("kru", ctypes.c_float), ("kgu", ctypes.c_float),
                ("kgv", ctypes.c_float), ("kbv", ctypes.c_float),
                ("rb_form", ctypes.c_int), ("g_form", ctypes.c_int)]


def constants(full_range: bool) -> Tuple[float, ...]:
    """(ky, oy, kru, kgu, kgv, kbv) as the JAX program has them: float64
    Python numbers that meet float32 planes and so act as float32."""
    if full_range:
        k = (1.0, 0.0, 1.402, -0.344136, -0.714136, 1.772)
    else:
        k = (255.0 / 219.0, 16.0, 1.402 * 255 / 224,
             -0.344136 * 255 / 224, -0.714136 * 255 / 224,
             1.772 * 255 / 224)
    return tuple(float(np.float32(x)) for x in k)


def forms(sub_w: int, sub_h: int, full_range: bool,
          shape: Tuple[int, int]) -> Tuple[int, int]:
    """(rb_form, g_form) of XLA's rounding for this format, range and
    (H, W) shape; only the width and the horizontal subsampling count
    (see the module's note)."""
    w = shape[1]
    rb_unroll = 3 if w % 3 == 0 else (2 if w % 2 == 0 else 1)
    rb_shared = sub_w and rb_unroll % 2 == 0
    g_shared = sub_w and w % 2 == 0
    return (0 if rb_shared else 1,
            0 if g_shared else (1 if full_range else 2))


def fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """float32 a*b+c with one rounding (c a float32 tensor or a float32
    value): the product of two float32 values is exact in float64, then
    one float64 add, then a cast to float32. That rounds twice where a
    true FMA rounds once, but on every input of every step of this
    module's and `_rgb2yuv`'s rules (2^24 each) it equals a correctly
    rounded FMA (tests/test_torch_swscale.py)."""
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * float(b) + c).float()


def yuv2rgb_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  sub_w: int, sub_h: int, full_range: bool,
                  bgr: bool = False) -> torch.Tensor:
    """uint8 planes Y (H, W), U and V (ceil(H / 2^sub_h), ceil(W /
    2^sub_w)) -> uint8 (H, 3W) rgb24, or bgr24 when bgr."""
    h, w = y.shape
    ky, oy, kru, kgu, kgv, kbv = constants(full_range)
    rb_form, g_form = forms(sub_w, sub_h, full_range, (h, w))
    rows = torch.arange(h, device=y.device) >> sub_h
    cols = torch.arange(w, device=y.device) >> sub_w
    ys = y.float() - oy
    uc = (u.float() - 128.0)[rows][:, cols]
    vc = (v.float() - 128.0)[rows][:, cols]
    yf = ys * ky
    if rb_form == 0:
        r = fma(ys, ky, kru * vc)
        b = fma(ys, ky, kbv * uc)
    else:
        r = fma(vc, kru, yf)
        b = fma(uc, kbv, yf)
    if g_form == 0:
        g = fma(ys, ky, kgu * uc) + kgv * vc
    elif g_form == 1:
        g = fma(vc, kgv, fma(uc, kgu, yf))
    else:
        g = fma(vc, kgv, fma(ys, ky, kgu * uc))
    chans = (b, g, r) if bgr else (r, g, b)
    rgb = torch.stack(chans, dim=-1).round().clamp(0, 255)
    return rgb.to(torch.uint8).reshape(h, 3 * w)


def _check_plane(name: str, t: torch.Tensor, device: torch.device,
                 shape) -> None:
    if t.device != device or t.dtype != torch.uint8 or t.dim() != 2 or \
            t.stride(1) != 1:
        raise ValueError(f"yuv2rgb: {name} must be a uint8 plane with "
                         f"unit column stride on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"yuv2rgb: {name} has shape {tuple(t.shape)}, "
                         f"need {tuple(shape)}")


def yuv2rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            sub_w: int, sub_h: int, full_range: bool,
            bgr: bool = False) -> torch.Tensor:
    """`sws_yuv2rgb` on uint8 planes -> (H, 3W) uint8 rgb24 or bgr24.
    CPU planes take `yuv2rgb_plain`; CUDA planes launch the kernel, one
    launch per frame."""
    if y.device.type == "cpu":
        return yuv2rgb_plain(y, u, v, sub_w, sub_h, full_range, bgr)
    if y.device.type != "cuda":
        raise ValueError(f"yuv2rgb: no kernel for {y.device}")
    dev = y.device
    h, w = y.shape
    cshape = (-(-h >> sub_h), -(-w >> sub_w))
    _check_plane("Y", y, dev, (h, w))
    _check_plane("U", u, dev, cshape)
    _check_plane("V", v, dev, cshape)
    out = torch.empty((h, 3 * w), dtype=torch.uint8, device=dev)
    if h == 0 or w == 0:
        return out
    consts = _Consts(*constants(full_range),
                     *forms(sub_w, sub_h, full_range, (h, w)))
    with torch.cuda.device(dev):
        err = library().sws_yuv2rgb(
            ptr(y), ptr(u), ptr(v), ptr(out), w, h, y.stride(0),
            u.stride(0), v.stride(0), sub_w, sub_h, int(bgr),
            ctypes.cast(ctypes.pointer(consts), ctypes.c_void_p),
            stream(dev))
    raise_on(err, "yuv2rgb")
    count_launch(yuv2rgb)
    return out


yuv2rgb.launches = 0
