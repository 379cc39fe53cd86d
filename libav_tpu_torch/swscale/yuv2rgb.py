"""Planar 8-bit YUV -> interleaved rgb24/bgr24, BT.601 (counterpart of
`libav_tpu/swscale/__init__.py` SwsContext._yuv_rgb_jit; reference:
libswscale/yuv2rgb.c coefficients).

The JAX package runs this as one XLA-fused float32 elementwise program,
and its bytes are the bar. Kernel `sws_yuv2rgb` (`csrc/sws_yuv2rgb.cu`)
is one launch per frame on the card; `yuv2rgb_plain` is its PyTorch
twin. Both follow the rounding steps of XLA's CPU code for that program,
which contracts some multiply-adds into FMAs (read from its object code
and checked on its outputs at 1920x1080; see the CUDA source):

    ys = y - oy, uc = u - 128, vc = v - 128      (exact)
    rb_form 0:  r = fma(ys, ky, kru*vc)          b = fma(ys, ky, kbv*uc)
    rb_form 1:  r = fma(kru, vc, ys*ky)          b = fma(kbv, uc, ys*ky)
    g_form 0:   g = fma(ys, ky, kgu*uc) + kgv*vc
    g_form 1:   g = fma(kgv, vc, fma(kgu, uc, ys*ky))

then round half to even and clip to [0, 255]. Limited range takes
rb_form 0, full range rb_form 1; g_form is 1 for full-range 4:4:4 only.
XLA chooses its contractions per shape, so at some other sizes its
output differs from these forms in a few hundred bytes per frame
(ROADMAP.md §3 records the counts).

The wrapper `yuv2rgb` runs the plain version for planes on the CPU,
launches the kernel for planes on a CUDA device, and raises for anything
else: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from libav_tpu_torch._kernels import library, ptr, raise_on, stream


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


def forms(sub_w: int, sub_h: int, full_range: bool) -> Tuple[int, int]:
    """(rb_form, g_form) of XLA's rounding for this format and range."""
    return int(full_range), int(full_range and not sub_w and not sub_h)


def fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """float32 a*b+c with one rounding (c a float32 tensor or a float32
    value): the product of two float32 values is exact in float64, then
    one float64 add, then a cast to float32. That rounds twice where a
    true FMA rounds once, and so could split a tie in principle; the
    outputs here hold against XLA's all the same."""
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
    rb_form, g_form = forms(sub_w, sub_h, full_range)
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
    else:
        g = fma(vc, kgv, fma(uc, kgu, yf))
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
    consts = _Consts(*constants(full_range), *forms(sub_w, sub_h,
                                                    full_range))
    with torch.cuda.device(dev):
        err = library().sws_yuv2rgb(
            ptr(y), ptr(u), ptr(v), ptr(out), w, h, y.stride(0),
            u.stride(0), v.stride(0), sub_w, sub_h, int(bgr),
            ctypes.cast(ctypes.pointer(consts), ctypes.c_void_p),
            stream(dev))
    raise_on(err, "yuv2rgb")
    yuv2rgb.launches += 1
    return out


yuv2rgb.launches = 0
