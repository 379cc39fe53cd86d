"""Reference-bit-exact planar scaler (the semantics of libswscale's C
scalar path with SWS_BITEXACT | SWS_ACCURATE_RND: utils.c initFilter
coefficient construction, swscale.c hScale8To15_c horizontal pass,
output.c yuv2planeX_8_c / yuv2plane1_8_c vertical pass with the
constant 64 dither of the bitexact mode).

Filter tables build on host (pure integer per the reference's int64
fixed-point recipe); the two scaling passes run as one torch program on
the plane's device (counterpart of the JAX package's `scale_plane_jit`:
an integer gather and weighted sum per axis). Integer arithmetic, so the
port's output equals the JAX program's exactly, on any device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

FONE = 1 << 54
MAX_REDUCE_CUTOFF = 0.002

# flag names (subset of swscale.h)
BILINEAR, BICUBIC, X_, POINT, AREA, BICUBLIN, GAUSS, SINC, LANCZOS, \
    SPLINE = ("bilinear", "bicubic", "experimental", "neighbor", "area",
              "bicublin", "gauss", "sinc", "lanczos", "spline")


def _rounded_div(a: int, b: int) -> int:
    """C ROUNDED_DIV semantics: truncation toward zero (b > 0)."""
    if a > 0:
        return (a + (b >> 1)) // b
    return -((-a + (b >> 1)) // b)


def _spline(a, b, c, d, dist):
    """utils.c getSplineCoeff recursion, verbatim."""
    if dist <= 1.0:
        return ((d * dist + c) * dist + b) * dist + a
    return _spline(0.0, b + 2.0 * c + 3.0 * d, c + 3.0 * d,
                   -b - 3.0 * c - 6.0 * d, dist - 1.0)


def init_filter(x_inc: int, src_w: int, dst_w: int, one: int,
                algo: str, is_horizontal: bool):
    """Port of utils.c initFilter (scalar path: filterAlign 1, no
    src/dst vectors). Returns (filter int16 (dst_w, size), pos int32
    (dst_w,), size)."""
    pos = np.zeros(dst_w, np.int64)
    if abs(x_inc - 0x10000) < 10:                      # unscaled
        fsize = 1
        filt = np.full((dst_w, 1), FONE, dtype=object)
        pos[:] = np.arange(dst_w)
    elif algo == POINT:
        fsize = 1
        filt = np.full((dst_w, 1), FONE, dtype=object)
        xdst = x_inc // 2 - 0x8000
        for i in range(dst_w):
            pos[i] = (xdst - ((fsize - 1) << 15) + (1 << 15)) >> 16
            xdst += x_inc
    elif (x_inc <= (1 << 16) and algo == AREA) or algo == "fast_bilinear":
        fsize = 2
        filt = np.zeros((dst_w, 2), dtype=object)
        xdst = x_inc // 2 - 0x8000
        for i in range(dst_w):
            xx = (xdst - ((fsize - 1) << 15) + (1 << 15)) >> 16
            pos[i] = xx
            for j in range(fsize):
                coeff = FONE - abs((xx << 16) - xdst) * (FONE >> 16)
                filt[i, j] = max(coeff, 0)
                xx += 1
            xdst += x_inc
    else:
        size_factor = {BICUBIC: 4, X_: 8, AREA: 1, GAUSS: 8, SINC: 20,
                       LANCZOS: 6, SPLINE: 20, BILINEAR: 2}[algo]
        if x_inc <= 1 << 16:
            fsize = 1 + size_factor
        else:
            fsize = 1 + (size_factor * src_w + dst_w - 1) // dst_w
        fsize = max(min(fsize, src_w - 2), 1)
        filt = np.zeros((dst_w, fsize), dtype=object)
        xdst = x_inc - 0x10000
        for i in range(dst_w):
            num = xdst - ((fsize - 2) << 16)
            xx = num // (1 << 17) if num >= 0 \
                else -((-num) // (1 << 17))     # C trunc division
            pos[i] = xx
            for j in range(fsize):
                d = abs((xx << 17) - xdst) << 13
                if x_inc > 1 << 16:
                    d = d * dst_w // src_w
                floatd = d * (1.0 / (1 << 30))
                if algo == BICUBIC:
                    B = 0
                    C = int(0.6 * (1 << 24))
                    if d >= 1 << 31:
                        coeff = 0
                    else:
                        dd = (d * d) >> 30
                        ddd = (dd * d) >> 30
                        if d < 1 << 30:
                            coeff = ((12 * (1 << 24) - 9 * B - 6 * C)
                                     * ddd +
                                     (-18 * (1 << 24) + 12 * B + 6 * C)
                                     * dd +
                                     (6 * (1 << 24) - 2 * B) * (1 << 30))
                        else:
                            coeff = ((-B - 6 * C) * ddd +
                                     (6 * B + 30 * C) * dd +
                                     (-12 * B - 48 * C) * d +
                                     (8 * B + 24 * C) * (1 << 30))
                    coeff *= FONE >> (30 + 24)
                elif algo == AREA:
                    d2 = d - (1 << 29)
                    if d2 * x_inc < -(1 << (29 + 16)):
                        coeff = 1 << (30 + 16)
                    elif d2 * x_inc < (1 << (29 + 16)):
                        coeff = -d2 * x_inc + (1 << (29 + 16))
                    else:
                        coeff = 0
                    coeff *= FONE >> (30 + 16)
                elif algo == GAUSS:
                    coeff = int((2.0 ** (-3.0 * floatd * floatd)) * FONE)
                elif algo == SINC:
                    coeff = int((math.sin(floatd * math.pi) /
                                 (floatd * math.pi) if d else 1.0) * FONE)
                elif algo == LANCZOS:
                    p = 3.0
                    coeff = int((math.sin(floatd * math.pi) *
                                 math.sin(floatd * math.pi / p) /
                                 (floatd * floatd * math.pi * math.pi / p)
                                 if d else 1.0) * FONE)
                    if floatd > p:
                        coeff = 0
                elif algo == BILINEAR:
                    coeff = (1 << 30) - d
                    if coeff < 0:
                        coeff = 0
                    coeff *= FONE >> 30
                elif algo == SPLINE:
                    pp = -2.196152422706632
                    coeff = int(_spline(1.0, 0.0, pp, -pp - 1.0, floatd)
                                * FONE)
                elif algo == X_:
                    c = (math.cos(floatd * math.pi) if floatd < 1.0
                         else -1.0)
                    c = -((-c) ** 1.0) if c < 0.0 else c ** 1.0
                    coeff = int((c * 0.5 + 0.5) * FONE)
                else:
                    raise ValueError(algo)
                filt[i, j] = int(coeff)
                xx += 1
            xdst += 2 * x_inc

    fsize = filt.shape[1]
    f2 = [list(filt[i]) for i in range(dst_w)]
    f2size = fsize

    # reduce: shift near-zero leading coefficients left, count trailing
    min_fsize = 0
    for i in range(dst_w - 1, -1, -1):
        mn = f2size
        cut = 0
        for j in range(f2size):
            cut += abs(f2[i][0])
            if cut > MAX_REDUCE_CUTOFF * FONE:
                break
            if i < dst_w - 1 and pos[i] >= pos[i + 1]:
                break
            f2[i] = f2[i][1:] + [0]
            pos[i] += 1
        cut = 0
        for j in range(f2size - 1, 0, -1):
            cut += abs(f2[i][j])
            if cut > MAX_REDUCE_CUTOFF * FONE:
                break
            mn -= 1
        if mn > min_fsize:
            min_fsize = mn

    fsize = min_fsize            # filterAlign = 1
    out = np.zeros((dst_w, fsize), dtype=object)
    for i in range(dst_w):
        for j in range(fsize):
            out[i, j] = f2[i][j] if j < f2size else 0
            # SWS_BITEXACT zeroes j >= minFilterSize — fsize == min here

    # fix borders (horizontal only)
    if is_horizontal:
        for i in range(dst_w):
            if pos[i] < 0:
                for j in range(1, fsize):
                    left = max(j + pos[i], 0)
                    out[i, left] += out[i, j]
                    out[i, j] = 0
                pos[i] = 0
            if pos[i] + fsize > src_w:
                shift = pos[i] + fsize - src_w
                for j in range(fsize - 2, -1, -1):
                    right = min(j + shift, fsize - 1)
                    out[i, right] += out[i, j]
                    out[i, j] = 0
                pos[i] = src_w - fsize

    # normalize to `one` with error diffusion
    res = np.zeros((dst_w, fsize), np.int16)
    for i in range(dst_w):
        s = sum(int(v) for v in out[i])
        s = (s + one // 2) // one
        err = 0
        for j in range(fsize):
            v = int(out[i, j]) + err
            iv = _rounded_div(v, s)
            res[i, j] = iv
            err = v - iv * s
    return res, pos.astype(np.int32), fsize


def _x_inc(src: int, dst: int) -> int:
    return ((src << 16) + (dst >> 1)) // dst


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value XLA's wrapping int32 sum gives."""
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


class PlaneScaler:
    """Bit-exact plane scaler on one device: uint8 (src_h, src_w) ->
    uint8 (dst_h, dst_w), identical to the reference's hScale8To15 +
    yuv2planeX/1 bitexact chain (the JAX package's `scale_plane_jit`).
    The filters and gather indices are built on the host once and kept
    on the device; sums are taken in int64 and wrapped to int32 as the
    JAX program's int32 sums wrap."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int,
                 algo: str, device: torch.device):
        hf, hpos, hsize = init_filter(_x_inc(src_w, dst_w), src_w, dst_w,
                                      1 << 14, algo, True)
        vf, vpos, vsize = init_filter(_x_inc(src_h, dst_h), src_h, dst_h,
                                      1 << 12, algo, False)
        # gather indices: (dst_w, hsize) source columns and (dst_h,
        # vsize) source rows; the vertical ones are clipped as the
        # reference's line ring repeats the last line
        hidx = (hpos[:, None] + np.arange(hsize)[None, :]).clip(0, src_w - 1)
        vidx = (vpos[:, None] + np.arange(vsize)[None, :]).clip(0, src_h - 1)
        as_t = functools.partial(torch.as_tensor, dtype=torch.int64,
                                 device=device)
        self.hidx, self.hf = as_t(hidx), as_t(hf.astype(np.int64))
        self.vidx, self.vf = as_t(vidx), as_t(vf.astype(np.int64))
        self.vsize = vsize

    def __call__(self, plane: torch.Tensor) -> torch.Tensor:
        p = plane.to(torch.int64)
        # horizontal: (src_h, dst_w, hsize) gather then weighted sum
        hsum = _wrap32((p[:, self.hidx] * self.hf[None]).sum(dim=2))
        inter = torch.clamp(hsum >> 7, max=(1 << 15) - 1)   # 15-bit rows
        gv = inter[self.vidx]                              # (dst_h,vs,dst_w)
        if self.vsize == 1:
            # the reference uses yuv2plane1 whenever vFilterSize == 1
            out = (gv[:, 0, :] + 64) >> 7
        else:
            vsum = _wrap32((gv * self.vf[:, :, None]).sum(dim=1) +
                           (64 << 12))
            out = vsum >> 19
        return out.clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def scale_plane(src_w: int, src_h: int, dst_w: int, dst_h: int,
                algo: str, device) -> PlaneScaler:
    """The bit-exact plane scaler for these sizes on `device` (the caller
    names it: "cpu" or a CUDA device), built once."""
    return PlaneScaler(src_w, src_h, dst_w, dst_h, algo,
                       torch.device(device))


def scale_yuv420_bitexact(planes, dst_w: int, dst_h: int,
                          algo: str = BICUBIC):
    """Scale a yuv420p frame's planes (uint8 tensors on one device)
    bit-exactly like the reference's SWS_BITEXACT path (luma +
    ceil-halved chroma geometry)."""
    src_h, src_w = planes[0].shape
    cw_s, ch_s = (src_w + 1) // 2, (src_h + 1) // 2
    cw_d, ch_d = (dst_w + 1) // 2, (dst_h + 1) // 2
    dev = planes[0].device
    fy = scale_plane(src_w, src_h, dst_w, dst_h, algo, dev)
    fc = scale_plane(cw_s, ch_s, cw_d, ch_d, algo, dev)
    return [fy(planes[0]), fc(planes[1]), fc(planes[2])]
