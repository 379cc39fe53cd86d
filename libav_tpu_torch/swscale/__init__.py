"""Colorspace conversion and scaling (counterpart of
`libav_tpu/swscale/__init__.py`; reference: libswscale/ — SURVEY.md
§2.4: swscale.c:343 three-stage pipeline = horizontal FIR + vertical FIR +
pack, filter construction utils.c initFilter, yuv2rgb.c table codegen).

The JAX package's host code, copied; its device programs are the
port's. A context has a device, "cuda" unless the caller names another
(`device="cpu"` is the only way to run on the CPU); a frame's tensor
planes stay on their own device (a decoder's frames stay on its
device), its numpy planes are uploaded to the context's:
  - plane scaling (`-s`): the bit-exact integer scaler
    (`bitexact.PlaneScaler`), a torch program;
  - YUV -> RGB: kernel `sws_yuv2rgb` on the card, its plain version on
    the CPU (`yuv2rgb.py`), byte-equal to the JAX program;
  - RGB -> YUV: a torch program with XLA's rounding steps written out;
  - RGB -> RGB reorders and the pack/unpack layer (`packing.py`) run on
    the host, as in the JAX package; an RGB resize runs on the
    context's device.
Filters are built like initFilter: bilinear / bicubic / area / Lanczos
by flag, normalized to sum 1.

A SwsContext is cached per (src, dst, fmt, flags, device) — the
analogue of sws_getContext (swscale.h:176).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.pixfmt import pixdesc, plane_dims
from libav_tpu_torch.swscale import yuv2rgb as _y2r

# flags (reference: swscale.h SWS_*)
FAST_BILINEAR = 1
BILINEAR = 2
BICUBIC = 4
POINT = 0x10
AREA = 0x20
GAUSS = 0x80
SINC = 0x100
LANCZOS = 0x200
SPLINE = 0x400
ACCURATE_RND = 0x40000
BITEXACT = 0x80000


def build_filter(src_size: int, dst_size: int, flags: int = BICUBIC
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Build per-output-pixel (start_index, weights[taps]) — the same job
    as reference initFilter (libswscale/utils.c). Weights are float64,
    normalized to sum exactly 1 per output pixel."""
    scale = src_size / dst_size
    if flags & POINT:
        taps = 1
    elif flags & (BILINEAR | FAST_BILINEAR):
        taps = max(2, 2 * math.ceil(scale))
    elif flags & LANCZOS:
        taps = max(6, 2 * math.ceil(3 * scale))
    else:  # bicubic / area
        taps = max(4, 2 * math.ceil(2 * scale)) if not (flags & AREA) \
            else max(2, math.ceil(scale) + 1)
        if flags & AREA and scale <= 1:
            taps = 2

    pos = np.zeros(dst_size, dtype=np.int32)
    weights = np.zeros((dst_size, taps), dtype=np.float64)
    fscale = max(scale, 1.0)

    for d in range(dst_size):
        center = (d + 0.5) * scale - 0.5
        start = int(math.floor(center)) - taps // 2 + 1
        pos[d] = start
        for t in range(taps):
            x = (start + t - center) / fscale
            if flags & POINT:
                w = 1.0
            elif flags & (BILINEAR | FAST_BILINEAR):
                w = max(0.0, 1.0 - abs(x))
            elif flags & LANCZOS:
                a = 3.0
                if x == 0:
                    w = 1.0
                elif abs(x) >= a:
                    w = 0.0
                else:
                    px = math.pi * x
                    w = a * math.sin(px) * math.sin(px / a) / (px * px)
            elif flags & AREA:
                w = max(0.0, min(0.5, 0.5 + 0.5 * fscale - abs(x) * fscale) -
                        max(-0.5, -0.5 * fscale + abs(x) * fscale - 0.0)) \
                    if False else max(0.0, 1.0 - abs(x))
            else:  # bicubic (Catmull-Rom-like, B=0, C=0.6 as swscale default)
                B, C = 0.0, 0.6
                ax = abs(x)
                if ax < 1:
                    w = ((12 - 9 * B - 6 * C) * ax ** 3 +
                         (-18 + 12 * B + 6 * C) * ax ** 2 +
                         (6 - 2 * B)) / 6
                elif ax < 2:
                    w = ((-B - 6 * C) * ax ** 3 + (6 * B + 30 * C) * ax ** 2 +
                         (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6
                else:
                    w = 0.0
            weights[d, t] = w
        s = weights[d].sum()
        if s != 0:
            weights[d] /= s
        else:
            weights[d, taps // 2] = 1.0
    return pos, weights


def _scale_axis_np(plane: np.ndarray, pos: np.ndarray, weights: np.ndarray,
                   axis: int) -> np.ndarray:
    """Golden reference for the separable FIR scale step."""
    src = plane.astype(np.float64)
    dst_size, taps = weights.shape
    n = src.shape[axis]
    out = np.zeros((dst_size,) + tuple(s for i, s in enumerate(src.shape)
                                       if i != axis))
    src_m = np.moveaxis(src, axis, 0)
    acc = np.zeros((dst_size,) + src_m.shape[1:])
    for t in range(taps):
        idx = np.clip(pos + t, 0, n - 1)
        acc += src_m[idx] * weights[:, t].reshape(-1, *([1] * (src_m.ndim - 1)))
    return np.moveaxis(acc, 0, axis)


class SwsContext:
    """reference: swscale.h:176 sws_getContext / SwsContext."""

    _cache: Dict[tuple, "SwsContext"] = {}

    def __init__(self, src_w, src_h, src_fmt, dst_w, dst_h, dst_fmt,
                 flags=BICUBIC, device="cuda"):
        self.src = (src_w, src_h, src_fmt)
        self.dst = (dst_w, dst_h, dst_fmt)
        self.flags = flags
        self.device = hwdevice.device(device)

    @classmethod
    def get(cls, src_w, src_h, src_fmt, dst_w, dst_h, dst_fmt,
            flags=BICUBIC, device="cuda") -> "SwsContext":
        dev = hwdevice.device(device)
        key = (src_w, src_h, src_fmt, dst_w, dst_h, dst_fmt, flags, dev)
        if key not in cls._cache:
            cls._cache[key] = cls(*key[:6], flags=flags, device=dev)
        return cls._cache[key]

    # ------------------------------------------------------------------ #

    def scale_frame(self, frame: Frame) -> Frame:
        src_w, src_h, src_fmt = self.src
        dst_w, dst_h, dst_fmt = self.dst

        # pack/unpack layer: normalize non-canonical formats
        # (nv12/yuyv/gbrp/high-depth/...) to 8-bit planar/rgb24 first
        from libav_tpu_torch.swscale import packing as PK
        dev = _device_of(frame.planes, self.device)
        planes = [torch.as_tensor(p, device=dev) for p in frame.planes]
        if not PK.is_canonical(src_fmt):
            src_fmt, planes = PK.unpack(_host(planes), src_fmt, src_w,
                                        src_h)
            planes = [torch.as_tensor(p, device=dev) for p in planes]
        pack_to = None
        if not PK.is_canonical(dst_fmt):
            pack_to = dst_fmt
            dst_fmt = PK.canonical_of(dst_fmt)

        sf, df = _family(src_fmt), _family(dst_fmt)

        if sf == "yuv" and df == "yuv":
            out_planes = self._scale_yuv(planes, src_fmt, dst_fmt)
        elif sf == "yuv" and df == "rgb":
            out_planes = self._yuv_to_rgb(planes, src_fmt, dst_fmt, frame.color_range)
        elif sf == "rgb" and df == "yuv":
            out_planes = self._rgb_to_yuv(planes, src_fmt, dst_fmt)
        elif sf == "gray" or df == "gray":
            out_planes = self._scale_gray(planes, src_fmt, dst_fmt)
        elif sf == "rgb" and df == "rgb":
            out_planes = self._rgb_to_rgb(planes, src_fmt, dst_fmt)
        else:
            raise AVError(EINVAL, f"swscale: {src_fmt} -> {dst_fmt} unsupported")

        if pack_to is not None:
            out_planes = PK.pack(_host(out_planes), dst_fmt, pack_to,
                                 dst_w, dst_h)
            dst_fmt = pack_to
        out = frame.clone_props()
        out.width, out.height, out.format = dst_w, dst_h, dst_fmt
        out.planes = out_planes
        if df == "rgb":
            out.color_range = "pc"
        return out

    # ------------------------------------------------------------------ #

    # SWS_* flag -> bitexact-core algorithm name
    _ALGO_OF_FLAG = {BILINEAR: "bilinear", BICUBIC: "bicubic",
                     POINT: "neighbor", AREA: "area",
                     LANCZOS: "lanczos", GAUSS: "gauss", SINC: "sinc",
                     SPLINE: "spline"}

    def _plane_scaler(self, sh, sw, dh, dw, device):
        """Per-plane scaler: the reference-bit-exact fixed-point chain
        (swscale/bitexact.py — initFilter + hScale8To15 + yuv2planeX
        semantics), so `-s WxH` output equals the reference's
        SWS_BITEXACT|SWS_ACCURATE_RND path byte for byte."""
        from libav_tpu_torch.swscale.bitexact import scale_plane
        algo = "bicubic"
        for flag, name in self._ALGO_OF_FLAG.items():
            if self.flags & flag:
                algo = name
                break
        return scale_plane(sw, sh, dw, dh, algo, device)

    def _scale_yuv(self, planes, src_fmt, dst_fmt):
        src_w, src_h, _ = self.src
        dst_w, dst_h, _ = self.dst
        sdims = plane_dims(src_fmt, src_w, src_h)
        ddims = plane_dims(dst_fmt, dst_w, dst_h)
        out = []
        for p, (sw_, sh_), (dw_, dh_) in zip(planes, sdims, ddims):
            if (sh_, sw_) == (dh_, dw_):
                out.append(p)
                continue
            out.append(self._plane_scaler(sh_, sw_, dh_, dw_, p.device)(p))
        return out

    def _scale_gray(self, planes, src_fmt, dst_fmt):
        src_w, src_h, _ = self.src
        dst_w, dst_h, _ = self.dst
        arr = planes[0]
        if (src_h, src_w) != (dst_h, dst_w):
            arr = self._plane_scaler(src_h, src_w, dst_h, dst_w,
                                     arr.device)(arr)
        if dst_fmt == "gray":
            return [arr]
        # gray -> yuv: flat chroma
        dims = plane_dims(dst_fmt, dst_w, dst_h)
        return [arr] + [torch.full((h, w), 128, dtype=torch.uint8,
                                   device=arr.device)
                        for (w, h) in dims[1:]]

    def _yuv_to_rgb(self, planes, src_fmt, dst_fmt, color_range):
        """The JAX program `_yuv_rgb_jit`, as kernel `sws_yuv2rgb` on
        the card (one launch per frame) and its plain version on the
        CPU: `yuv2rgb.yuv2rgb` picks by the planes' device."""
        src_w, src_h, _ = self.src
        dst_w, dst_h, _ = self.dst
        if (src_w, src_h) != (dst_w, dst_h):
            raise AVError(EINVAL, "yuv->rgb with resize: resize separately")
        d = pixdesc(src_fmt)
        full = src_fmt.startswith("yuvj") or color_range == "pc"
        y, u, v = (p.contiguous() for p in planes[:3])
        return [_y2r.yuv2rgb(y, u, v, d.log2_chroma_w, d.log2_chroma_h,
                             full, bgr=dst_fmt == "bgr24")]

    def _rgb_to_yuv(self, planes, src_fmt, dst_fmt):
        """The JAX program of `_rgb_to_yuv` as a torch program, with the
        rounding steps of XLA's CPU code for it written out (`_rgb2yuv`)."""
        src_w, src_h, _ = self.src
        dst_w, dst_h, _ = self.dst
        if (src_w, src_h) != (dst_w, dst_h):
            raise AVError(EINVAL, "rgb->yuv with resize: resize separately")
        d = pixdesc(dst_fmt)
        return _rgb2yuv(planes[0], src_h, src_w, dst_fmt.startswith("yuvj"),
                        d.log2_chroma_w, d.log2_chroma_h)

    def _rgb_to_rgb(self, planes, src_fmt, dst_fmt):
        """Interleaved-RGB reorder (+ optional per-channel resize);
        reference: rgb2rgb.c permutations + swscale_unscaled fast
        paths. The reorder runs on the host, as in the JAX package."""
        src_w, src_h, _ = self.src
        dst_w, dst_h, _ = self.dst
        (so, sstep) = _RGB_ORDERS[src_fmt]
        (do, dstep) = _RGB_ORDERS[dst_fmt]
        px = _host(planes)[0].reshape(src_h, src_w, sstep)
        rgb = px[:, :, list(so)]
        alpha = None
        if sstep == 4:
            aidx = [i for i in range(4) if i not in so][0]
            alpha = px[:, :, aidx]
        if (src_w, src_h) != (dst_w, dst_h):
            fn = self._plane_scaler(src_h, src_w, dst_h, dst_w, self.device)

            def scale(a):
                return fn(torch.as_tensor(np.ascontiguousarray(a),
                                          device=self.device)).cpu().numpy()
            rgb = np.stack([scale(rgb[:, :, c]) for c in range(3)], axis=-1)
            alpha = scale(alpha) if alpha is not None else None
        out = np.full((dst_h, dst_w, dstep), 255, np.uint8)
        for c in range(3):
            out[:, :, do[c]] = rgb[:, :, c]
        if dstep == 4 and alpha is not None:
            aidx = [i for i in range(4) if i not in do][0]
            out[:, :, aidx] = alpha
        return [np.ascontiguousarray(out.reshape(dst_h, -1))]


def _device_of(planes, default: torch.device) -> torch.device:
    """The device of the frame's tensor planes, `default` for numpy
    ones."""
    for p in planes:
        if isinstance(p, torch.Tensor):
            return p.device
    return default


def _host(planes):
    return [p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in planes]


def _f32(x: float) -> float:
    return float(np.float32(x))


def mean_order(h: int, w: int, lw: int, lh: int, full: bool) -> str:
    """How XLA's CPU code sums each 2^lh x 2^lw chroma block of an h x w
    frame in the JAX program (jax 0.9.0). "rows": a scalar sum from 0
    over the block's rows in turn, ((p00 + p01) + p10) + p11 at 4:2:0.
    "pairs": LLVM vectorises the reduce with one lane per block row, each
    lane summing its row left to right, and adds the lanes in pairs last:
    (p00 + p01) + (p10 + p11) at 4:2:0, (r0 + r2) + (r1 + r3) over the
    four row sums at 4:1:0. "colpairs": the same with one lane per block
    column. The object code (XLA_FLAGS=--xla_dump_to) shows "pairs" at
    4:2:0 for 53x37, 97x71 and 255x71, "rows" for 129x71, 241x135,
    1280x720 and 1920x1080, and at 4:1:0 "pairs" for 1920x1080 (the four
    rows in the lanes of one xmm register, added by vshufpd and
    vmovshdup). Where the reduce is vectorised depends on the edge
    padding, because a padded edge gets a loop of its own:
      4:2:0  an even width, unpadded: "rows"; an odd width: "pairs" when
             the padded row (w + 1 values) is a power of two of at least
             128, or, with the height padded too, when 1 < w < 128. A
             frame of one chroma row (h = 2, or 1 x 2) in limited range is
             vectorised at every even width and every odd one below 128;
             in full range (a different fusion) at h = 2 only when w = 1.
      4:1:0  "pairs" when no column is padded (w % 4 == 0), else only
             when w < 125 with the height unpadded, or w < 4 with it
             padded; three frames of one chroma row differ (`_TINY_410`).
      4:1:1  "rows" (left to right) at every shape tried. 4:2:2 and
             4:4:0 sum two values (either order), 4:4:4 none.
    `tools/check_rgb2yuv_order.py` holds the rule against XLA's bytes at
    each shape it is given, on frames built to tell the orders apart."""
    if (lw, lh) == (2, 2):
        if (h, w) in _TINY_410:
            return _TINY_410[(h, w)]
        if w % 4 == 0:
            return "pairs"
        return "pairs" if w < (4 if h % 4 else 125) else "rows"
    if (lw, lh) != (1, 1):
        return "rows"
    row_pow2 = (w + 1) & w == 0
    if h == 2 and full:
        return "pairs" if w == 1 or (row_pow2 and w >= 127) else "rows"
    if h == 2 or (h, w) == (1, 2):
        return "pairs" if w % 2 == 0 or w < 128 or row_pow2 else "rows"
    if w % 2 == 0:
        return "rows"
    if h % 2:
        return "pairs" if w > 1 and (w < 128 or row_pow2) else "rows"
    return "pairs" if row_pow2 and w >= 127 else "rows"


# 4:1:0 frames of one chroma row whose reduce LLVM lays out otherwise:
# "colpairs" is one lane per block column, the lanes then in pairs
_TINY_410 = {(1, 2): "colpairs", (3, 1): "rows", (4, 2): "rows"}


def _rgb2yuv(rgb: torch.Tensor, h: int, w: int, full: bool, lw: int,
             lh: int):
    """uint8 (h, 3w) rgb24 -> the uint8 Y, U, V planes of the JAX
    program (BT.601, chroma averaged over 2^lh x 2^lw with edge padding),
    on rgb's device. XLA's CPU code for that program (jax 0.9.0, read
    from its object code, XLA_FLAGS=--xla_dump_to) rounds like this at
    every shape and every place in its loops:
      t = fma(k2, b, fma(k0, r, k1*g))          per component
      limited range: y = fma(t, K, 16), c = fma(t, K', 128)
      full range:    y = t,             c = t + 128
    where K = f32(219 * f32(1/255)) and K' = f32(224 * f32(1/255)): XLA
    folds `x * 219 / 255` into one multiplication by a constant it
    rounds twice. The chroma mean sums in `mean_order`'s order and
    multiplies by 1/16, 1/4 or 1/2."""
    x = rgb.reshape(h, w, 3).float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def lin3(k0, k1, k2):
        return _y2r.fma(b, _f32(k2), _y2r.fma(r, _f32(k0), g * _f32(k1)))

    y = lin3(0.299, 0.587, 0.114)
    u = lin3(-0.168736, -0.331264, 0.5)
    v = lin3(0.5, -0.418688, -0.081312)
    if not full:
        inv255 = _f32(1.0 / 255.0)
        y = _y2r.fma(y, _f32(219.0 * inv255), 16.0)
        u = _y2r.fma(u, _f32(224.0 * inv255), 128.0)
        v = _y2r.fma(v, _f32(224.0 * inv255), 128.0)
    else:
        u = u + 128.0
        v = v + 128.0
    if lw or lh:
        fh, fw = 1 << lh, 1 << lw
        ch, cw = -(-h // fh), -(-w // fw)
        rows = torch.arange(ch * fh, device=x.device).clamp(max=h - 1)
        cols = torch.arange(cw * fw, device=x.device).clamp(max=w - 1)
        order = mean_order(h, w, lw, lh, full)

        def mean(c):
            q = c[rows][:, cols].reshape(ch, fh, cw, fw)
            if order != "rows":
                lanes = []
                for a in range(fh if order == "pairs" else fw):
                    vals = [q[:, a, :, j] for j in range(fw)] \
                        if order == "pairs" else \
                        [q[:, i, :, a] for i in range(fh)]
                    s = vals[0]
                    for v in vals[1:]:
                        s = s + v
                    lanes.append(s)
                while len(lanes) > 1:
                    half = len(lanes) // 2
                    lanes = [lanes[k] + lanes[k + half] for k in range(half)]
                s = lanes[0]
            else:
                s = torch.zeros((ch, cw), dtype=torch.float32,
                                device=x.device)
                for i in range(fh):
                    for j in range(fw):
                        s = s + q[:, i, :, j]
            return s * (1.0 / (fh * fw))
        u, v = mean(u), mean(v)

    def cl(t):
        return t.round().clamp(0, 255).to(torch.uint8)
    return [cl(y), cl(u), cl(v)]


# interleaved byte orders of the canonical rgb family: component
# positions of (R, G, B) within the pixel, pixel size
_RGB_ORDERS = {"rgb24": ((0, 1, 2), 3), "bgr24": ((2, 1, 0), 3),
               "rgba": ((0, 1, 2), 4), "bgra": ((2, 1, 0), 4),
               "argb": ((1, 2, 3), 4), "abgr": ((3, 2, 1), 4)}


def _family(fmt: str) -> str:
    from libav_tpu_torch.avutil.pixfmt import FLAG_RGB, pixdesc
    if fmt.startswith("gray") or fmt == "ya8":
        return "gray"
    if fmt in ("rgb24", "bgr24", "rgba", "bgra", "argb", "abgr"):
        return "rgb"
    try:
        if pixdesc(fmt).flags & FLAG_RGB:
            return "rgb"
    except KeyError:
        pass
    return "yuv"
