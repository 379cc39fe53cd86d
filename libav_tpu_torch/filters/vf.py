"""Video filters (reference: libavfilter/vf_*.c — scale wraps swscale
vf_scale.c:240,291; crop, pad, transpose, hflip/vflip, fps, format,
yadif).

The JAX package's video filters (libav_tpu/filters/vf.py), with their
numpy pixel code written as torch programs that run on the device of the
frame's planes: a decoder's frames are filtered on its device, and the
numpy planes of a host frame (after hwdownload, or from a host source)
are filtered as CPU tensors. Every output plane is a tensor. No filter
writes into an input plane: a decoder may still hold it as a reference.
Integer code stays integer code of the same width, so the outputs equal
the JAX filters' byte for byte; padding is an index gather whose index
map numpy's own `np.pad` builds. Host work is limited to tables (the
LUTs, hqdn3d's correction table), the scalars that blackframe and
cropdetect read, and the bytes showinfo checksums.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.pixfmt import chroma_sub
from libav_tpu_torch.avutil.rational import NOPTS_VALUE, Rational
from libav_tpu_torch.filters.graph import Filter, register_filter


def plane(p) -> torch.Tensor:
    """A plane as a tensor on its own device; a numpy plane becomes a CPU
    tensor (sharing its memory when it can)."""
    if isinstance(p, torch.Tensor):
        return p
    a = np.ascontiguousarray(p)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def frame_device(frame: Frame) -> torch.device:
    """The device of the frame's tensor planes; the CPU for numpy ones."""
    for p in frame.planes:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def _u8(x: torch.Tensor) -> torch.Tensor:
    """numpy's astype(np.uint8) of an integer tensor: modulo 256."""
    return (x & 255).to(torch.uint8)


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Indices into an axis of length n that np.pad(mode=mode) reads for
    each position of the padded axis: the padding as a gather."""
    idx = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.as_tensor(idx, device=device)


@register_filter
class NullFilter(Filter):
    """reference: vf_null.c"""
    NAME = "null"


@register_filter
class FormatFilter(Filter):
    """reference: vf_format.c — pixel format conversion."""
    NAME = "format"
    OPTIONS = [Option("pix_fmt", "target pixel format", "string", "yuv420p")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if frame.format == self.pix_fmt:
            return [frame]
        from libav_tpu_torch.swscale import SwsContext
        sws = SwsContext.get(frame.width, frame.height, frame.format,
                             frame.width, frame.height, self.pix_fmt,
                             device=frame_device(frame))
        return [sws.scale_frame(frame)]


@register_filter
class ScaleFilter(Filter):
    """reference: vf_scale.c (wraps the swscale context)."""
    NAME = "scale"
    OPTIONS = [
        Option("w", "output width (0=keep, -1=keep aspect)", "int", 0, -16, 1 << 14),
        Option("h", "output height", "int", 0, -16, 1 << 14),
        Option("flags", "scaler flags", "string", "bicubic"),
    ]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        w, h = self.w, self.h
        if w <= 0 and h <= 0:
            return [frame]
        if w <= 0:
            w = frame.width * h // frame.height
        if h <= 0:
            h = frame.height * w // frame.width
        if (w, h) == (frame.width, frame.height):
            return [frame]
        from libav_tpu_torch import swscale as S
        flags = {"bilinear": S.BILINEAR, "bicubic": S.BICUBIC,
                 "neighbor": S.POINT, "lanczos": S.LANCZOS,
                 "area": S.AREA}.get(self.flags, S.BICUBIC)
        sws = S.SwsContext.get(frame.width, frame.height, frame.format,
                               w, h, frame.format, flags,
                               device=frame_device(frame))
        return [sws.scale_frame(frame)]


@register_filter
class CropFilter(Filter):
    """reference: vf_crop.c"""
    NAME = "crop"
    OPTIONS = [
        Option("w", "crop width", "int", 0, 0, 1 << 14),
        Option("h", "crop height", "int", 0, 0, 1 << 14),
        Option("x", "left offset (-1 = center)", "int", -1, -1, 1 << 14),
        Option("y", "top offset (-1 = center)", "int", -1, -1, 1 << 14),
    ]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        w = self.w or frame.width
        h = self.h or frame.height
        x = (frame.width - w) // 2 if self.x < 0 else self.x
        y = (frame.height - h) // 2 if self.y < 0 else self.y
        lw, lh = chroma_sub(frame.format)
        # keep chroma alignment
        x &= ~((1 << lw) - 1)
        y &= ~((1 << lh) - 1)
        out = frame.clone_props()
        out.width, out.height = w, h
        planes = []
        for i, p in enumerate(frame.planes):
            p = plane(p)
            if i in (1, 2):
                p = p[y >> lh:(y + h) >> lh, x >> lw:(x + w) >> lw]
            else:
                p = p[y:y + h, x:x + w]
            # the same bytes in a contiguous plane: the encoders, the
            # swscale kernel and to_host read it whole
            planes.append(p.contiguous())
        out.planes = planes
        return [out]


@register_filter
class PadFilter(Filter):
    """reference: vf_pad.c"""
    NAME = "pad"
    OPTIONS = [
        Option("w", "padded width", "int", 0, 0, 1 << 14),
        Option("h", "padded height", "int", 0, 0, 1 << 14),
        Option("x", "left offset", "int", 0, 0, 1 << 14),
        Option("y", "top offset", "int", 0, 0, 1 << 14),
        Option("color", "fill luma value", "int", 0, 0, 255),
    ]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        w = self.w or frame.width
        h = self.h or frame.height
        lw, lh = chroma_sub(frame.format)
        out = frame.clone_props()
        out.width, out.height = w, h
        planes = []
        for i, p in enumerate(frame.planes):
            arr = plane(p)
            if i in (1, 2):
                big = torch.full(((h + (1 << lh) - 1) >> lh,
                                  (w + (1 << lw) - 1) >> lw), 128,
                                 dtype=arr.dtype, device=arr.device)
                big[self.y >> lh:(self.y >> lh) + arr.shape[0],
                    self.x >> lw:(self.x >> lw) + arr.shape[1]] = arr
            else:
                big = torch.full((h, w), self.color, dtype=arr.dtype,
                                 device=arr.device)
                big[self.y:self.y + arr.shape[0],
                    self.x:self.x + arr.shape[1]] = arr
            planes.append(big)
        out.planes = planes
        return [out]


@register_filter
class TransposeFilter(Filter):
    """reference: vf_transpose.c (dir: 0=ccw+vflip 1=cw 2=ccw 3=cw+vflip)"""
    NAME = "transpose"
    OPTIONS = [Option("dir", "direction", "int", 1, 0, 3)]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.width, out.height = frame.height, frame.width
        planes = []
        for p in frame.planes:
            a = plane(p).t()
            if self.dir == 1:      # clockwise
                a = a.flip(1)
            elif self.dir == 2:    # counterclockwise
                a = a.flip(0)
            elif self.dir == 3:
                a = a.flip(0, 1)
            planes.append(a.contiguous())
        out.planes = planes
        return [out]


@register_filter
class HFlipFilter(Filter):
    """reference: vf_hflip.c"""
    NAME = "hflip"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = [plane(p).flip(1) for p in frame.planes]
        return [out]


@register_filter
class VFlipFilter(Filter):
    """reference: vf_vflip.c"""
    NAME = "vflip"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = [plane(p).flip(0) for p in frame.planes]
        return [out]


@register_filter
class FpsFilter(Filter):
    """reference: vf_fps.c — duplicate/drop to constant output rate."""
    NAME = "fps"
    OPTIONS = [Option("fps", "target rate", "rational", Rational(25, 1))]

    def configure(self, frame: Frame):
        self._next_pts = None
        self._last = None
        self._out_idx = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if frame.pts == NOPTS_VALUE or not frame.time_base:
            return [frame]
        out_tb = self.fps.inv()
        t = frame.pts * frame.time_base.num / frame.time_base.den
        out = []
        if self._last is None:
            self._last = frame
            self._t0 = t
            return []
        # emit frames for every output tick in [last_t, t)
        while True:
            tick = self._t0 + self._out_idx * out_tb.num / out_tb.den
            if tick >= t - 1e-9:
                break
            f = self._last.clone_props()
            f.planes = list(self._last.planes)
            f.pts = self._out_idx
            f.time_base = out_tb
            out.append(f)
            self._out_idx += 1
        self._last = frame
        self._last_t = t
        return out

    def flush(self) -> List[Frame]:
        if self._last is None:
            return []
        f = self._last.clone_props()
        f.planes = list(self._last.planes)
        f.pts = self._out_idx
        f.time_base = self.fps.inv()
        return [f]


@register_filter
class YadifFilter(Filter):
    """Yadif deinterlacer (reference: vf_yadif.c) — the full
    edge-directed program on the frame's device (ops/yadif.py), with the
    reference's prev/cur/next frame window, mode 0-3 (frame/field rate,
    with/without the spatial interlacing check), parity detection
    (return_frame vf_yadif.c:277-283), pts doubling, and the EOF
    extrapolated-next flush (request_frame vf_yadif.c:383-389)."""
    NAME = "yadif"
    OPTIONS = [
        Option("mode", "0=frame 1=field 2/3=no spatial check", "int", 0, 0, 3),
        Option("parity", "-1=auto 0=tff 1=bff", "int", -1, -1, 1),
        Option("auto", "only deinterlace frames marked interlaced", "int", 0, 0, 1),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._prev = self._cur = self._next = None

    def _filter_out(self, is_second: bool) -> Frame:
        from libav_tpu_torch.ops.yadif import yadif_plane
        cur = self._cur
        if self.parity == -1:
            tff = int(cur.top_field_first) if cur.interlaced_frame else 1
        else:
            tff = self.parity ^ 1
        parity = tff ^ (not is_second)
        out = cur.clone_props()
        out.interlaced_frame = False
        out.planes = [
            yadif_plane(plane(p), plane(c), plane(n), parity, tff,
                        int(self.mode))
            for p, c, n in zip(self._prev.planes, cur.planes,
                               self._next.planes)]
        if is_second:
            cp, npts = cur.pts, self._next.pts
            out.pts = (cp + npts) if (cp is not None and npts is not None) \
                else None
        elif out.pts is not None:
            out.pts = out.pts * 2
        return out

    def _advance(self, frame: Frame) -> List[Frame]:
        self._prev, self._cur, self._next = self._cur, self._next, frame
        if self._cur is None:
            return []
        if self.auto and not self._cur.interlaced_frame:
            out = self._cur.clone_props()
            out.planes = list(self._cur.planes)
            self._prev = None
            if out.pts is not None:
                out.pts *= 2
            return [out]
        if self._prev is None:
            self._prev = self._cur
        outs = [self._filter_out(False)]
        if self.mode & 1:
            outs.append(self._filter_out(True))
        return outs

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return self._advance(frame)

    def flush(self) -> List[Frame]:
        if self._next is None:
            return []
        last = self._next
        tail = last.clone_props()
        tail.planes = list(last.planes)
        if last.pts is not None and self._cur is not None \
                and self._cur.pts is not None:
            tail.pts = last.pts * 2 - self._cur.pts
        return self._advance(tail)


@register_filter
class OverlayFilter(Filter):
    """Two-input overlay (reference: vf_overlay.c). The secondary input
    feeds `push_secondary`; each main frame is composited with the
    latest overlay frame whose pts <= the main pts (framesync
    eof_action=repeat semantics). Offsets are snapped to even for
    4:2:0 chroma alignment, and every plane after the first is placed
    at half the offset, as in the JAX filter, whatever the format."""
    NAME = "overlay"
    N_INPUTS = 2
    OPTIONS = [Option("x", "left offset", "int", 0, -32768, 32768),
               Option("y", "top offset", "int", 0, -32768, 32768)]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._queue: List[Frame] = []
        self._last = None

    def push_secondary(self, frame: Frame):
        self._queue.append(frame)

    def _pick(self, pts):
        while self._queue and (pts is None or self._queue[0].pts is None or
                               self._queue[0].pts <= pts):
            self._last = self._queue.pop(0)
        return self._last

    def filter_frame(self, frame: Frame) -> List[Frame]:
        ov = self._pick(frame.pts)
        if ov is None:
            return [frame]
        out = frame.clone_props()
        x0, y0 = int(self.x) & ~1, int(self.y) & ~1
        planes = []
        for pi, (mp, op) in enumerate(zip(frame.planes, ov.planes)):
            a = plane(mp).clone()
            o = plane(op).to(a.device)
            sub = 1 if pi else 0                  # 4:2:0 chroma halved
            px, py = x0 >> sub, y0 >> sub
            h = min(o.shape[0], a.shape[0] - py)
            w = min(o.shape[1], a.shape[1] - px)
            if h > 0 and w > 0 and px >= 0 and py >= 0:
                a[py:py + h, px:px + w] = o[:h, :w]
            planes.append(a)
        out.planes = planes
        return [out]


@register_filter
class SetPtsFilter(Filter):
    """reference: vf_setpts.c (expression subset: PTS, N, constants)"""
    NAME = "setpts"
    OPTIONS = [Option("expr", "pts expression", "string", "PTS")]

    def configure(self, frame):
        self._n = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.avutil.eval import expr_eval
        out = frame.clone_props()
        out.planes = list(frame.planes)
        v = expr_eval(self.expr, {"PTS": float(frame.pts), "N": float(self._n)})
        out.pts = int(v)
        self._n += 1
        return [out]


# ---------------------------------------------------------------------------
# round-3 breadth batch (reference: the corresponding vf_*.c filters;
# drawbox/fade/boxblur/lut are bit-exact vs the reference C filters in
# the JAX package's cross-validation, and the port equals the JAX filters)


@register_filter
class CopyFilter(Filter):
    """reference: vf_copy.c"""
    NAME = "copy"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = [plane(p).clone() for p in frame.planes]
        return [out]


def _parse_color(s: str):
    """(R, G, B) from a color name or 0xRRGGBB / #RRGGBB
    (reference: libavutil/parseutils.c av_parse_color, common subset)."""
    names = {"black": (0, 0, 0), "white": (255, 255, 255),
             "red": (255, 0, 0), "green": (0, 128, 0),
             "blue": (0, 0, 255), "yellow": (255, 255, 0),
             "gray": (128, 128, 128), "grey": (128, 128, 128)}
    s = s.strip().lower()
    if s in names:
        return names[s]
    if s.startswith("#"):
        s = s[1:]
    elif s.startswith("0x"):
        s = s[2:]
    v = int(s, 16)
    return ((v >> 16) & 255, (v >> 8) & 255, v & 255)


def _rgb_to_yuv(r, g, b):
    """reference: libavutil/colorspace.h RGB_TO_{Y,U,V}_CCIR fixed-point
    macros (SCALEBITS=10, FIX(x)=round(x*1024))."""
    def fix(x):
        return int(x * 1024 + 0.5)
    half = 1 << 9
    y = (fix(0.29900 * 219 / 255) * r + fix(0.58700 * 219 / 255) * g +
         fix(0.11400 * 219 / 255) * b + half + (16 << 10)) >> 10
    u = ((-fix(0.16874 * 224 / 255) * r - fix(0.33126 * 224 / 255) * g +
          fix(0.50000 * 224 / 255) * b + half - 1) >> 10) + 128
    v = ((fix(0.50000 * 224 / 255) * r - fix(0.41869 * 224 / 255) * g -
          fix(0.08131 * 224 / 255) * b + half - 1) >> 10) + 128
    return y, u, v


@register_filter
class DrawBoxFilter(Filter):
    """reference: vf_drawbox.c — 3-pixel-thick box border in yuv420p."""
    NAME = "drawbox"
    OPTIONS = [
        Option("x", "left edge", "int", 0, -(1 << 14), 1 << 14),
        Option("y", "top edge", "int", 0, -(1 << 14), 1 << 14),
        Option("width", "box width (0 = frame)", "int", 0, 0, 1 << 14),
        Option("height", "box height (0 = frame)", "int", 0, 0, 1 << 14),
        Option("color", "box color", "string", "black"),
    ]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        cy, cu, cv = _rgb_to_yuv(*_parse_color(self.color))
        w = self.width or frame.width
        h = self.height or frame.height
        xb, yb = int(self.x), int(self.y)
        Y, U, V = (plane(p).clone() for p in frame.planes[:3])
        dev = Y.device
        y0, x0 = max(yb, 0), max(xb, 0)
        # np.arange: empty where the box lies outside the frame
        ys = torch.arange(y0, max(y0, min(frame.height, yb + h)), device=dev)
        xs = torch.arange(x0, max(x0, min(frame.width, xb + w)), device=dev)
        if len(ys) and len(xs):
            on_y = (ys - yb < 3) | (yb + h - ys < 4)
            on_x = (xs - xb < 3) | (xb + w - xs < 4)
            border = on_y[:, None] | on_x[None, :]
            by, bx = torch.nonzero(border, as_tuple=True)
            py, px = ys[by], xs[bx]
            Y[py, px] = cy
            U[py >> 1, px >> 1] = cu
            V[py >> 1, px >> 1] = cv
        out = frame.clone_props()
        out.planes = [Y, U, V]
        return [out]


@register_filter
class FadeFilter(Filter):
    """reference: vf_fade.c — 16.16 fixed-point fade factor; luma
    p=(p*f+32768)>>16, chroma p=((p-128)*f+8421367)>>16."""
    NAME = "fade"
    OPTIONS = [
        Option("type", "in|out", "string", "in"),
        Option("start_frame", "first affected frame", "int", 0, 0,
               1 << 30),
        Option("nb_frames", "effect length in frames", "int", 1, 0,
               1 << 30),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._factor = 0 if self.type == "in" else (1 << 16)
        per = (1 << 16) // max(1, self.nb_frames)
        self._per_frame = per if self.type == "in" else -per
        self._index = 0
        self._stop = self.start_frame + self.nb_frames

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame
        if self._factor < 0xFFFF:
            f = self._factor
            out = frame.clone_props()
            luma = plane(frame.planes[0]).to(torch.int32)
            planes = [_u8((luma * f + 32768) >> 16)]
            for p in frame.planes[1:3]:
                c = plane(p).to(torch.int32)
                # the reference's chroma slice iterates FRAME rows and
                # indexes (i >> vsub): every 4:2:0 chroma row is faded
                # twice (vf_fade.c filter_slice_chroma) — replicate
                for _ in range(2):
                    c = ((c - 128) * f + 8421367) >> 16
                planes.append(_u8(c))
            out.planes = planes
        if self.start_frame <= self._index <= self._stop:
            self._factor += self._per_frame
        self._factor = max(0, min(0xFFFF, self._factor))
        self._index += 1
        return [out]


def _boxblur_1d(a: torch.Tensor, radius: int) -> torch.Tensor:
    """vf_boxblur.c blur(): symmetric-padded running box sum with
    (sum*inv + 32768) >> 16 normalization, along the last axis."""
    if radius <= 0:
        return a.clone()
    length = 2 * radius + 1
    inv = ((1 << 16) + length // 2) // length
    pad = a.to(torch.int64)[..., _pad_index(a.shape[-1], radius, radius,
                                            "symmetric", a.device)]
    cs = torch.cumsum(pad, dim=-1)
    first = cs[..., length - 1:length]
    rest = cs[..., length:] - cs[..., :-length]
    sums = torch.cat([first, rest], dim=-1)
    return _u8((sums * inv + (1 << 15)) >> 16)


@register_filter
class BoxBlurFilter(Filter):
    """reference: vf_boxblur.c — horizontal+vertical running box blur,
    applied `power` times per direction."""
    NAME = "boxblur"
    OPTIONS = [
        Option("luma_radius", "luma box radius", "int", 2, 0, 1 << 10),
        Option("luma_power", "luma passes", "int", 2, 0, 16),
        Option("chroma_radius", "chroma box radius (-1 = luma)", "int",
               -1, -1, 1 << 10),
        Option("chroma_power", "chroma passes (-1 = luma)", "int",
               -1, -1, 16),
    ]

    @staticmethod
    def _blur_plane(p, radius, power):
        a = plane(p)
        for _ in range(power):
            a = _boxblur_1d(a, radius)
        a = a.t()
        for _ in range(power):
            a = _boxblur_1d(a, radius)
        return a.t().contiguous()

    def filter_frame(self, frame: Frame) -> List[Frame]:
        cr = self.luma_radius if self.chroma_radius < 0 else \
            self.chroma_radius
        cp = self.luma_power if self.chroma_power < 0 else \
            self.chroma_power
        out = frame.clone_props()
        out.planes = [
            self._blur_plane(frame.planes[0], self.luma_radius,
                             self.luma_power),
            self._blur_plane(frame.planes[1], cr, cp),
            self._blur_plane(frame.planes[2], cr, cp)]
        return [out]


class _LutBase(Filter):
    """reference: vf_lut.c — per-component 256-entry LUT from
    expressions over val/maxval/minval/negval/clipval. The tables are
    built on the host with expr_eval, then applied on the frame's device
    as one gather per plane."""

    _MIN = (16, 16, 16)
    _MAX = (235, 240, 240)
    # packed position -> lut component index (vf_lut.c rgba_map)
    _PACKED_MAP = {"rgb24": (0, 1, 2), "bgr24": (2, 1, 0)}

    def _luts(self, w, h):
        import math
        from libav_tpu_torch.avutil.eval import expr_eval
        luts = []
        for comp in range(3):
            expr = self._expr(comp)
            mn, mx = self._MIN[comp], self._MAX[comp]
            lut = np.empty(256, np.uint8)
            for val in range(256):
                variables = dict(val=float(val), maxval=float(mx),
                                 minval=float(mn),
                                 clipval=float(min(max(val, mn), mx)),
                                 negval=float(min(max(mn + mx - val, mn),
                                                  mx)),
                                 w=float(w), h=float(h))

                def _gammaval(g, _v=float(val), _mn=mn, _mx=mx):
                    base = (_v - _mn) / (_mx - _mn)
                    if base < 0:
                        return math.nan
                    return math.pow(base, g) * (_mx - _mn) + _mn

                res = expr_eval(expr, variables, funcs1={
                    "clip": lambda x, _mn=mn, _mx=mx:
                        min(max(x, _mn), _mx),
                    "gammaval": _gammaval,
                })
                # C `(int)NaN` is 0 on the reference targets, then clipped
                iv = 0 if math.isnan(res) else int(res)
                lut[val] = min(max(iv, mn), mx)
            luts.append(lut)
        return luts

    def _device_luts(self, frame: Frame, device) -> torch.Tensor:
        if not hasattr(self, "_lut_cache"):
            self._lut_cache = self._luts(frame.width, frame.height)
            self._lut_on = {}
        if device not in self._lut_on:
            self._lut_on[device] = torch.as_tensor(
                np.stack(self._lut_cache), device=device)
        return self._lut_on[device]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        planes = [plane(p) for p in frame.planes[:3]]
        luts = self._device_luts(frame, planes[0].device)
        out = frame.clone_props()
        pm = self._PACKED_MAP.get(frame.format)
        if pm is not None:
            px = planes[0].reshape(frame.height, -1, 3).long()
            res = torch.stack([luts[pm[k]][px[:, :, k]] for k in range(3)],
                              dim=-1)
            out.planes = [res.reshape(frame.height, -1)]
            return [out]
        out.planes = [luts[i][p.long()] for i, p in enumerate(planes)]
        return [out]


@register_filter
class LutYuvFilter(_LutBase):
    NAME = "lutyuv"
    OPTIONS = [
        Option("c0", "component 0 expression", "string", "val"),
        Option("c1", "component 1 expression", "string", "val"),
        Option("c2", "component 2 expression", "string", "val"),
        Option("y", "Y expression", "string", ""),
        Option("u", "U expression", "string", ""),
        Option("v", "V expression", "string", ""),
    ]

    def _expr(self, comp):
        named = (self.y, self.u, self.v)[comp]
        return named or (self.c0, self.c1, self.c2)[comp]


@register_filter
class NegateFilter(_LutBase):
    """reference: vf_lut.c negate registration (negval for all)."""
    NAME = "negate"

    def _expr(self, comp):
        return "negval"


@register_filter
class ShufflePlanesFilter(Filter):
    """reference: vf_shuffleplanes.c"""
    NAME = "shuffleplanes"
    OPTIONS = [Option("map0", "source of plane 0", "int", 0, 0, 3),
               Option("map1", "source of plane 1", "int", 1, 0, 3),
               Option("map2", "source of plane 2", "int", 2, 0, 3)]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        m = (self.map0, self.map1, self.map2)
        planes = [plane(p) for p in frame.planes]
        shapes = [tuple(p.shape) for p in planes]
        for i, src in enumerate(m):
            if shapes[src] != shapes[i]:
                raise AVError(EINVAL, "shuffleplanes: plane size "
                                      "mismatch (chroma<->luma)")
        out = frame.clone_props()
        out.planes = [planes[src].clone() for src in m]
        return [out]


@register_filter
class FieldOrderFilter(Filter):
    """reference: vf_fieldorder.c — shift the frame one line up/down,
    duplicating the edge line, to swap tff<->bff."""
    NAME = "fieldorder"
    OPTIONS = [Option("order", "output field order 0=bff 1=tff", "int",
                      1, 0, 1)]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if not frame.interlaced_frame or \
                int(bool(frame.top_field_first)) == self.order:
            return [frame]
        out = frame.clone_props()
        planes = []
        for p in frame.planes:
            a = plane(p)
            if self.order:      # shift up
                b = torch.cat([a[1:], a[-1:]])
            else:               # shift down
                b = torch.cat([a[:1], a[:-1]])
            planes.append(b)
        out.planes = planes
        out.top_field_first = bool(self.order)
        return [out]


@register_filter
class SettbFilter(Filter):
    """reference: vf_settb.c — rewrite the output time base, rescaling
    pts."""
    NAME = "settb"
    OPTIONS = [Option("expr", "time base (e.g. 1/90000)", "string",
                      "1/25")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        num, den = (self.expr.split("/") + ["1"])[:2]
        tb = Rational(int(num), int(den))
        out = frame.clone_props()
        out.planes = list(frame.planes)
        if frame.pts is not None and frame.time_base:
            out.pts = int(round(frame.pts *
                                (frame.time_base / tb).to_float()))
        out.time_base = tb
        return [out]


@register_filter
class ShowInfoFilter(Filter):
    """reference: vf_showinfo.c — log per-frame info + plane checksums
    (the planes' bytes come to the host for the checksum)."""
    NAME = "showinfo"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        import zlib
        from libav_tpu_torch.avutil import log
        sums = [zlib.adler32(plane(p).contiguous().cpu().numpy().tobytes())
                for p in frame.planes]
        log.info(self, "n:%d pts:%s fmt:%s %dx%d i:%d checksums:%s",
                 self._n, frame.pts, frame.format, frame.width,
                 frame.height, int(bool(frame.interlaced_frame)),
                 " ".join(f"{s:08X}" for s in sums))
        self._n += 1
        return [frame]


@register_filter
class TrimFilter(Filter):
    """reference: vf_trim.c — pass frames inside [start_frame,
    end_frame) / [start, end) seconds."""
    NAME = "trim"
    OPTIONS = [
        Option("start_frame", "first kept frame", "int", 0, 0, 1 << 30),
        Option("end_frame", "first dropped frame (0 = inf)", "int", 0,
               0, 1 << 30),
        Option("start", "start seconds", "string", ""),
        Option("end", "end seconds", "string", ""),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        n = self._n
        self._n += 1
        if self.start or self.end:
            if frame.pts is None or not frame.time_base:
                return [frame]
            t = frame.pts * frame.time_base.num / frame.time_base.den
            if self.start and t < float(self.start):
                return []
            if self.end and t >= float(self.end):
                return []
            return [frame]
        if n < self.start_frame:
            return []
        if self.end_frame and n >= self.end_frame:
            return []
        return [frame]


@register_filter
class SelectFilter(Filter):
    """reference: vf_select.c — keep frames for which the expression is
    non-zero (vars: n, selected_n, key)."""
    NAME = "select"
    OPTIONS = [Option("expr", "selection expression", "string", "1")]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = 0
        self._selected = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.avutil.eval import expr_eval
        v = expr_eval(self.expr, dict(
            n=float(self._n), selected_n=float(self._selected),
            key=1.0 if getattr(frame, "key_frame", False) else 0.0))
        self._n += 1
        if v == 0:
            return []
        self._selected += 1
        return [frame]


@register_filter
class BlackFrameFilter(Filter):
    """reference: vf_blackframe.c — log frames blacker than a
    percentage threshold. The black pixels are counted on the frame's
    device; the count comes back and is divided on the host in float64,
    as numpy's mean divides its exact sum."""
    NAME = "blackframe"
    OPTIONS = [Option("amount", "percent of black pixels", "int", 98,
                      0, 100),
               Option("threshold", "luma threshold for black", "int",
                      32, 0, 255)]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.avutil import log
        y = plane(frame.planes[0])
        black = int((y < self.threshold).sum())
        pblack = int(black / y.numel() * 100)
        if pblack >= self.amount:
            log.info(self, "frame:%d pblack:%d pts:%s", self._n,
                     pblack, frame.pts)
        self._n += 1
        return [frame]


@register_filter
class NoFormatFilter(Filter):
    """reference: vf_noformat.c — force conversion away from the named
    pixel format."""
    NAME = "noformat"
    OPTIONS = [Option("pix_fmt", "forbidden pixel format", "string",
                      "")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if not self.pix_fmt or frame.format != self.pix_fmt:
            return [frame]
        from libav_tpu_torch.swscale import SwsContext
        target = "yuv422p" if frame.format == "yuv420p" else "yuv420p"
        sws = SwsContext.get(frame.width, frame.height, frame.format,
                             frame.width, frame.height, target,
                             device=frame_device(frame))
        return [sws.scale_frame(frame)]


def _hqdn3d_lut(dist25: float) -> np.ndarray:
    """vf_hqdn3d.c:173 precalc_coefs (8-bit: LUT_BITS=4) — correction
    toward `prev` indexed by (prev-cur)>>4 in the <<8 pixel domain."""
    import math
    lut_bits = 4
    gamma = math.log(0.25) / math.log(1.0 - min(dist25, 252.0) / 255.0
                                      - 0.00001)
    i = np.arange(-(255 << lut_bits), (255 << lut_bits) + 1, dtype=np.int64)
    f = ((i << (9 - lut_bits)) + (1 << (8 - lut_bits)) - 1) / 512.0
    simil = 1.0 - np.abs(f) / 255.0
    # the outermost two bins have |f| marginally > 255 (simil < 0,
    # pow -> NaN in the reference too); unreachable for real pixel
    # pairs after the +127 LOAD offset — pin to 0
    c = np.where(simil > 0,
                 np.power(np.maximum(simil, 0), gamma) * 256.0 * f, 0.0)
    ct = np.zeros(512 << lut_bits, dtype=np.int64)
    ct[(256 << lut_bits) + i] = np.rint(c).astype(np.int64)
    return ct


@register_filter
class Hqdn3dFilter(Filter):
    """High-quality 3D denoiser (reference: vf_hqdn3d.c) — recursive
    LUT-driven lowpass horizontally, vertically and temporally in a <<8
    fixed-point domain. The horizontal IIR runs as one step per column
    vectorized over rows, the vertical one as one step per row
    vectorized over columns (a few launches per step on the card); the
    temporal pass is one elementwise program. line/frame history stores
    truncate to uint16 exactly like the reference's line_ant/frame_ant
    buffers."""
    NAME = "hqdn3d"
    OPTIONS = [
        Option("luma_spatial", "spatial luma strength", "float", 0.0,
               0.0, 255.0),
        Option("chroma_spatial", "spatial chroma strength", "float",
               0.0, 0.0, 255.0),
        Option("luma_tmp", "temporal luma strength", "float", 0.0,
               0.0, 255.0),
        Option("chroma_tmp", "temporal chroma strength", "float",
               0.0, 0.0, 255.0),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # defaults cascade (vf_hqdn3d.c:198 init)
        ls = self.luma_spatial or 4.0
        cs = self.chroma_spatial or 3.0 * ls / 4.0
        lt = self.luma_tmp or 6.0 * ls / 4.0
        ct = self.chroma_tmp or lt * cs / ls
        self._strength = (ls, cs, lt, ct)
        # LUT order matches the reference coefs[]: LUMA_SPATIAL,
        # LUMA_TMP, CHROMA_SPATIAL, CHROMA_TMP (vf_hqdn3d.h:38)
        self._luts = [_hqdn3d_lut(s) for s in (ls, lt, cs, ct)]
        self._luts_on = {}
        self._spatial_on = (bool(ls), bool(cs))
        self._frame_ant = [None, None, None]

    def _tables(self, device):
        if device not in self._luts_on:
            self._luts_on[device] = [torch.as_tensor(t, device=device)
                                     for t in self._luts]
        return self._luts_on[device]

    @staticmethod
    def _lowpass(prev, cur, cur_lo, lut):
        """cur + lut[(256 << 4) + ((prev - cur) >> 4)], with cur_lo =
        cur - (256 << 8) folding the offset into the shift:
        (prev - cur + 65536) >> 4 == ((prev - cur) >> 4) + 4096."""
        return cur + lut[(prev - cur_lo) >> 4]

    def _denoise(self, p, p_idx):
        c = 1 if p_idx else 0
        src = plane(p).to(torch.int64)
        h, w = src.shape
        luts = self._tables(src.device)
        load = (src << 8) + 127
        load_lo = load - (256 << 8)
        spatial = luts[2] if c else luts[0]
        temporal = luts[3] if c else luts[1]
        fa = self._frame_ant[p_idx]
        if fa is None or fa.shape != (h, w):
            fa = load & 0xFFFF
        if self._spatial_on[1 if c else 0]:
            # horizontal IIR (pixel_ant): row 0 lowpasses at x=0 too
            cols, cols_lo = load.t(), load_lo.t()
            pix = cols[0].clone()
            pix[0:1] = self._lowpass(pix[0:1], cols[0, 0:1], cols_lo[0, 0:1],
                                     spatial)
            hcols = [pix]
            for x in range(1, w):
                pix = self._lowpass(pix, cols[x], cols_lo[x], spatial)
                hcols.append(pix)
            ph = torch.stack(hcols, dim=1)
            ph_lo = ph - (256 << 8)
            # vertical IIR (line_ant, uint16-truncated store)
            line = ph[0] & 0xFFFF
            rows = [ph[0]]
            for y in range(1, h):
                vy = self._lowpass(line, ph[y], ph_lo[y], spatial)
                rows.append(vy)
                line = vy & 0xFFFF
            v = torch.stack(rows)
            out = self._lowpass(fa, v, v - (256 << 8), temporal)
        else:
            out = self._lowpass(fa, load, load_lo, temporal)
        self._frame_ant[p_idx] = out & 0xFFFF
        return _u8(out >> 8)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = [self._denoise(p, i)
                      for i, p in enumerate(frame.planes[:3])]
        return [out]


@register_filter
class UnsharpFilter(Filter):
    """Sharpen/blur (reference: vf_unsharp.c) — the reference's
    finite-state-machine Gaussian approximation is an exact separable
    binomial filter with edge replication: 2*s cascaded 2-tap box sums
    per axis in int64 (the 13x13 sums pass 2^24, so no float
    convolution), then res = src + ((src - ((blur+half)>>scalebits))
    * amount) >> 16 per apply_unsharp (vf_unsharp.c:113)."""
    NAME = "unsharp"
    OPTIONS = [
        Option("luma_msize_x", "luma matrix width", "int", 5, 3, 13),
        Option("luma_msize_y", "luma matrix height", "int", 5, 3, 13),
        Option("luma_amount", "luma strength", "float", 1.0, -2.0, 5.0),
        Option("chroma_msize_x", "chroma matrix width", "int", 5, 3, 13),
        Option("chroma_msize_y", "chroma matrix height", "int", 5, 3, 13),
        Option("chroma_amount", "chroma strength", "float", 0.0, -2.0,
               5.0),
    ]

    @staticmethod
    def _apply(p, mx, my, amount_f):
        amount = int(amount_f * 65536.0)
        a = plane(p)
        if amount == 0:
            return a.clone()
        sx, sy = mx // 2, my // 2
        scalebits = (sx + sy) * 2
        halfscale = 1 << (scalebits - 1)
        src = a.to(torch.int64)
        h, w = src.shape
        t = src[_pad_index(h, sy, sy, "edge", src.device)][
            :, _pad_index(w, sx, sx, "edge", src.device)]
        for _ in range(2 * sx):
            t = t[:, :-1] + t[:, 1:]
        for _ in range(2 * sy):
            t = t[:-1] + t[1:]
        blur = (t + halfscale) >> scalebits
        res = src + (((src - blur) * amount) >> 16)
        return res.clamp(0, 255).to(torch.uint8)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = [
            self._apply(frame.planes[0], self.luma_msize_x,
                        self.luma_msize_y, self.luma_amount),
            self._apply(frame.planes[1], self.chroma_msize_x,
                        self.chroma_msize_y, self.chroma_amount),
            self._apply(frame.planes[2], self.chroma_msize_x,
                        self.chroma_msize_y, self.chroma_amount)]
        return [out]


_GRADFUN_DITHER = np.array([
    [0x00, 0x60, 0x18, 0x78, 0x06, 0x66, 0x1E, 0x7E],
    [0x40, 0x20, 0x58, 0x38, 0x46, 0x26, 0x5E, 0x3E],
    [0x10, 0x70, 0x08, 0x68, 0x16, 0x76, 0x0E, 0x6E],
    [0x50, 0x30, 0x48, 0x28, 0x56, 0x36, 0x4E, 0x2E],
    [0x04, 0x64, 0x1C, 0x7C, 0x02, 0x62, 0x1A, 0x7A],
    [0x44, 0x24, 0x5C, 0x3C, 0x42, 0x22, 0x5A, 0x3A],
    [0x14, 0x74, 0x0C, 0x6C, 0x12, 0x72, 0x0A, 0x6A],
    [0x54, 0x34, 0x4C, 0x2C, 0x52, 0x32, 0x4A, 0x2A]], dtype=np.int64)


@register_filter
class GradFunFilter(Filter):
    """Debanding (reference: vf_gradfun.c) — 2x2-downsampled rolling
    vertical window sum in a uint16 ring (ff_gradfun_blur_line_c),
    in-place horizontal running mean scaled by (1<<21)/r^2
    (filter():94-110), then the per-pixel pull-toward-dc with ordered
    dither (ff_gradfun_filter_line_c). The JAX filter's row loop, each
    step vectorized over the row; the output rows that read one state of
    the dc line are filtered together."""
    NAME = "gradfun"
    OPTIONS = [
        Option("strength", "max change per pixel", "float", 1.2, 0.51,
               64.0),
        Option("radius", "gradient fit neighborhood", "int", 16, 4, 32),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._thresh = int((1 << 15) / self.strength)
        self._radius = self.radius & ~1

    def _filter_plane(self, p, r):
        src = plane(p).to(torch.int64)
        h, w = src.shape
        if min(w, h) <= 2 * r:
            return plane(p).clone()
        dev = src.device
        thresh = self._thresh
        hw = w // 2
        dc_factor = (1 << 21) // (r * r)
        off = 16                                   # dc[-r/2..] headroom
        dc = torch.zeros(off + ((w + r + 1) // 2) + 16, dtype=torch.int64,
                         device=dev)
        ring = torch.zeros((r, hw), dtype=torch.int64, device=dev)
        # horizontal pair sums of every row: a blur line adds two rows'
        pairs = src[:, 0:2 * hw:2] + src[:, 1:2 * hw:2]

        def blur_line(slot, prev_vals, y2):
            v = (prev_vals + pairs[y2] + pairs[y2 + 1]) & 0xFFFF
            dc[off:off + hw] = (v - ring[slot]) & 0xFFFF
            ring[slot] = v

        def hblur():
            cs = torch.nn.functional.pad(torch.cumsum(dc[off:off + hw], 0),
                                         (1, 0))
            # v(x) = sum dc[x-r+1..x]; dc[x-r] = v*f >> 16 (uint32 mul);
            # the tail repeats the last window's value
            win = cs[r:] - cs[:-r]                 # x = r-1 .. hw-1
            scaled = (((win * dc_factor) & 0xFFFFFFFF) >> 16) & 0xFFFF
            dc[off:off + hw - r] = scaled[1:]
            dc[off + hw - r:off + (w + r + 1) // 2 - r] = scaled[-1:]
            dc[off - r // 2:off] = dc[off]

        # the row loop keeps a copy of dc at each state that output rows
        # read: rows 0..r+1 read the first, then each pair of rows the
        # state after its blur step (the last pairs see no new step)
        states, state_of_row = [], []
        prev = torch.zeros(hw, dtype=torch.int64, device=dev)
        for y in range(r):
            blur_line(y, ring[y - 1] if y else prev, 2 * y)
        y = r
        while True:
            if y < h - r:
                mod = ((y + r) // 2) % r
                blur_line(mod, ring[mod - 1 if mod else r - 1], y + r)
                hblur()
                states.append(dc.clone())
            rows = min(y + 2, h) - (0 if y == r else y)
            state_of_row += [len(states) - 1] * rows
            y += 2
            if y >= h:
                break
        # every output row at once, from the dc state it read
        # (ff_gradfun_filter_line_c)
        idx = torch.as_tensor((np.arange(w) >> 1) - r // 2 + off,
                              device=dev)
        dcs = torch.stack(states)[torch.as_tensor(state_of_row,
                                                  device=dev)][:, idx]
        dither = torch.as_tensor(
            _GRADFUN_DITHER[(np.arange(h) & 7)[:, None], np.arange(w) & 7],
            device=dev)
        pix = src << 7
        delta = dcs - pix
        m = (127 - ((delta.abs() * thresh) >> 16)).clamp(min=0)
        m = (m * m * delta) >> 14
        return ((pix + m + dither) >> 7).clamp(0, 255).to(torch.uint8)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        hsub, vsub = chroma_sub(frame.format)
        r = self._radius
        cr = min(max((((r >> hsub) + (r >> vsub)) // 2 + 1) & ~1, 4), 32)
        out = frame.clone_props()
        out.planes = [self._filter_plane(p, r if i == 0 else cr)
                      for i, p in enumerate(frame.planes)]
        return [out]


@register_filter
class InterlaceFilter(Filter):
    """Progressive -> interlaced (reference: vf_interlace.c) — weave
    the upper field of one frame with the lower field of the next
    (scan=tff/bff), halving the frame rate; optional [1 2 1]/4 vertical
    lowpass per kept field row (lowpass_line_c, edges clamped at the
    first/last row of each field's span)."""
    NAME = "interlace"
    OPTIONS = [
        Option("scan", "tff|bff", "string", "tff"),
        Option("lowpass", "vertical lowpass on", "int", 1, 0, 1),
    ]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._cur = self._next = None

    @staticmethod
    def _field(dst, srcp, upper: bool, lowpass: int):
        h = srcp.shape[0]
        lines = (h + (1 if upper else 0)) // 2
        start = 0 if upper else 1
        rows = start + 2 * torch.arange(lines, device=srcp.device)
        if lowpass:
            above = torch.clamp(rows - 1, min=start)
            below = torch.clamp(rows + 1, max=start + 2 * (lines - 1))
            # reference clamps to the field's own first/last source row
            above[0] = rows[0]
            below[-1] = rows[-1]
            s = srcp.to(torch.int64)
            dst[rows] = (1 + 2 * s[rows] + s[above] + s[below]) >> 2
        else:
            dst[rows] = srcp[rows].to(torch.int64)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        self._cur, self._next = self._next, frame
        if self._cur is None:
            return []
        cur, nxt = self._cur, self._next
        if cur.interlaced_frame:
            # already interlaced: pass through at half rate, frames
            # slide by one (vf_interlace.c:193 keeps cur/next)
            out = cur.clone_props()
            out.planes = list(cur.planes)
            if out.pts is not None and out.pts != NOPTS_VALUE:
                out.pts = int(out.pts / 2)
            return [out]
        # a weave consumes both frames (vf_interlace.c:217,221)
        self._cur = self._next = None
        tff = self.scan != "bff"
        out = cur.clone_props()
        out.interlaced_frame = True
        out.top_field_first = tff
        if out.pts is not None and out.pts != NOPTS_VALUE:
            out.pts = int(out.pts / 2)
        planes = []
        for pc, pn in zip(cur.planes, nxt.planes):
            pc, pn = plane(pc), plane(pn)
            d = torch.empty(pc.shape, dtype=torch.int64, device=pc.device)
            self._field(d, pc, tff, self.lowpass)
            self._field(d, pn, not tff, self.lowpass)
            planes.append(_u8(d))
        out.planes = planes
        return [out]


@register_filter
class SplitFilter(Filter):
    """reference: split.c — duplicate the input to N outputs.  The
    graph executor fans every output frame out to all out links, so
    split is the identity here; `outputs` documents intent (the DAG
    wiring comes from the [label] count)."""
    NAME = "split"
    OPTIONS = [Option("outputs", "number of outputs", "int", 2, 1, 16)]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [frame]


def _delogo_plane(src: torch.Tensor, lx, ly, lw, lh, band, show):
    """Literal transcription of vf_delogo.c apply_delogo (the interior
    interpolates from the 3-tap smoothed border rows/columns; a `band`
    pixel fringe blends toward the source). Integer division floors, as
    numpy's `//` does."""
    h, w = src.shape
    s = src.to(torch.int64)
    dst = s.clone()
    xclipl = max(-lx, 0)
    xclipr = max(lx + lw - w, 0)
    yclipt = max(-ly, 0)
    yclipb = max(ly + lh - h, 0)
    x1 = lx + xclipl
    x2 = lx + lw - xclipr
    y1 = ly + yclipt
    y2 = ly + lh - yclipb
    if x2 - x1 <= 2 or y2 - y1 <= 2 or lw <= 0 or lh <= 0:
        return src.clone()
    dev = src.device
    ys = torch.arange(y1 + 1, y2 - 1, device=dev)
    xs = torch.arange(x1 + 1, x2 - 1, device=dev)
    # topleft column smoothing: rows (y-ly-yclipt) +0/-1/+1 from y1
    ty = ys - ly - yclipt
    tl = (s[y1 + ty, x1] + s[y1 + ty - 1, x1] + s[y1 + ty + 1, x1])
    tr = (s[y1 + ty, x2 - 1] + s[y1 + ty - 1, x2 - 1] +
          s[y1 + ty + 1, x2 - 1])
    txx = xs - lx - xclipl
    tx = (s[y1, x1 + txx] + s[y1, x1 + txx - 1] + s[y1, x1 + txx + 1])
    bx = (s[y2 - 1, x1 + txx] + s[y2 - 1, x1 + txx - 1] +
          s[y2 - 1, x1 + txx + 1])
    # integer weights exactly as the reference (C int division LAST)
    interp = (tl[:, None] * ((lw - (xs - lx))[None, :]) // lw +
              tr[:, None] * ((xs - lx)[None, :]) // lw +
              tx[None, :] * ((lh - (ys - ly))[:, None]) // lh +
              bx[None, :] * ((ys - ly)[:, None]) // lh) // 6
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    inner = ((yy >= ly + band) & (yy < ly + lh - band) &
             (xx >= lx + band) & (xx < lx + lw - band))
    dist = torch.zeros_like(yy)
    dist = torch.where(xx < lx + band,
                       torch.maximum(dist, lx - xx + band), dist)
    dist = torch.where(xx >= lx + lw - band,
                       torch.maximum(dist, xx - (lx + lw - 1 - band)), dist)
    dist = torch.where(yy < ly + band,
                       torch.maximum(dist, ly - yy + band), dist)
    dist = torch.where(yy >= ly + lh - band,
                       torch.maximum(dist, yy - (ly + lh - 1 - band)), dist)
    if band:
        fringe = (s[y1 + 1:y2 - 1, x1 + 1:x2 - 1] * dist +
                  interp * (band - dist)) // band
        reg = torch.where(inner, interp, fringe)
    else:
        # every pixel is inner when the band is 0; numpy's fringe would
        # divide by zero (0, with a warning) and go unused
        reg = interp
    if show:
        reg = torch.where(~inner & (dist == band - 1), 0, reg)
    dst[y1 + 1:y2 - 1, x1 + 1:x2 - 1] = reg
    return dst.clamp(0, 255).to(torch.uint8)


@register_filter
class DelogoFilter(Filter):
    """reference: vf_delogo.c — interpolate a logo area away."""
    NAME = "delogo"
    OPTIONS = [
        Option("x", "logo x", "int", -1, -1, 1 << 14),
        Option("y", "logo y", "int", -1, -1, 1 << 14),
        Option("w", "logo width", "int", -1, -1, 1 << 14),
        Option("h", "logo height", "int", -1, -1, 1 << 14),
        Option("band", "fringe width", "int", 4, 1, 1 << 8),
        Option("show", "show outline", "int", 0, 0, 1),
    ]

    def init(self):
        if self.x < 0 or self.y < 0 or self.w < 0 or self.h < 0:
            raise AVError(EINVAL, "delogo: x/y/w/h must all be set")
        # the region grows by the band on every side (vf_delogo.c init)
        if self.show:
            self.band = 4
        self.w += self.band * 2
        self.h += self.band * 2
        self.x -= self.band
        self.y -= self.band

    def filter_frame(self, frame: Frame) -> List[Frame]:
        hs, vs = chroma_sub(frame.format)
        out = frame.clone_props()
        planes = []
        for i, p in enumerate(frame.planes):
            hsub = hs if i in (1, 2) else 0
            vsub = vs if i in (1, 2) else 0
            planes.append(_delogo_plane(
                plane(p), self.x >> hsub, self.y >> vsub,
                self.w >> hsub, self.h >> vsub,
                self.band >> min(hsub, vsub), self.show))
        out.planes = planes
        return [out]


@register_filter
class LutFilter(_LutBase):
    """reference: vf_lut.c generic 'lut' — component ranges depend on
    the input format (vf_lut.c:211 config_props: planar YUV gets the
    limited 16..235/16..240 range, everything else full range)."""
    NAME = "lut"
    OPTIONS = [
        Option("c0", "component 0 expression", "string", "val"),
        Option("c1", "component 1 expression", "string", "val"),
        Option("c2", "component 2 expression", "string", "val"),
    ]

    def configure(self, frame):
        if frame.format.startswith(("yuv4", "yuvj4", "yuva4")) and \
                not frame.format.startswith("yuvj"):
            self._MIN, self._MAX = (16, 16, 16), (235, 240, 240)
        else:
            self._MIN, self._MAX = (0, 0, 0), (255, 255, 255)

    def _expr(self, comp):
        return (self.c0, self.c1, self.c2)[comp]


@register_filter
class LutRgbFilter(_LutBase):
    """reference: vf_lut.c lutrgb — r/g/b expressions on packed RGB."""
    NAME = "lutrgb"
    _MIN = (0, 0, 0)
    _MAX = (255, 255, 255)
    OPTIONS = [
        Option("r", "red expression", "string", "val"),
        Option("g", "green expression", "string", "val"),
        Option("b", "blue expression", "string", "val"),
    ]

    def _expr(self, comp):
        return (self.r, self.g, self.b)[comp]


def _first_last(mask: torch.Tensor):
    """(any, first index, last index) of a 1-D bool tensor, on its
    device ((0, 0, -1) when it is empty)."""
    n = mask.shape[0]
    ar = torch.arange(n, device=mask.device)
    first = torch.where(mask, ar, n).amin() if n else ar.new_tensor(0)
    last = torch.where(mask, ar, -1).amax() if n else ar.new_tensor(-1)
    return torch.stack([mask.any().to(torch.int64), first, last])


@register_filter
class CropDetectFilter(Filter):
    """reference: vf_cropdetect.c — detect black borders, log the
    suggested crop= string (limit threshold, round alignment). The row
    and column means and the border search run on the frame's device;
    the four border positions come back."""
    NAME = "cropdetect"
    OPTIONS = [
        Option("limit", "black threshold", "int", 24, 0, 255),
        Option("round", "size alignment", "int", 16, 2, 512),
        Option("reset", "reset after N frames", "int", 0, 0, 1 << 20),
    ]

    def configure(self, frame):
        self._x1, self._y1 = frame.width - 1, frame.height - 1
        self._x2 = self._y2 = 0
        self._frame_nb = -2    # first 2 frames may be empty

    def filter_frame(self, frame: Frame) -> List[Frame]:
        import sys
        self._frame_nb += 1
        if self._frame_nb <= 0:
            return [frame]
        if self.reset > 0 and self._frame_nb > self.reset:
            self._x1, self._y1 = frame.width - 1, frame.height - 1
            self._x2 = self._y2 = 0
            self._frame_nb = 1
        # checkline = integer mean of the row/column vs limit
        ymat = plane(frame.planes[0]).to(torch.int64)
        rows = ymat.sum(dim=1) // frame.width
        cols = ymat.sum(dim=0) // frame.height
        spans = [rows[:self._y1] > self.limit,
                 rows[self._y2 + 1:] > self.limit,
                 cols[:self._x1] > self.limit,
                 cols[self._x2 + 1:] > self.limit]
        found = torch.stack([_first_last(m) for m in spans]).tolist()
        (t_any, top, _), (b_any, _, bot), (l_any, left, _), \
            (r_any, _, right) = found
        if t_any:
            self._y1 = top
        if b_any:
            self._y2 = bot + self._y2 + 1
        if l_any:
            self._x1 = left
        if r_any:
            self._x2 = right + self._x2 + 1
        x = (self._x1 + 1) & ~1
        y = (self._y1 + 1) & ~1
        w = self._x2 - x + 1
        h = self._y2 - y + 1
        if self.round <= 1:
            self.round = 16
        if self.round % 2:
            self.round *= 2
        sb = w % self.round
        w -= sb
        x += (sb // 2 + 1) & ~1
        sb = h % self.round
        h -= sb
        y += (sb // 2 + 1) & ~1
        sys.stderr.write(
            f"[cropdetect] x1:{self._x1} x2:{self._x2} y1:{self._y1} "
            f"y2:{self._y2} w:{w} h:{h} x:{x} y:{y} "
            f"crop={w}:{h}:{x}:{y}\n")
        return [frame]


@register_filter
class SetDarFilter(Filter):
    """reference: vf_aspect.c setdar — evaluate the DAR expression at
    config time, convert to SAR via av_reduce(dar.num*h, dar.den*w, 100)
    (vf_aspect.c:116 setdar_config_props)."""
    NAME = "setdar"
    OPTIONS = [Option("dar", "display aspect expression", "string", "1")]

    def _eval_ratio(self, frame):
        from fractions import Fraction
        from libav_tpu_torch.avutil.eval import expr_eval
        import math
        hs, vs = chroma_sub(frame.format)
        sar_in = frame.sample_aspect_ratio
        sar = (sar_in.num / sar_in.den
               if sar_in and sar_in.num else 1.0)
        a = frame.width / frame.height
        expr = self.dar.replace(":", "/")
        res = expr_eval(expr, dict(
            w=float(frame.width), h=float(frame.height), a=a, sar=sar,
            dar=a * sar, hsub=float(1 << hs), vsub=float(1 << vs),
            pi=math.pi, e=math.e, phi=(1 + math.sqrt(5)) / 2))
        return Fraction(res).limit_denominator(1 << 30)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from fractions import Fraction
        out = frame.clone_props()
        out.planes = list(frame.planes)
        dar = self._eval_ratio(frame)
        if dar:
            sar = Fraction(dar.numerator * frame.height,
                           dar.denominator * frame.width
                           ).limit_denominator(100)
            out.sample_aspect_ratio = Rational(sar.numerator,
                                               sar.denominator)
        else:
            out.sample_aspect_ratio = Rational(1, 1)
        return [out]


@register_filter
class SetSarFilter(SetDarFilter):
    """reference: vf_aspect.c setsar — frame SAR set verbatim."""
    NAME = "setsar"
    OPTIONS = [Option("sar", "sample aspect expression", "string", "1")]

    def _eval_ratio(self, frame):
        self.dar = self.sar
        return super()._eval_ratio(frame)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        out.planes = list(frame.planes)
        sar = self._eval_ratio(frame)
        out.sample_aspect_ratio = Rational(sar.numerator, sar.denominator)
        return [out]


@register_filter
class FifoFilter(Filter):
    """reference: fifo.c — pass-through buffer (push graphs need no
    explicit buffering)."""
    NAME = "fifo"


@register_filter
class NullSinkFilter(Filter):
    """reference: vsink_nullsink.c — swallow frames."""
    NAME = "nullsink"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return []


@register_filter
class ANullSinkFilter(NullSinkFilter):
    NAME = "anullsink"
    TYPE = "audio"


@register_filter
class PixDescTestFilter(Filter):
    """reference: vf_pixdesctest.c — repack every plane through the
    descriptor (an identity that exercises the pixdesc layer). The
    canonical formats (the decoders' among them) pass their planes
    through; the others repack on the host, as swscale's packing layer
    does, and go back to the frame's device. Any failure there copies the
    planes, as the JAX filter's catch-all does."""
    NAME = "pixdesctest"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.swscale.packing import (is_canonical, pack,
                                                     unpack)
        out = frame.clone_props()
        if is_canonical(frame.format):
            out.planes = list(frame.planes)
            return [out]
        dev = frame_device(frame)
        host = [plane(p).cpu().numpy() for p in frame.planes]
        try:
            canon, planes = unpack(host, frame.format, frame.width,
                                   frame.height)
            planes = pack(planes, canon, frame.format, frame.width,
                          frame.height)
        except Exception:
            planes = [p.copy() for p in host]
        out.planes = [plane(p).to(dev) for p in planes]
        return [out]


@register_filter
class HwUploadFilter(Filter):
    """reference: vf_hwupload.c — host -> device transfer, to the
    graph's device."""
    NAME = "hwupload"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [frame.to_device(hwdevice.device(self.device))]


@register_filter
class HwDownloadFilter(Filter):
    """reference: vf_hwdownload.c — device -> host transfer: the planes
    become numpy arrays, and the filters after it run on the CPU."""
    NAME = "hwdownload"

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [frame.to_host()]


@register_filter
class FramePackFilter(Filter):
    """reference: vf_framepack.c — pack a left/right view pair into a
    stereo-3D frame: sbs (:256 horizontal), columns (:258 interleaved
    horizontal), tab (:261 vertical), lines (:264 interleaved
    vertical), frameseq (:300 double-rate alternation).  The right
    view arrives on pad 1 via push_secondary."""
    NAME = "framepack"
    N_INPUTS = 2
    OPTIONS = [Option("format", "packing mode (sbs/tab/frameseq/"
                      "lines/columns)", "string", "sbs")]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._right: List[Frame] = []
        self._double_pts = None

    def init(self):
        if self.format not in ("sbs", "tab", "frameseq", "lines",
                               "columns"):
            raise AVError(EINVAL, f"framepack: unknown mode "
                                  f"{self.format!r}")

    def push_secondary(self, frame: Frame):
        self._right.append(frame)

    @staticmethod
    def _col_interleave(l, r, chroma):
        if chroma:
            # chroma columns are averaged then duplicated (:176)
            m = _u8((l.to(torch.int32) + r.to(torch.int32)) // 2)
            return torch.stack([m, m], dim=-1).reshape(l.shape[0], -1)
        return torch.stack([l, r], dim=-1).reshape(l.shape[0], -1)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if not self._right:
            raise AVError(EINVAL, "framepack: missing right view")
        right = self._right.pop(0)
        mode = self.format
        if mode == "frameseq":
            if self._double_pts is None:
                self._double_pts = frame.pts if frame.pts is not None \
                    else 0
            frame.pts = self._double_pts
            self._double_pts += 1
            right.pts = self._double_pts
            self._double_pts += 1
            return [frame, right]
        out = frame.clone_props()
        planes = []
        for p_idx, (lp, rp) in enumerate(zip(frame.planes, right.planes)):
            l = plane(lp)
            r = plane(rp).to(l.device)
            chroma = p_idx in (1, 2)
            if mode == "sbs":
                planes.append(torch.cat([l, r], dim=1))
            elif mode == "tab":
                planes.append(torch.cat([l, r], dim=0))
            elif mode == "lines":
                planes.append(torch.stack([l, r], dim=1).reshape(
                    l.shape[0] * 2, l.shape[1]))
            else:   # columns
                planes.append(self._col_interleave(l, r, chroma))
        out.planes = planes
        if mode in ("sbs", "columns"):
            out.width = frame.width * 2
        else:
            out.height = frame.height * 2
        out.stereo3d = mode
        return [out]


@register_filter
class BufferFilter(Filter):
    """reference: vsrc_buffer (buffer.c) — programmatic video entry
    node; the push-graph source link plays that role, the filter
    passes frames through (options accepted for graph-spec parity)."""
    NAME = "buffer"
    OPTIONS = [
        Option("video_size", "WxH", "string", ""),
        Option("width", "width", "int", 0, 0, 1 << 14),
        Option("height", "height", "int", 0, 0, 1 << 14),
        Option("pix_fmt", "pixel format", "string", ""),
        Option("time_base", "pts timebase", "string", ""),
        Option("frame_rate", "frame rate", "string", ""),
        Option("sar", "sample aspect", "string", ""),
    ]


@register_filter
class BufferSinkFilter(Filter):
    """reference: buffersink.c — programmatic exit node; the graph
    sink link plays that role here."""
    NAME = "buffersink"


@register_filter
class HwMapFilter(Filter):
    """reference: vf_hwmap.c role — map frames between memory domains;
    with one device domain this is the identity (hwupload and hwdownload
    move frames)."""
    NAME = "hwmap"
    OPTIONS = [Option("mode", "read/write/direct", "string", "")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [frame]
