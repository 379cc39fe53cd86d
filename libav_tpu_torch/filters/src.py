"""Source filters (reference: libavfilter/vsrc_testsrc.c, asrc_anullsrc;
the FATE vsynth generators tests/videogen.c / rotozoom.c live here too
since they are the sample-free encode-test sources — SURVEY.md §4 tier 2).

The JAX package's sources (libav_tpu/filters/src.py), copied. The
generators keep their numpy code, so their bytes are the JAX package's;
the video source filters put each frame on the filter's device (the
graph's), and movie decodes on that device. The frame functions
(testsrc_frame, vsynth1_frame, rotozoom_frame, audiogen) return host
frames, and anullsrc's audio stays on the host, as the audio filters do.
"""

from __future__ import annotations

import math

import numpy as np

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.filters.graph import Filter, register_filter


def testsrc_frame(w: int, h: int, n: int, fmt: str = "yuv420p") -> Frame:
    """Moving test pattern (reference: vsrc_testsrc.c testsrc)."""
    f = Frame.alloc_video(w, h, fmt)
    yy, xx = np.mgrid[0:h, 0:w]
    f.planes[0] = ((xx + n * 2) % 256).astype(np.uint8)
    if fmt != "gray":
        ch, cw = f.planes[1].shape
        yy, xx = np.mgrid[0:ch, 0:cw]
        f.planes[1] = ((128 + 64 * np.sin((xx + n) / 10)).astype(np.uint8))
        f.planes[2] = ((128 + 64 * np.cos((yy + n) / 10)).astype(np.uint8))
    f.pts = n
    return f


def vsynth1_frame(w: int, h: int, n: int) -> Frame:
    """Port of the FATE synthetic source generator semantics
    (reference: tests/videogen.c — moving smooth color wheels). Not
    bit-identical to videogen's output; serves the same role: a smooth,
    motion-rich, sample-free encode test source."""
    f = Frame.alloc_video(w, h, "yuv420p")
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cx = w / 2 + w / 4 * math.cos(n * 0.1)
    cy = h / 2 + h / 4 * math.sin(n * 0.13)
    r = np.hypot(xx - cx, yy - cy)
    f.planes[0] = (128 + 100 * np.cos(r / 6 - n * 0.2)).astype(np.uint8)
    ch, cw = f.planes[1].shape
    yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float64)
    f.planes[1] = (128 + 60 * np.sin((xx + n) / 11)).astype(np.uint8)
    f.planes[2] = (128 + 60 * np.cos((yy + 2 * n) / 13)).astype(np.uint8)
    f.pts = n
    return f


def rotozoom_frame(w: int, h: int, n: int) -> Frame:
    """Rotating/zooming checker (reference: tests/rotozoom.c role)."""
    f = Frame.alloc_video(w, h, "yuv420p")
    ang = n * 0.05
    zoom = 1.0 + 0.3 * math.sin(n * 0.08)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = ((xx - w / 2) * math.cos(ang) - (yy - h / 2) * math.sin(ang)) * zoom
    v = ((xx - w / 2) * math.sin(ang) + (yy - h / 2) * math.cos(ang)) * zoom
    f.planes[0] = (((np.floor(u / 8) + np.floor(v / 8)) % 2) * 160 + 48
                   ).astype(np.uint8)
    f.planes[1][:] = 128
    f.planes[2][:] = 128
    f.pts = n
    return f


def audiogen(nb_samples: int, sample_rate: int = 44100, channels: int = 2,
             seed: int = 0) -> Frame:
    """Multi-tone test audio (reference: tests/audiogen.c role)."""
    t = np.arange(nb_samples) / sample_rate
    freqs = [440.0, 880.0, 1320.0]
    x = sum(np.sin(2 * math.pi * fq * t + i) / (i + 1)
            for i, fq in enumerate(freqs)) / 1.85
    f = Frame(nb_samples=nb_samples, sample_rate=sample_rate, format="fltp",
              channels=channels, channel_layout=3 if channels == 2 else 4)
    f.planes = [(x * (0.9 - 0.1 * c)).astype(np.float32)
                for c in range(channels)]
    f.pts = 0
    return f


@register_filter
class TestSrcFilter(Filter):
    """Generator filter: ignores input, used via .generate()"""
    NAME = "testsrc"
    OPTIONS = [
        Option("size", "WxH", "string", "320x240"),
        Option("rate", "frame rate", "rational", Rational(25, 1)),
        Option("duration", "number of frames", "int", 25, 1, 1 << 20),
    ]

    def generate(self):
        dev = hwdevice.device(self.device)
        w, h = (int(x) for x in self.size.lower().split("x"))
        for n in range(self.duration):
            f = testsrc_frame(w, h, n).to_device(dev)
            f.time_base = self.rate.inv()
            yield f


# -- color parsing (reference: libavutil/parseutils.c av_parse_color) -- #

_COLOR_TABLE = {
    "black": (0x00, 0x00, 0x00), "white": (0xFF, 0xFF, 0xFF),
    "red": (0xFF, 0x00, 0x00), "green": (0x00, 0x80, 0x00),
    "lime": (0x00, 0xFF, 0x00), "blue": (0x00, 0x00, 0xFF),
    "yellow": (0xFF, 0xFF, 0x00), "cyan": (0x00, 0xFF, 0xFF),
    "aqua": (0x00, 0xFF, 0xFF), "magenta": (0xFF, 0x00, 0xFF),
    "fuchsia": (0xFF, 0x00, 0xFF), "gray": (0x80, 0x80, 0x80),
    "grey": (0x80, 0x80, 0x80), "silver": (0xC0, 0xC0, 0xC0),
    "maroon": (0x80, 0x00, 0x00), "olive": (0x80, 0x80, 0x00),
    "purple": (0x80, 0x00, 0x80), "teal": (0x00, 0x80, 0x80),
    "navy": (0x00, 0x00, 0x80), "orange": (0xFF, 0xA5, 0x00),
    "pink": (0xFF, 0xC0, 0xCB), "brown": (0xA5, 0x2A, 0x2A),
    "violet": (0xEE, 0x82, 0xEE), "gold": (0xFF, 0xD7, 0x00),
}


def parse_color(s: str):
    """'name', '#RRGGBB' or '0xRRGGBB[AA]' -> (r, g, b) (reference:
    parseutils.c:366 av_parse_color, name table :155)."""
    s = s.strip()
    if s.startswith("#") or s.lower().startswith("0x"):
        hexs = s[1:] if s.startswith("#") else s[2:]
        if len(hexs) not in (6, 8):
            raise ValueError(f"bad color {s!r}")
        v = int(hexs[:6], 16)
        return ((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF)
    try:
        return _COLOR_TABLE[s.lower()]
    except KeyError:
        raise ValueError(f"unknown color {s!r}")


def rgb_to_yuv_ccir(r: int, g: int, b: int):
    """Limited-range RGB->YUV (reference: libavutil/colorspace.h:110
    RGB_TO_Y_CCIR / _U_CCIR / _V_CCIR, SCALEBITS 10)."""
    def fix(x):
        return int(x * 1024 + 0.5)
    half = 512
    y = (fix(0.29900 * 219 / 255) * r + fix(0.58700 * 219 / 255) * g +
         fix(0.11400 * 219 / 255) * b + (half + (16 << 10))) >> 10
    u = ((-fix(0.16874 * 224 / 255) * r - fix(0.33126 * 224 / 255) * g +
          fix(0.50000 * 224 / 255) * b + half - 1) >> 10) + 128
    v = ((fix(0.50000 * 224 / 255) * r - fix(0.41869 * 224 / 255) * g -
          fix(0.08131 * 224 / 255) * b + half - 1) >> 10) + 128
    return y, u, v


class _VideoSource(Filter):
    """Shared size/rate/duration plumbing for generator sources."""
    OPTIONS = [
        Option("size", "WxH", "string", "320x240"),
        Option("rate", "frame rate", "rational", Rational(25, 1)),
        Option("duration", "number of frames", "int", 25, 1, 1 << 20),
    ]

    def _dims(self):
        return (int(x) for x in self.size.lower().split("x"))

    def _frame(self, w: int, h: int, n: int) -> Frame:
        raise NotImplementedError

    def generate(self):
        dev = hwdevice.device(self.device)
        w, h = self._dims()
        for n in range(self.duration):
            f = self._frame(w, h, n).to_device(dev)
            f.pts = n
            f.time_base = self.rate.inv()
            yield f


@register_filter
class NullSrcFilter(_VideoSource):
    """reference: vsrc_nullsrc.c — frames whose content is unspecified
    (zero-filled here, deterministically)."""
    NAME = "nullsrc"

    def _frame(self, w, h, n):
        return Frame.alloc_video(w, h, "yuv420p")


@register_filter
class ColorSrcFilter(_VideoSource):
    """reference: vsrc_color.c — constant-color frames; the fill is
    ff_fill_line_with_color's CCIR limited-range conversion."""
    NAME = "color"
    OPTIONS = [
        Option("color", "fill color", "string", "black"),
        Option("size", "WxH", "string", "320x240"),
        Option("rate", "frame rate", "rational", Rational(25, 1)),
        Option("duration", "number of frames", "int", 25, 1, 1 << 20),
    ]

    def _frame(self, w, h, n):
        r, g, b = parse_color(self.color)
        y, u, v = rgb_to_yuv_ccir(r, g, b)
        f = Frame.alloc_video(w & ~1, h & ~1, "yuv420p")
        f.planes[0][:] = y
        f.planes[1][:] = u
        f.planes[2][:] = v
        f.sample_aspect_ratio = Rational(1, 1)
        return f


@register_filter
class RgbTestSrcFilter(_VideoSource):
    """reference: vsrc_testsrc.c:421 rgbtest_fill_picture — R/G/B
    gradient bands (c = 256*x/w), rgb24 output."""
    NAME = "rgbtestsrc"

    def _frame(self, w, h, n):
        f = Frame()
        f.width, f.height, f.format = w, h, "rgb24"
        x = np.arange(w)
        c = (256 * x // w).astype(np.uint8)
        px = np.zeros((h, w, 3), np.uint8)
        for y_ in range(h):
            if 3 * y_ < h:
                px[y_, :, 0] = c
            elif 3 * y_ < 2 * h:
                px[y_, :, 1] = c
            else:
                px[y_, :, 2] = c
        f.planes = [px.reshape(h, -1)]
        return f


@register_filter
class ANullSrcFilter(Filter):
    """reference: asrc_anullsrc.c — silent audio frames."""
    NAME = "anullsrc"
    TYPE = "audio"
    OPTIONS = [
        Option("sample_rate", "sample rate", "int", 44100, 1, 1 << 24),
        Option("channel_layout", "layout", "string", "stereo"),
        Option("nb_samples", "samples per frame", "int", 1024, 1,
               1 << 20),
        Option("duration", "number of frames", "int", 25, 1, 1 << 20),
    ]

    def generate(self):
        ch = 1 if self.channel_layout == "mono" else 2
        for n in range(self.duration):
            f = Frame(format="s16", nb_samples=self.nb_samples,
                      sample_rate=self.sample_rate, channels=ch,
                      channel_layout=4 if ch == 1 else 3,
                      pts=n * self.nb_samples)
            f.planes = [np.zeros(self.nb_samples * ch, np.int16)]
            f.time_base = Rational(1, self.sample_rate)
            yield f


@register_filter
class MovieFilter(Filter):
    """reference: vsrc_movie.c — decode a file's video stream as a
    filter source, with the port's decoder on the filter's device."""
    NAME = "movie"
    OPTIONS = [
        Option("filename", "input file", "string", ""),
        Option("format_name", "force input format", "string", ""),
        Option("stream_index", "stream to decode", "int", -1, -1, 64),
        Option("seek_point", "start offset seconds", "float", 0.0, 0,
               1e9),
        Option("loop", "play count", "int", 1, 0, 1 << 20),
    ]

    def generate(self):
        from libav_tpu_torch.formats import open_input
        from libav_tpu_torch.codecs import find_decoder
        from libav_tpu_torch.avutil.error import AVError as _E
        from libav_tpu_torch.codecs.api import MediaType
        dev = hwdevice.device(self.device)
        loops = self.loop or 1
        for _ in range(loops):
            ic = open_input(self.filename,
                            self.format_name or None)
            want = self.stream_index
            if want < 0:
                vids = [s.index for s in ic.streams
                        if s.codecpar.codec_type == MediaType.VIDEO]
                want = vids[0] if vids else 0
            st = ic.streams[want]
            dec = find_decoder(st.codecpar.codec_id)(st.codecpar,
                                                     device=dev).open()
            for pkt in ic.packets():
                if pkt.stream_index != want:
                    continue
                dec.send_packet(pkt)
                while True:
                    try:
                        yield dec.receive_frame()
                    except _E:
                        break
            try:
                dec.send_packet(None)
                while True:
                    yield dec.receive_frame()
            except _E:
                pass
