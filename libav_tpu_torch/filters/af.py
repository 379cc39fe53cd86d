"""Audio filters (reference: libavfilter/af_*.c — af_resample.c wraps
avresample :205, af_volume.c, af_amix.c, af_channelmap.c).

The JAX package's audio filters (libav_tpu/filters/af.py), copied: host
numpy over the sample planes that the port's audio decoders hand out,
with the port's avresample for the conversions."""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.rational import NOPTS_VALUE
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.samplefmt import is_planar
from libav_tpu_torch.filters.graph import Filter, register_filter


@register_filter
class ANullFilter(Filter):
    """reference: af_anull.c"""
    NAME = "anull"
    TYPE = "audio"


@register_filter
class AResampleFilter(Filter):
    """reference: af_resample.c — rate/format/layout conversion."""
    NAME = "aresample"
    TYPE = "audio"
    OPTIONS = [
        Option("rate", "output sample rate", "int", 0, 0, 1 << 24),
        Option("fmt", "output sample format", "string", ""),
    ]

    def configure(self, frame: Frame):
        from libav_tpu_torch.avresample import AudioResampler
        self._r = AudioResampler(
            in_sample_rate=frame.sample_rate,
            out_sample_rate=self.rate or frame.sample_rate,
            in_sample_fmt=frame.format,
            out_sample_fmt=self.fmt or frame.format,
            in_channel_layout=frame.channel_layout or (1 if frame.channels == 1 else 3),
            out_channel_layout=frame.channel_layout or (1 if frame.channels == 1 else 3),
        ).open()

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [self._r.convert(frame)]


@register_filter
class VolumeFilter(Filter):
    """reference: af_volume.c"""
    NAME = "volume"
    TYPE = "audio"
    OPTIONS = [Option("volume", "gain factor", "float", 1.0, 0.0, 1000.0)]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        out = frame.clone_props()
        g = self.volume
        planes = []
        for p in frame.planes:
            a = np.asarray(p)
            if np.issubdtype(a.dtype, np.integer):
                info = np.iinfo(a.dtype)
                planes.append(np.clip(np.round(a.astype(np.float64) * g),
                                      info.min, info.max).astype(a.dtype))
            else:
                planes.append((a * g).astype(a.dtype))
        out.planes = planes
        return [out]


@register_filter
class AMixFilter(Filter):
    """reference: af_amix.c — averages its inputs.  In a DAG the pad>=1
    frames arrive via push_secondary and are mixed sample-wise with the
    main input; in a linear chain it mixes one frame's channels down."""
    NAME = "amix"
    TYPE = "audio"
    N_INPUTS = 2

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._side: List[Frame] = []

    def push_secondary(self, frame: Frame):
        self._side.append(frame)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if self._side:
            srcs = [frame] + self._side
            self._side = []
            n = min(len(np.asarray(f.planes[0]).reshape(-1))
                    for f in srcs)
            a0 = np.asarray(frame.planes[0]).reshape(-1)[:n]
            acc = np.mean([np.asarray(f.planes[0], dtype=np.float64)
                           .reshape(-1)[:n] for f in srcs], axis=0)
            if np.issubdtype(a0.dtype, np.integer):
                info = np.iinfo(a0.dtype)
                acc = np.clip(np.round(acc), info.min, info.max)
            out = frame.clone_props()
            out.planes = [acc.astype(a0.dtype)]
            return [out]
        if len(frame.planes) <= 1:
            return [frame]
        out = frame.clone_props()
        acc = np.mean([np.asarray(p, dtype=np.float64)
                       for p in frame.planes], axis=0)
        a0 = np.asarray(frame.planes[0])
        if np.issubdtype(a0.dtype, np.integer):
            info = np.iinfo(a0.dtype)
            acc = np.clip(np.round(acc), info.min, info.max)
        out.planes = [acc.astype(a0.dtype)]
        out.channels = 1
        out.channel_layout = 4
        return [out]


@register_filter
class ChannelMapFilter(Filter):
    """reference: af_channelmap.c — 'map=1|0' reorders planar channels."""
    NAME = "channelmap"
    TYPE = "audio"
    OPTIONS = [Option("map", "pipe-separated source indices", "string", "")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if not self.map:
            return [frame]
        order = [int(x) for x in self.map.split("|")]
        out = frame.clone_props()
        out.planes = [frame.planes[i] for i in order]
        out.channels = len(order)
        return [out]


@register_filter
class ATrimFilter(Filter):
    """reference: af_atrim/trim — sample-count based trim."""
    NAME = "atrim"
    TYPE = "audio"
    OPTIONS = [
        Option("start_sample", "", "int64", 0, 0, 1 << 60),
        Option("end_sample", "", "int64", 1 << 60, 0, 1 << 62),
    ]

    def configure(self, frame):
        self._pos = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        n = frame.nb_samples
        lo = max(self._pos, self.start_sample)
        hi = min(self._pos + n, self.end_sample)
        self._pos += n
        if hi <= lo:
            return []
        a = lo - (self._pos - n)
        b = hi - (self._pos - n)
        if a == 0 and b == n:
            return [frame]
        out = frame.clone_props()
        if is_planar(frame.format):
            out.planes = [np.asarray(p)[a:b] for p in frame.planes]
        else:
            ch = frame.channels
            out.planes = [np.asarray(frame.planes[0])[a * ch:b * ch]]
        out.nb_samples = b - a
        return [out]


@register_filter
class AFormatFilter(Filter):
    """reference: af_aformat.c — constrain/convert sample format and
    rate (conversion via the avresample core when needed)."""
    NAME = "aformat"
    TYPE = "audio"
    OPTIONS = [
        Option("sample_fmts", "target sample format", "string", ""),
        Option("sample_rates", "target sample rate", "int", 0, 0,
               768000),
    ]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        fmt = self.sample_fmts.split("|")[0] if self.sample_fmts else ""
        rate = self.sample_rates
        if (not fmt or frame.format == fmt) and \
                (not rate or frame.sample_rate == rate):
            return [frame]
        from libav_tpu_torch.avresample import AudioResampler
        r = getattr(self, "_conv", None)
        if r is None:
            lay = frame.channel_layout or (1 if frame.channels == 1
                                           else 3)
            r = AudioResampler(
                in_sample_rate=frame.sample_rate,
                out_sample_rate=rate or frame.sample_rate,
                in_sample_fmt=frame.format,
                out_sample_fmt=fmt or frame.format,
                in_channel_layout=lay,
                out_channel_layout=lay).open()
            self._conv = r
        return [r.convert(frame)]


@register_filter
class ASetPtsFilter(Filter):
    """reference: af_asetpts (setpts.c audio instance)."""
    NAME = "asetpts"
    TYPE = "audio"
    OPTIONS = [Option("expr", "pts expression", "string", "PTS")]

    def configure(self, frame):
        self._n = 0
        self._prev = None

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.avutil.eval import expr_eval
        out = frame.clone_props()
        out.planes = list(frame.planes)
        pts = frame.pts if frame.pts is not None else 0
        env = {"PTS": pts, "N": self._n, "NB_SAMPLES": frame.nb_samples,
               "SAMPLE_RATE": frame.sample_rate,
               "PREV_OUTPTS": self._prev if self._prev is not None
               else 0}
        out.pts = int(expr_eval(self.expr, env))
        self._prev = out.pts
        self._n += 1
        return [out]


@register_filter
class ASetTbFilter(Filter):
    """reference: af_asettb (settb.c audio instance)."""
    NAME = "asettb"
    TYPE = "audio"
    OPTIONS = [Option("tb", "time base expression", "string", "intb")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        from libav_tpu_torch.avutil.rational import Rational
        out = frame.clone_props()
        out.planes = list(frame.planes)
        tb = self.tb
        if tb in ("intb", "AVTB"):
            if tb == "AVTB":
                new = Rational(1, 1000000)
            else:
                return [out]
        elif "/" in tb:
            n, d = tb.split("/")
            new = Rational(int(n), int(d))
        else:
            new = Rational(1, int(tb))
        if out.pts is not None and out.time_base and out.time_base.den:
            out.pts = out.pts * out.time_base.num * new.den // \
                (out.time_base.den * new.num)
        out.time_base = new
        return [out]


@register_filter
class AShowInfoFilter(Filter):
    """reference: af_ashowinfo.c — per-frame log line with an adler32
    plane checksum."""
    NAME = "ashowinfo"
    TYPE = "audio"

    def configure(self, frame):
        self._n = 0

    def filter_frame(self, frame: Frame) -> List[Frame]:
        import sys

        from libav_tpu_torch.avutil.crc import adler32
        sums = [adler32(np.ascontiguousarray(p).tobytes(), 0)
                for p in frame.planes]
        sys.stderr.write(
            f"[ashowinfo] n:{self._n} pts:{frame.pts} "
            f"nb_samples:{frame.nb_samples} rate:{frame.sample_rate} "
            f"fmt:{frame.format} channels:{frame.channels} "
            f"checksums:[{' '.join('%08X' % s for s in sums)}]\n")
        self._n += 1
        return [frame]


@register_filter
class ASplitFilter(Filter):
    """reference: split.c asplit — identity; the DAG executor fans out."""
    NAME = "asplit"
    TYPE = "audio"
    OPTIONS = [Option("outputs", "number of outputs", "int", 2, 1, 16)]


@register_filter
class AFifoFilter(Filter):
    """reference: fifo.c afifo — a pass-through buffer (our push graph
    has no pull scheduling, so identity preserves semantics)."""
    NAME = "afifo"
    TYPE = "audio"


@register_filter
class ASyncTsFilter(Filter):
    """reference: af_asyncts.c — audio timestamp sync: inserts silence
    for gaps / drops samples on overlap so output pts stay contiguous
    (min_delta compensation path)."""
    NAME = "asyncts"
    TYPE = "audio"
    OPTIONS = [
        Option("min_delta", "resync threshold in samples", "int", 100,
               0, 1 << 30),
    ]

    def configure(self, frame):
        self._next = None

    def filter_frame(self, frame: Frame) -> List[Frame]:
        if frame.pts is None or frame.pts == NOPTS_VALUE:
            return [frame]
        if self._next is None:
            self._next = frame.pts + frame.nb_samples
            return [frame]
        delta = frame.pts - self._next
        out = frame.clone_props()
        out.planes = list(frame.planes)
        if abs(delta) < self.min_delta:
            out.pts = self._next          # snap small drift
        elif delta > 0:
            # gap: prepend silence (packed + planar layouts)
            if is_planar(frame.format):
                out.planes = [np.concatenate(
                    [np.zeros((delta,) + np.asarray(p).shape[1:],
                              np.asarray(p).dtype), np.asarray(p)])
                    for p in frame.planes]
            else:
                ch = max(frame.channels, 1)
                p = np.asarray(frame.planes[0])
                out.planes = [np.concatenate(
                    [np.zeros(delta * ch, p.dtype), p])]
            out.nb_samples = frame.nb_samples + delta
            out.pts = self._next
        else:
            drop = min(-delta, frame.nb_samples)
            if is_planar(frame.format):
                out.planes = [np.asarray(p)[drop:]
                              for p in frame.planes]
            else:
                ch = max(frame.channels, 1)
                out.planes = [np.asarray(frame.planes[0])[drop * ch:]]
            out.nb_samples = frame.nb_samples - drop
            out.pts = self._next
            if out.nb_samples == 0:
                self._next += 0
                return []
        self._next = out.pts + out.nb_samples
        return [out]


@register_filter
class ResampleFilter(AResampleFilter):
    """reference: af_resample.c — the avresample-backed converter (same
    core as aresample here)."""
    NAME = "resample"


@register_filter
class JoinFilter(Filter):
    """reference: af_join.c — merge N single-channel (or few-channel)
    inputs into one multi-channel frame; pad>=1 inputs arrive via
    push_secondary in the DAG executor."""
    NAME = "join"
    TYPE = "audio"
    N_INPUTS = 2
    OPTIONS = [Option("inputs", "number of inputs", "int", 2, 2, 16)]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._side: List[Frame] = []

    def push_secondary(self, frame: Frame):
        self._side.append(frame)

    def filter_frame(self, frame: Frame) -> List[Frame]:
        srcs = [frame] + self._side
        self._side = []
        if len(srcs) == 1:
            return [frame]
        n = min(f.nb_samples for f in srcs)
        chans = []
        for f in srcs:
            p = np.asarray(f.planes[0])
            if is_planar(f.format):
                for c in range(p.shape[0] if p.ndim > 1 else 1):
                    chans.append((p[c] if p.ndim > 1 else p)[:n])
            else:
                ch = max(f.channels, 1)
                q = p.reshape(-1, ch)
                for c in range(ch):
                    chans.append(q[:n, c])
        out = frame.clone_props()
        out.channels = len(chans)
        out.nb_samples = n
        if is_planar(frame.format):
            out.planes = [np.stack(chans)]
        else:
            out.planes = [np.stack(chans, axis=-1).ravel()]
        return [out]


@register_filter
class ChannelSplitFilter(Filter):
    """reference: af_channelsplit.c — one mono output per input
    channel; frame i routes to output pad i (PER_PAD_OUTPUT)."""
    NAME = "channelsplit"
    TYPE = "audio"
    PER_PAD_OUTPUT = True
    OPTIONS = [Option("channel_layout", "input layout", "string",
                      "stereo")]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        p = np.asarray(frame.planes[0])
        if is_planar(frame.format):
            chans = ([p[c] for c in range(p.shape[0])] if p.ndim > 1
                     else [p])
        else:
            n = max(frame.channels, 1)
            q = p.reshape(-1, n)
            chans = [np.ascontiguousarray(q[:, c]) for c in range(n)]
        outs = []
        for c, data in enumerate(chans):
            o = frame.clone_props()
            o.channels = 1
            o.channel_layout = 4      # FL -> mono-ish single channel
            o.planes = [data]
            outs.append(o)
        return outs


@register_filter
class CompandFilter(Filter):
    """reference: af_compand.c — compressor/expander.

    Transcription of config_output's segment construction (soft-knee
    quadratics af_compand.c:338-520), the attack/decay one-pole
    envelope (update_volume :153) and the piecewise transfer
    (get_volume :162).  fltp only, like the reference."""
    NAME = "compand"
    TYPE = "audio"
    OPTIONS = [
        Option("attacks", "volume-rise times per channel", "string",
               "0.3"),
        Option("decays", "volume-fall times per channel", "string",
               "0.8"),
        Option("points", "transfer points dB in/out", "string",
               "-70/-70|-60/-20"),
        Option("soft-knee", "knee radius dB", "float", 0.01, 0.01, 900),
        Option("gain", "output gain dB", "float", 0.0, -900, 900),
        Option("volume", "initial volume dB", "float", 0.0, -900, 0),
        Option("delay", "look-ahead seconds", "float", 0.0, 0, 20),
    ]

    def configure(self, frame: Frame):
        import math
        rate = frame.sample_rate
        channels = max(frame.channels, 1)
        radius = getattr(self, "soft-knee") * math.log(10) / 20.0
        attacks = [float(t) for t in self.attacks.split("|")]
        decays = [float(t) for t in self.decays.split("|")]
        if len(attacks) != len(decays):
            raise AVError(EINVAL, "compand: #attacks != #decays")
        # segments laid out [even]=knots, [odd]=knee inserts, exactly
        # like the reference's 2*(points+4) float array
        pts = []
        for tok in self.points.split("|"):
            x, y = (float(v) for v in tok.split("/"))
            if pts and pts[-1][0] > x:
                raise AVError(EINVAL, "compand: x must increase")
            pts.append((x, y - x))
        nseg = (len(pts) + 4) * 2
        X = np.zeros(nseg, np.float64)
        Y = np.zeros(nseg, np.float64)
        A = np.zeros(nseg, np.float64)
        B = np.zeros(nseg, np.float64)
        for i, (x, y) in enumerate(pts):
            X[2 * (i + 1)] = x
            Y[2 * (i + 1)] = y
        num = len(pts)
        if num == 0 or X[2 * num] != 0.0:
            num += 1
        # tail-off segment at the start
        X[0] = X[2] - 2 * getattr(self, "soft-knee")
        Y[0] = Y[2]
        num += 1
        # join colinear segments
        i = 2
        while i < num:
            g1 = (Y[2 * (i - 1)] - Y[2 * (i - 2)]) * \
                 (X[2 * i] - X[2 * (i - 1)])
            g2 = (Y[2 * i] - Y[2 * (i - 1)]) * \
                 (X[2 * (i - 1)] - X[2 * (i - 2)])
            if abs(g1 - g2) != 0.0:
                i += 1
                continue
            num -= 1
            i -= 1
            for j in range(i, num):
                X[2 * j], Y[2 * j] = X[2 * (j + 1)], Y[2 * (j + 1)]
            i += 1
        ln10_20 = math.log(10) / 20
        i = 0
        while i == 0 or X[i - 2] != 0.0:
            Y[i] += self.gain
            X[i] *= ln10_20
            Y[i] *= ln10_20
            i += 2
        # soft-knee quadratic inserts between adjacent linear pieces
        i = 4
        while X[i - 2] != 0.0:
            A[i - 4] = 0.0
            B[i - 4] = (Y[i - 2] - Y[i - 4]) / (X[i - 2] - X[i - 4])
            A[i - 2] = 0.0
            B[i - 2] = (Y[i] - Y[i - 2]) / (X[i] - X[i - 2])
            theta = math.atan2(Y[i - 2] - Y[i - 4], X[i - 2] - X[i - 4])
            ln = math.hypot(X[i - 2] - X[i - 4], Y[i - 2] - Y[i - 4])
            r = min(radius, ln)
            X[i - 3] = X[i - 2] - r * math.cos(theta)
            Y[i - 3] = Y[i - 2] - r * math.sin(theta)
            theta = math.atan2(Y[i] - Y[i - 2], X[i] - X[i - 2])
            ln = math.hypot(X[i] - X[i - 2], Y[i] - Y[i - 2])
            r = min(radius, ln / 2)
            x = X[i - 2] + r * math.cos(theta)
            y = Y[i - 2] + r * math.sin(theta)
            cx = (X[i - 3] + X[i - 2] + x) / 3
            cy = (Y[i - 3] + Y[i - 2] + y) / 3
            X[i - 2], Y[i - 2] = x, y
            in1, out1 = cx - X[i - 3], cy - Y[i - 3]
            in2, out2 = X[i - 2] - X[i - 3], Y[i - 2] - Y[i - 3]
            A[i - 3] = (out2 / in2 - out1 / in1) / (in2 - in1)
            B[i - 3] = out1 / in1 - A[i - 3] * in1
            i += 2
        X[i - 3] = 0.0
        Y[i - 3] = Y[i - 2]
        self._segs = (X.astype(np.float32), Y.astype(np.float32),
                      A.astype(np.float32), B.astype(np.float32), i - 2)
        self._in_min = np.float32(math.exp(X[1]))
        self._out_min = np.float32(math.exp(Y[1]))
        def coef(t):
            return (1.0 - math.exp(-1.0 / (rate * t))
                    if t > 1.0 / rate else 1.0)
        # channels beyond the provided lists keep the zeroed default,
        # which the clamp turns into an instant (1.0) coefficient —
        # af_compand.c mallocz + config_output fill
        att = [coef(attacks[c] if c < len(attacks) else 0.0)
               for c in range(channels)]
        dec = [coef(decays[c] if c < len(decays) else 0.0)
               for c in range(channels)]
        self._attack = np.array(att, np.float32)
        self._decay = np.array(dec, np.float32)
        self._volume = np.full(channels, 10.0 ** (self.volume / 20),
                               np.float32)
        self._delay_samples = int(self.delay * rate)
        self._dbuf = None
        self._dcount = 0
        self._dindex = 0
        self._rate = rate
        self._pts = None

    def _get_volume(self, v: float) -> float:
        import math
        X, Y, A, B, _ = self._segs
        if v < self._in_min:
            return float(self._out_min)
        in_log = np.float32(math.log(float(v)))
        i = 1
        while i < len(X) and in_log > X[i]:
            i += 1
        i -= 1
        d = np.float32(in_log - X[i])
        out_log = np.float32(Y[i] + d * (A[i] * d + B[i]))
        return float(np.float32(math.exp(float(out_log))))

    def _to_fltp(self, frame: Frame):
        p = np.asarray(frame.planes[0])
        n = max(frame.channels, 1)
        if is_planar(frame.format):
            ch = p.reshape(n, -1) if p.ndim > 1 or n == 1 else p
            if frame.format == "fltp":
                return ch.reshape(n, -1).astype(np.float32), "fltp"
            scale = np.float32(1 << 15) if frame.format == "s16p" else \
                np.float32(1 << 31)
            return ch.reshape(n, -1).astype(np.float32) / scale, \
                frame.format
        q = p.reshape(-1, n).T
        if frame.format == "flt":
            return q.astype(np.float32), "flt"
        scale = np.float32(1 << 15) if frame.format == "s16" else \
            np.float32(1 << 31)
        return q.astype(np.float32) / scale, frame.format

    def _from_fltp(self, out: Frame, ch: np.ndarray, src_fmt: str):
        if src_fmt in ("fltp",):
            out.planes = [ch]
        elif src_fmt == "flt":
            out.planes = [np.ascontiguousarray(ch.T).ravel()]
        elif src_fmt in ("s16", "s16p"):
            s = np.clip(np.rint(ch * (1 << 15)), -32768, 32767
                        ).astype(np.int16)
            out.planes = [s if src_fmt == "s16p"
                          else np.ascontiguousarray(s.T).ravel()]
        else:
            s = np.clip(np.rint(ch * np.float64(1 << 31)),
                        -(1 << 31), (1 << 31) - 1).astype(np.int32)
            out.planes = [s if src_fmt.endswith("p")
                          else np.ascontiguousarray(s.T).ravel()]

    def filter_frame(self, frame: Frame) -> List[Frame]:
        ch, src_fmt = self._to_fltp(frame)
        nch, ns = ch.shape
        if self._delay_samples <= 0:
            dst = np.empty_like(ch)
            for c in range(nch):
                vol = np.float32(self._volume[c])
                a, d = np.float32(self._attack[c]), \
                    np.float32(self._decay[c])
                row = ch[c]
                for i in range(ns):
                    x = row[i]
                    delta = np.float32(abs(x)) - vol
                    vol = np.float32(vol + delta *
                                     (a if delta > 0 else d))
                    dst[c, i] = min(max(
                        x * np.float32(self._get_volume(vol)),
                        np.float32(-1.0)), np.float32(1.0))
                self._volume[c] = vol
            out = frame.clone_props()
            self._from_fltp(out, dst, src_fmt)
            return [out]
        # delayed path (af_compand.c:229 compand_delay)
        if self._dbuf is None:
            self._dbuf = np.zeros((nch, self._delay_samples), np.float32)
        if self._pts is None:
            self._pts = frame.pts if frame.pts is not None else 0
        self._template = frame.clone_props()
        self._src_fmt = src_fmt
        D = self._delay_samples
        out_rows = None
        for c in range(nch):
            vol = np.float32(self._volume[c])
            a, d = np.float32(self._attack[c]), np.float32(self._decay[c])
            count, dindex = self._dcount, self._dindex
            oindex = 0
            for i in range(ns):
                x = ch[c, i]
                delta = np.float32(abs(x)) - vol
                vol = np.float32(vol + delta * (a if delta > 0 else d))
                if count >= D:
                    if out_rows is None:
                        out_rows = np.zeros((nch, ns - i), np.float32)
                        self._out_pts = self._pts
                        self._pts += ns - i
                    out_rows[c, oindex] = min(max(
                        self._dbuf[c, dindex] *
                        np.float32(self._get_volume(vol)),
                        np.float32(-1.0)), np.float32(1.0))
                    oindex += 1
                else:
                    count += 1
                self._dbuf[c, dindex] = x
                dindex = dindex + 1 if dindex + 1 < D else 0
            self._volume[c] = vol
        self._dcount, self._dindex = count, dindex
        if out_rows is None:
            return []
        out = frame.clone_props()
        out.pts = self._out_pts
        out.nb_samples = out_rows.shape[1]
        self._from_fltp(out, out_rows, src_fmt)
        return [out]

    def flush(self) -> List[Frame]:
        # drain the look-ahead buffer (af_compand.c:305 compand_drain)
        outs = []
        while self._delay_samples > 0 and self._dcount > 0 and \
                self._dbuf is not None:
            n = min(2048, self._dcount)
            nch = self._dbuf.shape[0]
            rows = np.zeros((nch, n), np.float32)
            dindex0 = self._dindex
            for c in range(nch):
                dindex = dindex0
                vol = np.float32(self._get_volume(self._volume[c]))
                for i in range(n):
                    rows[c, i] = min(max(self._dbuf[c, dindex] * vol,
                                         np.float32(-1.0)),
                                     np.float32(1.0))
                    dindex = dindex + 1 if dindex + 1 < \
                        self._delay_samples else 0
            self._dindex = dindex
            self._dcount -= n
            f = self._template.clone_props()
            f.pts = self._pts
            f.nb_samples = n
            self._pts += n
            self._from_fltp(f, rows, self._src_fmt)
            outs.append(f)
        return outs


@register_filter
class ABufferFilter(Filter):
    """reference: asrc_abuffer (buffer.c) — the programmatic audio
    entry node; in this push graph the source link plays that role, so
    the filter itself passes frames through."""
    NAME = "abuffer"
    TYPE = "audio"
    OPTIONS = [
        Option("time_base", "pts timebase", "string", ""),
        Option("sample_rate", "sample rate", "int", 0, 0, 1 << 24),
        Option("sample_fmt", "sample format", "string", ""),
        Option("channel_layout", "channel layout", "string", ""),
    ]


@register_filter
class ABufferSinkFilter(Filter):
    """reference: abuffersink (buffersink.c) — programmatic exit node;
    the graph sink link plays that role here."""
    NAME = "abuffersink"
    TYPE = "audio"
