"""Audio resampling, mixing, format conversion (counterpart of
`libav_tpu/avresample`, host numpy as there; reference: libavresample/
— SURVEY.md §2.5: polyphase FIR resampler resample.c:67 build_filter with
phase_count = 1<<phase_shift banks of windowed-sinc taps, per-sample dot
product resample_template.c; mixing matrix audio_mix.c/audio_mix_matrix.c;
conversion audio_convert.c; dithering dither.c).

The whole chain runs in the reference's auto-selected internal sample
format (utils.c:70 — s16/s32/flt/dbl) through the reference-exact
streaming core (refexact.StreamingResampler: same Kaiser bank, mirror
padding, index/frac walk and per-felem accumulator as
resample_template.c), with in_convert -> downmix -> resample -> upmix
-> out_convert ordering like avresample_convert.  Instead of a
per-output-sample scalar dot product, each chunk's output samples are
produced as one batched gather + dot.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.opt import Option, OptionedObject
from libav_tpu_torch.avutil.samplefmt import (is_planar,
                                        channel_layout_nb_channels)


def _fmt_base(fmt: str) -> str:
    return fmt[:-1] if fmt.endswith("p") else fmt


def _convert_fmt(x: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Sample format conversion with the reference's scalar rules
    (audio_convert.c CONV_FUNC table): int->float scales by the exact
    power-of-two reciprocal, float->int is lrint (round-half-even) +
    clip, int widths shift."""
    if src == dst:
        return x
    if src == "u8":
        if dst == "s16":
            return (x.astype(np.int16) - 128) << 8
        if dst == "s32":
            return (x.astype(np.int32) - 128) << 24
        v = (x.astype(np.float64) - 128) / 128.0
        return v.astype(np.float32) if dst == "flt" else v
    if src == "s16":
        if dst == "u8":
            return ((x.astype(np.int16) >> 8) + 128).astype(np.uint8)
        if dst == "s32":
            return x.astype(np.int32) << 16
        v = x.astype(np.float64) / 32768.0
        return v.astype(np.float32) if dst == "flt" else v
    if src == "s32":
        if dst == "u8":
            return ((x >> 24) + 128).astype(np.uint8)
        if dst == "s16":
            return (x >> 16).astype(np.int16)
        v = x.astype(np.float64) / 2147483648.0
        return v.astype(np.float32) if dst == "flt" else v
    # float/double source
    xd = x.astype(np.float64)
    if dst == "u8":
        return np.clip(np.rint(xd * 128.0) + 128, 0, 255).astype(np.uint8)
    if dst == "s16":
        return np.clip(np.rint(xd * 32768.0),
                       -32768, 32767).astype(np.int16)
    if dst == "s32":
        return np.clip(np.rint(xd * 2147483648.0), -(1 << 31),
                       (1 << 31) - 1).astype(np.int64).astype(np.int32)
    return xd.astype(np.float32) if dst == "flt" else xd


class AudioResampler(OptionedObject):
    """reference: avresample.h:106 AVAudioResampleContext +
    avresample_open/convert (avresample.h:46-83)."""

    OPTIONS = [
        Option("in_sample_rate", "", "int", 44100, 1, 2 ** 24),
        Option("out_sample_rate", "", "int", 44100, 1, 2 ** 24),
        Option("in_channel_layout", "", "int64", 3),
        Option("out_channel_layout", "", "int64", 3),
        Option("in_sample_fmt", "", "string", "fltp"),
        Option("out_sample_fmt", "", "string", "fltp"),
        Option("filter_size", "resampling taps", "int", 16, 1, 64),
        Option("phase_shift", "log2 phase count", "int", 10, 0, 16),
        Option("cutoff", "lowpass cutoff", "float", 0.8, 0.01, 1.0),
        # reference options.c:60-63,80-85
        Option("dither_method", "none|rectangular|triangular|"
               "triangular_hp|triangular_ns", "string", "none"),
        Option("center_mix_level", "", "float", math.sqrt(0.5), -32., 32.),
        Option("surround_mix_level", "", "float", math.sqrt(0.5),
               -32., 32.),
        Option("lfe_mix_level", "", "float", 0.0, -32.0, 32.0),
        Option("normalize_mix_level", "", "int", 1, 0, 1),
        Option("matrix_encoding", "0 none / 1 dolby / 2 dplii", "int",
               0, 0, 2),
    ]

    def __init__(self, **opts):
        self.init_defaults()
        for k, v in opts.items():
            self.set_opt(k, v)
        self._opened = False

    def open(self):
        """reference: avresample_open (avresample.h:46)"""
        self._mix_matrix = self._build_mix_matrix()
        self._opened = True
        return self

    # ------------------------------------------------------------------ #

    def _build_mix_matrix(self) -> Optional[np.ndarray]:
        """Channel mixing matrix — the full reference coefficient
        builder (audio_mix_matrix.c avresample_build_matrix): matched
        channels route 1:1, unaccounted positions fold with the
        normative center/surround/LFE levels, optional Dolby/DPL-II
        phase encoding, max-sum normalization."""
        cin = channel_layout_nb_channels(self.in_channel_layout)
        cout = channel_layout_nb_channels(self.out_channel_layout)
        if self.in_channel_layout == self.out_channel_layout:
            return None
        from libav_tpu_torch.avresample.mixmatrix import build_matrix
        try:
            return build_matrix(
                int(self.in_channel_layout), int(self.out_channel_layout),
                center_mix_level=self.center_mix_level,
                surround_mix_level=self.surround_mix_level,
                lfe_mix_level=self.lfe_mix_level,
                normalize=bool(self.normalize_mix_level),
                matrix_encoding=int(self.matrix_encoding))
        except AVError:
            # layouts outside the reference's sane set (it returns
            # PATCHWELCOME): fall back to an input average so odd
            # layouts still convert instead of erroring
            if cin == cout:
                return None
            m = np.full((cout, cin), 1.0 / cin)
            return m

    # ------------------------------------------------------------------ #

    # -- the reference's conversion chain (utils.c avresample_convert):
    #    in_convert -> downmix -> resample -> upmix -> out_convert,
    #    everything in the auto-selected internal sample format -------- #

    _BPS = {"u8": 1, "s16": 2, "s32": 4, "flt": 4, "dbl": 8}

    def _internal_felem(self) -> str:
        """Internal sample format selection (utils.c:70-101)."""
        i = _fmt_base(self.in_sample_fmt)
        o = _fmt_base(self.out_sample_fmt)
        mixing = self._mix_matrix is not None
        max_bps = max(self._BPS[i], self._BPS[o])
        if max_bps <= 2:
            return "s16"
        if mixing:
            return "flt"
        if max_bps <= 4:
            if "s32" in (i, o):
                return "dbl" if "flt" in (i, o) else "s32"
            return "flt"
        return "dbl"

    def _apply_mix(self, x: np.ndarray, felem: str) -> np.ndarray:
        """Mix in the internal format with FLT coefficients (the
        default mix_coeff_type, audio_mix.c MIX_FUNC_GENERIC): float
        sum, int formats round+clip back per sample."""
        m = self._mix_matrix.astype(np.float32)
        if felem == "s16":
            y = m @ x.astype(np.float32)
            return np.clip(np.rint(y), -32768, 32767).astype(np.int16)
        if felem == "s32":
            y = m.astype(np.float64) @ x.astype(np.float64)
            return np.clip(np.rint(y), -(1 << 31),
                           (1 << 31) - 1).astype(np.int32)
        if felem == "dbl":
            return self._mix_matrix @ x
        return m @ x.astype(np.float32)

    def convert(self, frame: Frame) -> Frame:
        """reference: avresample_convert (avresample.h:83)"""
        if not self._opened:
            self.open()
        fmt = frame.format
        ch = frame.channels or len(frame.planes)
        if is_planar(fmt):
            x = np.stack([np.asarray(p) for p in frame.planes])
        else:
            x = np.asarray(frame.planes[0]).reshape(-1, ch).T.copy()
        felem = self._internal_felem()
        x = _convert_fmt(x, _fmt_base(fmt), felem)
        cin = x.shape[0]
        cout = (self._mix_matrix.shape[0]
                if self._mix_matrix is not None else cin)
        if self._mix_matrix is not None and cout < cin:   # downmix first
            x = self._apply_mix(x, felem)
        if self.in_sample_rate != self.out_sample_rate:
            st = getattr(self, "_stream", None)
            if st is None:
                from libav_tpu_torch.avresample.refexact import StreamingResampler
                st = self._stream = StreamingResampler(
                    x.shape[0], self.in_sample_rate, self.out_sample_rate,
                    felem=felem)
            x = st.feed(x)
        if self._mix_matrix is not None and cout >= cin:  # upmix after
            x = self._apply_mix(x, felem)
        return self._emit(x, felem, frame)

    def _emit(self, x: np.ndarray, felem: str, like: Frame) -> Frame:
        """internal -> out_sample_fmt conversion + frame assembly."""
        out_base = _fmt_base(self.out_sample_fmt)
        if (out_base == "s16" and felem in ("flt", "dbl")
                and self.dither_method != "none"):
            dd = getattr(self, "_ditherer", None)
            if dd is None or dd.channels != x.shape[0]:
                from libav_tpu_torch.avresample.dither import Ditherer
                dd = self._ditherer = Ditherer(
                    x.shape[0], self.dither_method, self.out_sample_rate)
            y = dd.quantize(x.astype(np.float32))
        else:
            y = _convert_fmt(x, felem, out_base)
        return self._frame_of(y, like)

    def _frame_of(self, y: np.ndarray, like: Frame) -> Frame:
        ch = y.shape[0]
        out = like.clone_props()
        out.sample_rate = self.out_sample_rate
        out.format = self.out_sample_fmt
        out.channels = ch
        out.channel_layout = self.out_channel_layout
        if is_planar(self.out_sample_fmt):
            out.planes = [y[c].copy() for c in range(ch)]
        else:
            out.planes = [np.ascontiguousarray(y.T).reshape(-1)]
        out.nb_samples = y.shape[1]
        return out

    def flush_resampler(self):
        """Final padding output of the streaming resample core (None
        when inactive or empty) — the avresample_convert(NULL) drain."""
        st = getattr(self, "_stream", None)
        if st is None:
            return None
        x = st.flush()
        if x.shape[1] == 0:
            return None
        cin = x.shape[0]
        if self._mix_matrix is not None and \
                self._mix_matrix.shape[0] >= cin and \
                self._mix_matrix.shape[1] == cin:
            x = self._apply_mix(x, st.felem)      # pending upmix stage
        from libav_tpu_torch.avutil.frame import Frame as _F
        f = _F()
        f.format = self.out_sample_fmt
        f.channels = x.shape[0]
        return self._emit(x, st.felem, f)
