"""Reference-bit-exact audio resampling core (the semantics of
libavresample's scalar s16 path: resample.c build_filter Kaiser bank,
resample_template.c resample_one_s16 arithmetic, ff_audio_resample's
mirror padding and index/frac walk with the reduced increment).

Filter bank, the rational index walk and the FIR all run on the host
(counterpart of `libav_tpu/avresample/refexact.py`, less its one-shot
`resample_s16_exact`, which nothing calls)."""

from __future__ import annotations

import functools
import math

import numpy as np


def _bessel(x: float) -> float:
    """0th order modified Bessel I0 (resample.c bessel), iterated to
    convergence exactly like the reference."""
    v, lastv, t = 1.0, 0.0, 1.0
    x = x * x / 4
    i = 1
    while v != lastv:
        lastv = v
        t *= x / (i * i)
        v += t
        i += 1
    return v


@functools.lru_cache(maxsize=32)
def _build_filter_bank(in_rate: int, out_rate: int, felem: str,
                       filter_size: int = 16, phase_shift: int = 10,
                       cutoff: float = 0.8, kaiser_beta: int = 9):
    """(bank (phases, taps), filter_length) — resample.c:67
    build_filter; `felem` picks the set_filter_* quantization:
    's16' -> av_clip_int16(lrint(v * (1 << 15))), 'flt' -> (float)v,
    'dbl' -> v."""
    factor = min(out_rate * cutoff / in_rate, 1.0)
    phase_count = 1 << phase_shift
    tap_count = max(int(math.ceil(filter_size / factor)), 1)
    center = (tap_count - 1) // 2
    tabs = np.zeros((phase_count, tap_count), np.float64)
    for ph in range(phase_count):
        tab = np.zeros(tap_count)
        norm = 0.0
        for i in range(tap_count):
            x = math.pi * ((i - center) - ph / phase_count) * factor
            y = 1.0 if x == 0 else math.sin(x) / x
            w = 2.0 * x / (factor * tap_count * math.pi)
            y *= _bessel(kaiser_beta * math.sqrt(max(1 - w * w, 0.0)))
            tab[i] = y
            norm += y
        tabs[ph] = tab / norm
    if felem == "s16":
        q = np.round(tabs * (1 << 15))
        return np.clip(q, -32768, 32767).astype(np.int16), tap_count
    if felem == "s32":
        q = np.round(tabs * (1 << 30))
        return np.clip(q, -(1 << 31), (1 << 31) - 1).astype(np.int64) \
            .astype(np.int32), tap_count
    if felem == "flt":
        return tabs.astype(np.float32), tap_count
    return tabs, tap_count


def build_filter_bank_s16(in_rate: int, out_rate: int,
                          filter_size: int = 16, phase_shift: int = 10,
                          cutoff: float = 0.8,
                          kaiser_beta: int = 9):
    return _build_filter_bank(in_rate, out_rate, "s16", filter_size,
                              phase_shift, cutoff, kaiser_beta)


def _walk(nsrc: int, in_rate: int, out_rate: int, flen: int,
          phase_shift: int = 10):
    """The index/frac walk of resample() — returns (sample_index[],
    phase[]) for every producible output given nsrc buffered samples."""
    phase_count = 1 << phase_shift
    g = math.gcd(out_rate, in_rate * phase_count)
    src_incr = out_rate // g
    dst_incr_total = (in_rate * phase_count) // g
    dst_incr = dst_incr_total // src_incr
    dst_incr_frac = dst_incr_total % src_incr
    idxs, phases = [], []
    index = 0
    frac = 0
    while True:
        sample_index = index >> phase_shift
        if sample_index + flen > nsrc:
            break
        idxs.append(sample_index)
        phases.append(index & (phase_count - 1))
        frac += dst_incr_frac
        index += dst_incr
        if frac >= src_incr:
            frac -= src_incr
            index += 1
    return (np.array(idxs, np.int64), np.array(phases, np.int64))


class StreamingResampler:
    """Stateful streaming resampler with the reference's exact buffer
    semantics (ff_audio_resample): prime with the initial mirror
    padding, walk (index, frac) across calls, drop consumed samples,
    and emit the final mirrored padding on flush.  `felem` selects the
    internal element type like the reference's internal_sample_fmt
    (resample_template.c instantiations): 's16' = int16 bank with the
    (acc + 2^14) >> 15 accumulator, 'flt' = float32 bank + float32
    MAC, 'dbl' = float64."""

    FELEM = "s16"
    _DTYPES = {"s16": np.int16, "s32": np.int32,
               "flt": np.float32, "dbl": np.float64}

    def __init__(self, channels: int, in_rate: int, out_rate: int,
                 felem: str = None):
        self.felem = felem or self.FELEM
        self.dtype = self._DTYPES[self.felem]
        self.bank, self.flen = _build_filter_bank(in_rate, out_rate,
                                                  self.felem)
        self.pad = (self.flen - 1) // 2
        self.in_rate, self.out_rate = in_rate, out_rate
        phase_count = 1 << 10
        g = math.gcd(out_rate, in_rate * phase_count)
        self.src_incr = out_rate // g
        di = (in_rate * phase_count) // g
        self.dst_incr = di // self.src_incr
        self.dst_incr_frac = di % self.src_incr
        self.index = 0
        self.frac = 0
        self.primed = False
        self.buf = np.zeros((channels, 0), self.dtype)
        self.flushed = False

    def _fir(self, gat: np.ndarray, filt_rows: np.ndarray) -> np.ndarray:
        """(ch, nout) output block for gather indices + per-output
        filter rows — resample_one_s16/flt/dbl arithmetic."""
        if self.felem == "s16":
            g = self.buf.astype(np.int32)[:, gat]
            acc = (g * filt_rows.astype(np.int32)[None]).sum(axis=2)
            return np.clip((acc + (1 << 14)) >> 15,
                           -32768, 32767).astype(np.int16)
        if self.felem == "s32":
            g = self.buf.astype(np.int64)[:, gat]
            acc = (g * filt_rows.astype(np.int64)[None]).sum(axis=2)
            return np.clip((acc + (1 << 29)) >> 30,
                           -(1 << 31), (1 << 31) - 1).astype(np.int32)
        g = self.buf[:, gat]
        return (g.astype(self.dtype) *
                filt_rows[None]).sum(axis=2, dtype=self.dtype)

    def _produce(self) -> np.ndarray:
        m = self.buf.shape[1]
        idxs, phases = [], []
        index, frac = self.index, self.frac
        while True:
            si = index >> 10
            if si + self.flen > m:
                break
            idxs.append(si)
            phases.append(index & 1023)
            frac += self.dst_incr_frac
            index += self.dst_incr
            if frac >= self.src_incr:
                frac -= self.src_incr
                index += 1
        consumed = index >> 10
        out = np.zeros((self.buf.shape[0], len(idxs)), self.dtype)
        if idxs:
            gat = (np.array(idxs)[:, None] +
                   np.arange(self.flen)[None, :])
            out = self._fir(gat, self.bank[np.array(phases)])
        self.buf = self.buf[:, consumed:]
        self.index = index - (consumed << 10)
        self.frac = frac
        return out

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """(ch, n) in -> (ch, k) out (k may be 0)."""
        samples = samples.astype(self.dtype, copy=False)
        if not self.primed:
            self.buf = np.concatenate([self.buf, samples], axis=1)
            if self.buf.shape[1] < 2 * self.pad:
                return np.zeros((self.buf.shape[0], 0), self.dtype)
            head = np.zeros((self.buf.shape[0], self.pad), self.dtype)
            full = np.concatenate([head, self.buf], axis=1)
            for i in range(self.pad):
                full[:, i] = full[:, 2 * self.pad - i]
            self.buf = full
            self.primed = True
        else:
            self.buf = np.concatenate([self.buf, samples], axis=1)
        return self._produce()

    def flush(self) -> np.ndarray:
        if self.flushed or not self.primed:
            self.flushed = True
            return np.zeros((self.buf.shape[0], 0), self.dtype)
        self.flushed = True
        m = self.buf.shape[1]
        tail = np.zeros((self.buf.shape[0], self.pad), self.dtype)
        for i in range(self.pad):
            if m > i:
                tail[:, i] = self.buf[:, m - i - 1]
        self.buf = np.concatenate([self.buf, tail], axis=1)
        return self._produce()


class StreamingResamplerS16(StreamingResampler):
    FELEM = "s16"
