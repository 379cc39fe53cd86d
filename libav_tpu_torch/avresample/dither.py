"""Dithered s16 quantization (reference: libavresample/dither.c).

Float samples are scaled by S16_SCALE (32753, slight attenuation to
avoid clipping), dither noise is added, and the result is rounded and
clipped to int16.  Noise per channel comes from the reference's exact
AVLFG lagged-Fibonacci PRNG (libavutil/lfg.c av_lfg_init, MD5-expanded
seed; per-channel seeds drawn from a master LFG seeded 0xC0FFEE —
dither.c:427-431), so rectangular/triangular/triangular_hp output is
bit-identical to the reference for the same input.

Methods (dither.c / avresample.h AVResampleDitherMethod):
  rectangular    one uniform noise stream scaled to [-0.5, 0.5)
  triangular     sum of two independent streams
  triangular_hp  triangular passed through the 3-tap highpass (default
                 level: none — dithering is opt-in, options.c:80)
  triangular_ns  triangular + 4th-order noise shaping (48k/44.1k coefs)
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

S16_SCALE = np.float32(32753.0)
LFG_SCALE = np.float32(1.0 / (2.0 * 2147483647.0))
SQRT_1_6 = np.float32(0.40824829046386301723)

NS_48_B = np.array([2.2374, -0.7339, -0.1251, -0.6033], np.float32)
NS_48_A = np.array([0.9030, 0.0116, -0.5853, -0.2571], np.float32)
NS_44_B = np.array([2.2061, -0.4707, -0.2534, -0.6213], np.float32)
NS_44_A = np.array([1.0587, 0.0676, -0.6054, -0.2738], np.float32)

MUTE_THRESHOLD_SEC = 0.000333


class LFG:
    """Exact av_lfg (libavutil/lfg.c): 55/24 additive lagged Fibonacci
    over uint32 with an MD5-expanded seed."""

    def __init__(self, seed: int):
        self.state = np.zeros(64, np.uint32)
        tmp = bytearray(16)
        for i in range(8, 64, 4):
            struct.pack_into("<I", tmp, 0, seed & 0xFFFFFFFF)
            tmp[4] = i
            tmp[5:16] = bytes(11) if i == 8 else tmp[5:16]
            dig = hashlib.md5(bytes(tmp)).digest()
            tmp[:] = dig
            self.state[i:i + 4] = struct.unpack("<4I", dig)
        self.index = 0

    def get(self) -> int:
        i = self.index
        v = (int(self.state[(i - 24) & 63]) +
             int(self.state[(i - 55) & 63])) & 0xFFFFFFFF
        self.state[i & 63] = v
        self.index = i + 1
        return v

    def get_block(self, n: int) -> np.ndarray:
        """n successive av_lfg_get values (vector-friendly)."""
        out = np.empty(n, np.uint32)
        st, idx = self.state, self.index
        for k in range(n):
            v = (int(st[(idx - 24) & 63]) + int(st[(idx - 55) & 63])) \
                & 0xFFFFFFFF
            st[idx & 63] = v
            out[k] = v
            idx += 1
        self.index = idx
        return out


def _align16(n: int) -> int:
    return (n + 15) & ~15


class DitherState:
    def __init__(self, seed: int):
        self.seed = seed
        self.noise = np.empty(0, np.float32)
        self.ptr = 0
        self.mute = 0
        self.a = np.zeros(4, np.float32)
        self.b = np.zeros(4, np.float32)


class Ditherer:
    """Per-stream dithering context (reference: DitherContext)."""

    def __init__(self, channels: int, method: str = "triangular_hp",
                 sample_rate: int = 48000):
        self.method = method
        self.channels = channels
        seed_gen = LFG(0xC0FFEE)
        self.state = [DitherState(seed_gen.get()) for _ in range(channels)]
        if sample_rate == 48000:
            self.ns_b, self.ns_a = NS_48_B, NS_48_A
        else:
            self.ns_b, self.ns_a = NS_44_B, NS_44_A
        self.mute_dither_threshold = round(MUTE_THRESHOLD_SEC * sample_rate)
        self.mute_reset_threshold = self.mute_dither_threshold * 4

    def _gen_noise(self, st: DitherState, min_samples: int):
        nb = _align16(min_samples) + 16
        buf_samples = nb * (1 if self.method == "rectangular" else 2)
        lfg = LFG(st.seed)
        ui = lfg.get_block(buf_samples)
        si = ui.view(np.int32).astype(np.float32)
        if self.method == "rectangular":
            noise = si * LFG_SCALE
        else:
            noise = (si[:nb] * LFG_SCALE).astype(np.float32) + \
                (si[nb:2 * nb] * LFG_SCALE).astype(np.float32)
        noise = noise.astype(np.float32)
        if self.method == "triangular_hp":
            # 3-tap highpass (dither.c:133-140), in place over len-2
            out = noise.copy()
            out[:-2] = ((-noise[:-2] + 2 * noise[1:-1] - noise[2:])
                        * SQRT_1_6).astype(np.float32)
            noise = out
        st.noise = noise
        st.ptr = 0

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """(channels, n) float32 in [-1, 1] -> int16, dithered.
        Matches dither.c convert_samples + quantize_c semantics."""
        ch, n = x.shape
        out = np.empty((ch, n), np.int16)
        aligned = _align16(n)
        for c in range(ch):
            st = self.state[c]
            if st.noise.shape[0] - 16 < aligned or st.noise.shape[0] == 0:
                self._gen_noise(st, n)
            elif st.noise.shape[0] - 16 - st.ptr < aligned:
                st.ptr = 0
            d = st.noise[st.ptr:st.ptr + n]
            if self.method == "triangular_ns":
                out[c] = self._quantize_ns(st, x[c].astype(np.float32), d)
            else:
                s = x[c].astype(np.float32) * S16_SCALE + d
                out[c] = np.clip(np.rint(s), -32768, 32767).astype(np.int16)
            st.ptr += aligned
        return out

    def _quantize_ns(self, st: DitherState, src: np.ndarray,
                     dither: np.ndarray) -> np.ndarray:
        # serial 4th-order noise shaping (dither.c quantize_triangular_ns)
        n = src.shape[0]
        dst = np.empty(n, np.int16)
        a, b = st.a, st.b
        if st.mute > self.mute_reset_threshold:
            a[:] = 0
        cb, ca = self.ns_b, self.ns_a
        mute = st.mute
        for i in range(n):
            sample = np.float32(src[i] * S16_SCALE)
            err = np.float32(np.dot(cb, b) - np.dot(ca, a))
            a[1:] = a[:-1]
            b[1:] = b[:-1]
            a[0] = err
            sample = np.float32(sample - err)
            if mute > self.mute_dither_threshold:
                v = int(np.rint(sample))
                b[0] = 0
            else:
                v = int(np.rint(np.float32(sample + dither[i])))
                b[0] = np.clip(np.float32(v - sample), -1.5, 1.5)
            dst[i] = max(-32768, min(32767, v))
            mute = 0 if src[i] else mute + 1
        st.mute = mute
        return dst
