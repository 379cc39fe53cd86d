"""AAC table helpers on top of the generated normative tables."""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs.aac import tables_gen as G

SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350]

_SWB_1024 = {
    96000: G.SWB_OFFSET_1024_96, 88200: G.SWB_OFFSET_1024_96,
    64000: G.SWB_OFFSET_1024_64, 48000: G.SWB_OFFSET_1024_48,
    44100: G.SWB_OFFSET_1024_48, 32000: G.SWB_OFFSET_1024_32,
    24000: G.SWB_OFFSET_1024_24, 22050: G.SWB_OFFSET_1024_24,
    16000: G.SWB_OFFSET_1024_16, 12000: G.SWB_OFFSET_1024_16,
    11025: G.SWB_OFFSET_1024_16, 8000: G.SWB_OFFSET_1024_8,
}


def swb_offsets_long(sample_rate: int) -> np.ndarray:
    return np.asarray(_SWB_1024[sample_rate], dtype=np.int32)


_SWB_128 = {
    96000: G.SWB_OFFSET_128_96, 88200: G.SWB_OFFSET_128_96,
    64000: G.SWB_OFFSET_128_96, 48000: G.SWB_OFFSET_128_48,
    44100: G.SWB_OFFSET_128_48, 32000: G.SWB_OFFSET_128_48,
    24000: G.SWB_OFFSET_128_24, 22050: G.SWB_OFFSET_128_24,
    16000: G.SWB_OFFSET_128_16, 12000: G.SWB_OFFSET_128_16,
    11025: G.SWB_OFFSET_128_16, 8000: G.SWB_OFFSET_128_8,
}


def swb_offsets_short(sample_rate: int) -> np.ndarray:
    """Short-window (128) scalefactor band offsets (reference:
    aactab.c ff_swb_offset_128 :1252)."""
    return np.asarray(_SWB_128[sample_rate], dtype=np.int32)


# codebook properties: (dimension, is_signed, max_abs)
CB_INFO = {
    1: (4, True, 1), 2: (4, True, 1), 3: (4, False, 2), 4: (4, False, 2),
    5: (2, True, 4), 6: (2, True, 4), 7: (2, False, 7), 8: (2, False, 7),
    9: (2, False, 12), 10: (2, False, 12), 11: (2, False, 16),
}
ZERO_HCB = 0
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15


@functools.lru_cache(maxsize=None)
def scalefactor_vlc() -> VLC:
    return VLC(10, codes=list(G.SCALEFACTOR_CODE),
               lengths=list(G.SCALEFACTOR_BITS))


@functools.lru_cache(maxsize=None)
def spectral_vlc(cb: int) -> VLC:
    return VLC(10, codes=list(G.SPECTRAL_CODES[cb - 1]),
               lengths=list(G.SPECTRAL_BITS[cb - 1]))


@functools.lru_cache(maxsize=None)
def unpack_index(cb: int):
    """index -> tuple of dim values (pre-sign for unsigned books)."""
    dim, signed, maxa = CB_INFO[cb]
    if dim == 4:
        mod = 3 if signed else 3
        if cb in (1, 2):
            # values -1..1, index = ((a+1)*3+(b+1))*3 ...
            def unpack(idx):
                vals = []
                for _ in range(4):
                    vals.append(idx % 3)
                    idx //= 3
                return tuple(v - 1 for v in reversed(vals))
        else:
            def unpack(idx):
                vals = []
                for _ in range(4):
                    vals.append(idx % 3)
                    idx //= 3
                return tuple(reversed(vals))
    else:
        if signed:
            n = 2 * maxa + 1

            def unpack(idx):
                return (idx // n - maxa, idx % n - maxa)
        else:
            n = maxa + 1

            def unpack(idx):
                return (idx // n, idx % n)
    return unpack


# encoder side: (value tuple) -> index
@functools.lru_cache(maxsize=None)
def pack_index(cb: int):
    dim, signed, maxa = CB_INFO[cb]
    if dim == 2:
        if signed:
            n = 2 * maxa + 1
            return lambda a, b: (a + maxa) * n + (b + maxa)
        n = maxa + 1
        return lambda a, b: a * n + b
    raise NotImplementedError("encoder uses 2-dim codebooks only")


# TNS (reference: aactab.c ff_tns_max_bands_1024/_128; spec 14496-3
# Table 4.139) indexed by sampling_frequency_index 0..12
TNS_MAX_BANDS_1024 = (31, 31, 34, 40, 42, 51, 46, 46, 42, 42, 42, 39, 39)
TNS_MAX_BANDS_128 = (9, 9, 10, 14, 14, 14, 14, 14, 14, 14, 14, 14, 14)

_SR_INDEX = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
             16000, 12000, 11025, 8000, 7350)


def sample_rate_index(rate: int) -> int:
    return _SR_INDEX.index(rate)


def tns_dequant_table(coef_compress: int, coef_res: int):
    """Inverse quantization of TNS reflection coefficients (spec
    4.6.9.3; reference aac_tablegen.h tns_tmp2_map): signed index ->
    sin-mapped value."""
    import math
    coef_len = coef_res + 3 - coef_compress
    n = 1 << coef_len
    iqfac = ((1 << (coef_res + 2)) - 0.5) / (math.pi / 2.0)
    iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (math.pi / 2.0)
    out = np.zeros(n)
    for i in range(n):
        v = i - n if i >= n // 2 else i      # two's complement
        out[i] = math.sin(v / (iqfac if v >= 0 else iqfac_m))
    return out


def tns_lpc(coefs):
    """Reflection coefficients -> LPC (spec 4.6.9.3 pseudo-code;
    reference aacdec.c compute_lpc_coefs equivalent)."""
    order = len(coefs)
    a = np.zeros(order + 1)
    a[0] = 1.0
    for m in range(1, order + 1):
        b = a.copy()
        for i in range(1, m):
            b[i] = a[i] + coefs[m - 1] * a[m - i]
        b[m] = coefs[m - 1]
        a = b
    return a[1:]                              # lpc[0..order-1]
