"""MPEG audio 32-band synthesis filterbank (ISO 11172-3 2.4.3.3;
reference behavior: mpegaudiodsp_template.c ff_mpa_synth_filter_float =
dct32 + ring-buffer apply_window).

TPU-shaped: the whole filterbank is linear and time-invariant, so it is
materialized once as a 16-tap matrix convolution K[tap][32 out][32 in]
(dct32 — a plain DCT-II, verified against the reference object code —
folded into the windowing access pattern of apply_window), and a whole
granule of slots becomes one einsum over a sliding slot stack.

With spec-normalized (+/-1) subband samples the effective window is
ENWINDOW / 2^16: the reference float pipeline keeps sb_samples scaled
by 2^23 and windows by ENWINDOW * 2^-39 (ff_mpa_synth_init WFRAC/FRAC
scaling), which cancels to the same constant.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.codecs.mpegaudio import tables as T

_K = None


def _window512() -> np.ndarray:
    """ff_mpa_synth_init: mirror the 257-entry half window with sign
    flips at non-multiples of 64."""
    w = np.zeros(512)
    half = T.ENWINDOW / 65536.0
    for i in range(257):
        v = half[i]
        w[i] = v
        if (i & 63) != 0:
            v = -v
        if i != 0:
            w[512 - i] = v
    return w


def _build_kernel() -> np.ndarray:
    """K[a, j, k]: contribution of subband sample k from a slots ago to
    output sample j (apply_window index algebra, mpegaudiodsp_template.c
    :120-171, with d_a = DCT32(s_a))."""
    w = _window512()
    # dct32: out[i] = sum_j in[j] cos(pi (2j+1) i / 64)
    i = np.arange(32)[:, None]
    j = np.arange(32)[None, :]
    C = np.cos(np.pi * (2 * j + 1) * i / 64.0)

    # D[a, out_j, dct_bin]
    D = np.zeros((16, 32, 32))
    ks = np.arange(8)
    # out[0] = sum_k w[64k] d_{2k}[16] - w[32+64k] d_{2k+1}[16]
    for k in ks:
        D[2 * k, 0, 16] += w[64 * k]
        D[2 * k + 1, 0, 16] -= w[32 + 64 * k]
    for jj in range(1, 16):
        for k in ks:
            # sum  += w[j+64k]   * d_{2k}[16+j]
            # sum  -= w[32+j+64k]* d_{2k+1}[16-j]
            D[2 * k, jj, 16 + jj] += w[jj + 64 * k]
            D[2 * k + 1, jj, 16 - jj] -= w[32 + jj + 64 * k]
            # sum2 -= w[32-j+64k]* d_{2k}[16+j]
            # sum2 -= w[64-j+64k]* d_{2k+1}[16-j]
            D[2 * k, 32 - jj, 16 + jj] -= w[32 - jj + 64 * k]
            D[2 * k + 1, 32 - jj, 16 - jj] -= w[64 - jj + 64 * k]
    for k in ks:
        # out[16] = -sum_k w[48+64k] d_{2k+1}[0]
        D[2 * k + 1, 16, 0] -= w[48 + 64 * k]
    # fold the DCT: K[a, j, s] = sum_bin D[a, j, bin] * C[bin, s]
    return np.einsum("ajb,bs->ajs", D, C)


def kernel() -> np.ndarray:
    global _K
    if _K is None:
        _K = _build_kernel()
    return _K


class SynthState:
    """Per-channel history of the last 15 subband-sample slots."""

    def __init__(self):
        self.hist = np.zeros((15, 32))

    def run(self, sb_slots: np.ndarray) -> np.ndarray:
        """sb_slots: (n_slots, 32) spec-normalized subband samples.
        Returns (n_slots*32,) PCM."""
        K = kernel()
        n = sb_slots.shape[0]
        stack = np.concatenate([self.hist[::-1], sb_slots], axis=0)
        # slots[t] uses stack rows t+15 (newest) .. t (oldest)
        out = np.zeros((n, 32))
        for a in range(16):
            out += stack[15 - a:15 - a + n] @ K[a].T
        self.hist = sb_slots[-15:][::-1].copy() if n >= 15 else \
            np.concatenate([sb_slots[::-1], self.hist])[:15]
        return out.reshape(-1)
