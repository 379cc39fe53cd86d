"""FFT / MDCT filterbank ops (reference: libavcodec/fft_template.c (346)
split-radix FFT, mdct_template.c (223) imdct_half — used by AAC
aacdec.c:2425-2427 and AC-3 ac3dec.c:651 — SURVEY.md §2.2).

Counterpart of `libav_tpu/ops/fftmdct.py`. The transform sizes audio
codecs use (N = 128..2048) are small enough that a dense cosine-basis
matrix product is the transform: `mdct`/`imdct` are one float32
`torch.matmul` on the caller's device, with TF32 off (asserted), over a
basis built once per (N, device) and kept there. torch.fft covers the
large-N cases. The host references and windows are the JAX package's,
copied.

The JAX package's `imdct` is an XLA dot at Precision.HIGHEST; torch sums
the same float32 products in another order, so the two differ by a few
float32 ulps (about 3e-6 on AAC's full-scale output), which is recorded
in ROADMAP.md §3; so do the two `mdct`s, the AAC and AC-3 encoders'
transform. `mdct.calls` and `imdct.calls` count the calls. The AC-3
decoder uses the float64 host `imdct_host` in both.

Conventions (matching ISO 14496-3 §4.6.11.3 for AAC and A/52 §7.9 for
AC-3): imdct(spec (B, N)) -> (B, 2N) time samples including the 2/N
factor; forward mdct(x (B, 2N)) -> (B, N). mdct(imdct) with the TDAC
window overlap-add reconstructs the input exactly (tested).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _mdct_matrix(N: int) -> np.ndarray:
    """M[k, n] = cos(2*pi/(2N) * ... ) — the (N, 2N) MDCT basis:
    X[k] = sum_n x[n] * cos(pi/N * (n + 0.5 + N/2) * (k + 0.5))."""
    n = np.arange(2 * N)[None, :]
    k = np.arange(N)[:, None]
    return np.cos(math.pi / N * (n + 0.5 + N / 2) * (k + 0.5))


def mdct_ref(x: np.ndarray) -> np.ndarray:
    """Golden forward MDCT. x: (..., 2N) -> (..., N)."""
    N = x.shape[-1] // 2
    M = _mdct_matrix(N)
    return x @ M.T


def imdct_ref(spec: np.ndarray) -> np.ndarray:
    """Golden inverse MDCT with 2/N scale. spec: (..., N) -> (..., 2N)."""
    N = spec.shape[-1]
    M = _mdct_matrix(N)
    return (2.0 / N) * (spec @ M)


@functools.lru_cache(maxsize=None)
def _basis(N: int, device: torch.device) -> torch.Tensor:
    """The (N, 2N) MDCT basis as float32 on device, built once."""
    return torch.as_tensor(_mdct_matrix(N), dtype=torch.float32,
                           device=device)


def _check_fp32_matmul(device: torch.device) -> None:
    """Audio filterbanks need true float32 accumulation: TF32 keeps
    about three decimal digits, audible after quantiser scaling."""
    if device.type == "cuda":
        assert not torch.backends.cuda.matmul.allow_tf32, \
            "fftmdct: TF32 matmul is on; the transforms need float32"


def mdct(x: torch.Tensor) -> torch.Tensor:
    """Batched forward MDCT. x: (B, 2N) float32 tensor -> (B, N), on
    x's device."""
    _check_fp32_matmul(x.device)
    N = x.shape[-1] // 2
    out = torch.matmul(x.to(torch.float32), _basis(N, x.device).T)
    mdct.calls += 1
    return out


mdct.calls = 0


def imdct(spec: torch.Tensor) -> torch.Tensor:
    """Batched inverse MDCT (with 2/N). (B, N) float32 tensor -> (B, 2N),
    on spec's device."""
    _check_fp32_matmul(spec.device)
    N = spec.shape[-1]
    out = torch.matmul(spec.to(torch.float32), _basis(N, spec.device))
    imdct.calls += 1
    return (2.0 / N) * out


imdct.calls = 0


def imdct_host(spec: np.ndarray) -> np.ndarray:
    """Host (numpy) inverse MDCT with 2/N scale, for latency-bound
    per-block audio transforms (N <= 256): a device round trip per
    256-sample block costs orders of magnitude more than the matmul
    itself, so audio block decode stays on host and only frame-scale
    batches go through `imdct` on the device."""
    N = spec.shape[-1]
    M = _mdct_matrix(N)
    return (2.0 / N) * (spec.astype(np.float64) @ M)


# ---------------------------------------------------------------------- #
# Windows (reference: aactab.c KBD windows, sinewin.h; ac3 window ac3tab)
# ---------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def sine_window(L: int) -> np.ndarray:
    """Full MDCT sine window of length L (= 2N for hop N):
    w[n] = sin(pi/L * (n + 0.5)) — symmetric, and w[n]^2 + w[n+L/2]^2 = 1
    (the Princen-Bradley TDAC condition). ISO 14496-3 §4.6.11.3.2."""
    n = np.arange(L)
    return np.sin(math.pi / L * (n + 0.5))


@functools.lru_cache(maxsize=None)
def kbd_window(L: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel-derived window of full length L (ISO 14496-3
    §4.6.11.3.2; AAC uses alpha=4 for long, 6 for short windows).
    Kernel = Kaiser window of length L/2+1 (symmetric about L/4), so the
    cumulative sums satisfy Princen-Bradley w[n]^2 + w[n+L/2]^2 = 1."""
    from libav_tpu_torch.avresample.refexact import _bessel as _bessel_i0
    beta = math.pi * alpha
    half_len = L // 2
    w = np.array([_bessel_i0(beta * math.sqrt(
        max(0.0, 1 - (2.0 * n / half_len - 1) ** 2)))
        for n in range(half_len + 1)])
    c = np.cumsum(w)
    total = c[-1]
    half = np.sqrt(c[:half_len] / total)
    return np.concatenate([half, half[::-1]])


@functools.lru_cache(maxsize=None)
def ac3_window(N: int = 256) -> np.ndarray:
    """A/52 §7.10 Kaiser-Bessel derived window with alpha=5."""
    return kbd_window(N * 2, alpha=5.0)[:N * 2]


def overlap_add_ref(frames: np.ndarray, N: int) -> np.ndarray:
    """TDAC overlap-add of consecutive (B, 2N) windowed IMDCT outputs."""
    B = frames.shape[0]
    out = np.zeros((B + 1) * N)
    for i in range(B):
        out[i * N:(i + 2) * N] += frames[i]
    return out


# ---------------------------------------------------------------------- #
# FFT (torch.fft; for large transforms and spectral tools)
# ---------------------------------------------------------------------- #

def fft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x)


def rfft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft(x)


def fft_ref(x: np.ndarray) -> np.ndarray:
    return np.fft.fft(x)
