"""Rate-distortion (trellis) quantization for the mpegvideo encoders
(reference role: mpegvideo_enc.c dct_quantize_trellis_c — Viterbi over
scan positions choosing per-coefficient levels that minimize
distortion + lambda * actual VLC bits).

Operates on the device-produced DCT coefficients (scan order) AFTER the
baseline quantize, re-deciding inter-block AC levels with the real
run/level/last bit costs (3D RL for MPEG-4/H.263, 2D RL + EOB for
MPEG-1/2).  Vectorized over all blocks of a frame: the DP inner
reduction runs as numpy minimums over the predecessor axis.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _cost_h263(intra: bool):
    """bits0/bits1[run, level] for levels 1..64 (index level-1), ESC3
    fallback included (mpeg4 ESC3 = esc_code + 2+1+6+1+12+1 bits)."""
    from libav_tpu_torch.codecs.mpeg4 import tables as T
    tab = T.INTRA_VLC if intra else T.INTER_VLC
    esc_bits = tab[T.ESC_INDEX][1] + 2 + 1 + 6 + 1 + 12 + 1
    cost = np.full((2, 64, 64), esc_bits, np.int32)
    for (last, run, lvl), (code, bits) in T.rl_encode_map(intra).items():
        if lvl <= 64:
            cost[last][run][lvl - 1] = bits + 1      # +1 sign bit
    return cost[0], cost[1]


@functools.lru_cache(maxsize=None)
def _cost_mpeg12(mpeg2: bool):
    """bits[run, level] for levels 1..255 from table B.14 (+1 sign),
    escape fallback 6+6+12 (MPEG-2) or 6+6+8/16 (MPEG-1 two-step)."""
    from libav_tpu_torch.codecs.mpeg12 import tables as T
    max_lvl = 2047 if mpeg2 else 255
    cost = np.empty((64, max_lvl), np.int32)
    if mpeg2:
        cost[:] = 6 + 6 + 12
    else:
        cost[:, :127] = 6 + 6 + 8
        cost[:, 127:] = 6 + 6 + 16
    for i in range(111):
        run = int(T.RUN_LEVEL[0][i])
        lvl = int(T.RUN_LEVEL[1][i])
        bits = T.DCT_VLC_MPEG1[i][1]
        cost[run][lvl - 1] = bits + 1                # +1 sign bit
    return cost


def trellis_inter(czz: np.ndarray, levels: np.ndarray, qscale: np.ndarray,
                  kind: str = "h263", lam_scale: float = 0.30) -> np.ndarray:
    """Re-quantize inter AC coefficients with RD-optimal level/zero
    decisions.

    czz: (nblk, 64) int DCT coefficients in scan order (device fdct
    units); levels: (nblk, 64) baseline quantized levels; qscale:
    (nblk,) per-block quantizer.  Returns new levels (nblk, 64).
    """
    czz = czz.astype(np.int64)
    nblk = czz.shape[0]
    q = qscale.astype(np.int64)

    if kind == "h263":
        divisor = 16 * q                    # one quant step in czz units
        bits0, bits1 = _cost_h263(False)
        eob_bits = None
        lvl_max = 2047                      # ESC3 12-bit signed range
        first_special = False

        def dequant(lv):
            # h263 inter dequant q*(2|L|+1) - (1 - q&1), scaled x8 to
            # the device fdct units (encode_jit divides by 16q)
            qq = q.reshape((-1,) + (1,) * (lv.ndim - 1))
            a = qq * (2 * np.abs(lv) + 1) - (1 - (qq & 1))
            return 8 * np.sign(lv) * np.where(lv == 0, 0, a)
    elif kind in ("mpeg1", "mpeg2"):
        # flat default inter matrix (16): divisor = 16q (MPEG-1) / 8q
        # (MPEG-2 keeps an extra fraction bit; mpegvideo.quantize_mpeg)
        mpeg2 = kind == "mpeg2"
        divisor = (8 if mpeg2 else 16) * np.maximum(q, 1)
        bits0 = _cost_mpeg12(mpeg2)
        bits1 = None
        eob_bits = 2                        # table B.14 EOB '10'
        lvl_max = 2047 if mpeg2 else 255
        first_special = True                # dct_coeff_first '1s'

        def dequant(lv):
            qq = q.reshape((-1,) + (1,) * (lv.ndim - 1))
            mag = ((2 * np.abs(lv) + 1) * qq * 16) >> (5 if mpeg2
                                                       else 4)
            if not mpeg2:
                mag = (mag - 1) | 1         # oddification (ISO 11172-2)
            return 8 * np.sign(lv) * np.where(lv == 0, 0, mag)
    else:
        raise ValueError(f"trellis: unknown quant kind {kind!r}")
    lam = lam_scale * divisor.astype(np.float64) ** 2

    base = np.abs(czz) // divisor[:, None]
    cand = np.stack([np.zeros_like(base), np.maximum(base - 1, 0),
                     base], axis=2)         # (nblk, 64, 3)
    cand = np.minimum(cand, lvl_max)
    sign = np.sign(czz)

    # distortion of each candidate at each position
    deq = dequant(cand * sign[:, :, None])
    dist = (czz[:, :, None] - deq) ** 2     # (nblk, 64, 3)
    dz = czz ** 2                           # zero distortion per pos
    # prefix sums of zero distortion: Z[:, i] = sum dz[:, :i]
    Z = np.concatenate([np.zeros((nblk, 1), np.int64),
                        np.cumsum(dz, axis=1)], axis=1)

    INF = 1e30
    n = 64
    # best[:, j]: best cost of a prefix whose LAST nonzero is at pos j-1
    # (j=0: no nonzero yet), bits of that last symbol coded with last=0
    best = np.full((nblk, n + 1), INF)
    best[:, 0] = 0.0
    lvl_at = np.zeros((nblk, n + 1), np.int64)
    run_at = np.zeros((nblk, n + 1), np.int64)
    ptr = np.zeros((nblk, n + 1), np.int64)

    for i in range(n):
        # transitions j -> i placing a nonzero candidate at position i
        js = np.arange(i + 1)               # predecessor states 0..i
        runs = i - js                       # zeros between
        zero_d = Z[:, i:i + 1] - Z[:, js]   # (nblk, i+1)
        prev = best[:, :i + 1] + zero_d
        best_i = INF
        for c in (1, 2):                    # nonzero candidates only
            lv = cand[:, i, c]
            if not np.any(lv):
                continue
            lcap = bits0.shape[1]
            bc = bits0[np.minimum(runs, 63)][:,
                                             np.minimum(lv, lcap) - 1].T
            if first_special and i == 0:
                # dct_coeff_first: run 0 / |level| 1 codes as '1s'
                bc = np.where(lv[:, None] == 1, 2, bc)
            # bc: (nblk, i+1) bits for (run, level) — note fancy
            # indexing order: bits0[runs] is (i+1, 64); take level col
            tot = prev + lam[:, None] * bc + dist[:, i, c][:, None]
            tot = np.where(lv[:, None] > 0, tot, INF)
            jbest = np.argmin(tot, axis=1)
            cost = tot[np.arange(nblk), jbest]
            better = cost < best[:, i + 1]
            best[:, i + 1] = np.where(better, cost, best[:, i + 1])
            lvl_at[:, i + 1] = np.where(better, lv, lvl_at[:, i + 1])
            run_at[:, i + 1] = np.where(better, i - jbest,
                                        run_at[:, i + 1])
            ptr[:, i + 1] = np.where(better, jbest, ptr[:, i + 1])

    # finalize: trailing zeros + last-flag recost (h263) or EOB (mpeg12)
    tail = Z[:, n:n + 1] - Z[:, :n + 1]     # (nblk, n+1)
    final = best + tail
    if eob_bits is None:
        # recost the last symbol with the last=1 table
        for j in range(1, n + 1):
            lv = lvl_at[:, j]
            rn = run_at[:, j]
            has = lv > 0
            d = (bits1[np.minimum(rn, 63), np.minimum(lv, 64) - 1] -
                 bits0[np.minimum(rn, 63), np.minimum(lv, 64) - 1])
            final[:, j] = np.where(has, final[:, j] + lam * d,
                                   final[:, j])
    else:
        final[:, 1:] += (lam * eob_bits)[:, None]
    # all-zero block (j=0) stays without EOB/last cost (cbp skips it)

    jend = np.argmin(final, axis=1)
    out = np.zeros_like(levels)
    for b in range(nblk):
        j = int(jend[b])
        while j > 0:
            out[b, j - 1] = lvl_at[b, j] * sign[b, j - 1]
            j = int(ptr[b, j])
    return out
