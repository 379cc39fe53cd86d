"""A/52 §7.2.2 parametric bit allocation — shared bit-exact by encoder and
decoder (the decoder re-derives the encoder's allocation from the
transmitted exponents; reference: libavcodec/ac3.c
ff_ac3_bit_alloc_calc_psd / calc_mask / ac3_calc_bap)."""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.codecs.ac3 import tables as T


def calc_psd(exps: np.ndarray, start: int, end: int):
    """exponents -> fine-grain PSD + log-added band PSD.
    Returns (psd (end,), band_psd (50,))."""
    psd = np.zeros(end, dtype=np.int32)
    psd[start:end] = 3072 - (exps[start:end].astype(np.int32) << 7)
    band_psd = np.zeros(T.N_BANDS, dtype=np.int32)
    b2b = T.bin_to_band()
    bin_ = start
    band = int(b2b[start])
    while True:
        v = int(psd[bin_])
        bin_ += 1
        band_end = min(int(T.BAND_START[band + 1]), end)
        while bin_ < band_end:
            mx = max(v, int(psd[bin_]))
            adr = min(mx - ((v + int(psd[bin_]) + 1) >> 1), 255)
            v = mx + int(T.LOG_ADD[adr])
            bin_ += 1
        band_psd[band] = v
        band += 1
        if end <= int(T.BAND_START[band]):
            break
    return psd, band_psd


def _lowcomp1(a, b0, b1, c):
    if b0 + 256 == b1:
        return c
    if b0 > b1:
        return max(a - 64, 0)
    return a


def _lowcomp(a, b0, b1, band):
    if band < 7:
        return _lowcomp1(a, b0, b1, 384)
    if band < 20:
        return _lowcomp1(a, b0, b1, 320)
    return max(a - 128, 0)


def calc_mask(band_psd: np.ndarray, start: int, end: int, fast_gain: int,
              sdecay: int, fdecay: int, sgain: int, dbknee: int,
              fscod: int, is_lfe: bool = False, cpl_leak=None,
              dba=None, sr_shift: int = 0) -> np.ndarray:
    """Excitation + masking curve (A/52 §7.2.2.3; reference: ac3.c
    ff_ac3_bit_alloc_calc_mask incl. coupling-channel leak init and
    delta bit allocation). Returns mask (50,)."""
    excite = np.zeros(T.N_BANDS, dtype=np.int64)
    b2b = T.bin_to_band()
    band_start = int(b2b[start])
    band_end = int(b2b[end - 1]) + 1
    bp = band_psd.astype(np.int64)

    fastleak = slowleak = 0
    if band_start == 0:
        lowcomp = 0
        lowcomp = _lowcomp1(lowcomp, bp[0], bp[1], 384)
        excite[0] = bp[0] - fast_gain - lowcomp
        lowcomp = _lowcomp1(lowcomp, bp[1], bp[2], 384)
        excite[1] = bp[1] - fast_gain - lowcomp
        begin = 7
        for band in range(2, 7):
            if not (is_lfe and band == 6):
                lowcomp = _lowcomp1(lowcomp, bp[band], bp[band + 1], 384)
            fastleak = bp[band] - fast_gain
            slowleak = bp[band] - sgain
            excite[band] = fastleak - lowcomp
            if not (is_lfe and band == 6):
                if bp[band] <= bp[band + 1]:
                    begin = band + 1
                    break
        end1 = min(band_end, 22)
        for band in range(begin, end1):
            if not (is_lfe and band == 6):
                lowcomp = _lowcomp(lowcomp, bp[band], bp[band + 1], band)
            fastleak = max(fastleak - fdecay, bp[band] - fast_gain)
            slowleak = max(slowleak - sdecay, bp[band] - sgain)
            excite[band] = max(fastleak - lowcomp, slowleak)
        begin = 22
    else:
        # coupling channel: leak accumulators seeded from the coded
        # cplfleak/cplsleak (ac3.c:171-173)
        begin = band_start
        if cpl_leak is not None:
            fastleak = (cpl_leak[0] << 8) + 768
            slowleak = (cpl_leak[1] << 8) + 768

    for band in range(begin, band_end):
        fastleak = max(fastleak - fdecay, bp[band] - fast_gain)
        slowleak = max(slowleak - sdecay, bp[band] - sgain)
        excite[band] = max(fastleak, slowleak)

    mask = np.zeros(T.N_BANDS, dtype=np.int64)
    for band in range(band_start, band_end):
        tmp = dbknee - bp[band]
        if tmp > 0:
            excite[band] += tmp >> 2
        mask[band] = max(int(T.HEARING_THRESHOLD[band >> sr_shift, fscod]),
                         excite[band])

    # delta bit allocation (A/52 §7.2.2.3 step 9; ac3.c:195-213)
    if dba:
        band = band_start
        for (off, length, value) in dba:
            band += off
            delta = ((value - 3) << 7) if value >= 4 else ((value - 4) << 7)
            for _ in range(length):
                if band >= T.N_BANDS:
                    raise ValueError("dba out of range")
                mask[band] += delta
                band += 1
    return mask


def calc_bap(psd: np.ndarray, mask: np.ndarray, start: int, end: int,
             snr_offset: int, floor: int, bap_tab=None) -> np.ndarray:
    """Final bit allocation pointers (A/52 §7.2.2.4). bap_tab overrides
    the standard 64-entry address->bap table (E-AC-3 AHT channels use
    the hebap table, A/52B Table E3.5)."""
    if bap_tab is None:
        bap_tab = T.BAP_TAB
    bap = np.zeros(end, dtype=np.int32)
    b2b = T.bin_to_band()
    m = mask.copy()
    # the snr offset and floor are applied to the mask
    i = start
    band = int(b2b[start])
    while i < end:
        band_end = min(int(T.BAND_START[band + 1]), end)
        mval = (max(int(m[band]) - snr_offset - floor, 0) & 0x1FE0) + floor
        for k in range(i, band_end):
            address = (int(psd[k]) - mval) >> 5
            address = min(63, max(0, address))
            bap[k] = bap_tab[address]
        i = band_end
        band += 1
    return bap


def run_bit_alloc(exps: np.ndarray, start: int, end: int, fscod: int,
                  sdcycod=2, fdcycod=1, sgaincod=1, dbpbcod=2, floorcod=7,
                  fgaincod=4, csnroffst=0, fsnroffst=0,
                  fast_gain=None, snr_offset=None, is_lfe=False,
                  cpl_leak=None, dba=None, sr_shift=0,
                  bap_tab=None) -> np.ndarray:
    """One-call helper: exponents -> bap (both sides use this).
    fast_gain/snr_offset may be given directly (decoder) or via
    fgaincod/csnroffst/fsnroffst codes (encoder)."""
    psd, band_psd = calc_psd(exps, start, end)
    if fast_gain is None:
        fast_gain = int(T.FAST_GAIN[fgaincod])
    mask = calc_mask(band_psd, start, end, fast_gain,
                     int(T.SLOW_DECAY[sdcycod]) >> sr_shift,
                     int(T.FAST_DECAY[fdcycod]) >> sr_shift,
                     T.SLOW_GAIN[sgaincod], T.DB_PER_BIT[dbpbcod],
                     fscod, is_lfe=is_lfe, cpl_leak=cpl_leak, dba=dba,
                     sr_shift=sr_shift)
    if snr_offset is None:
        snr_offset = (((csnroffst - 15) << 4) + fsnroffst) << 2
    return calc_bap(psd, mask, start, end, snr_offset, T.FLOOR[floorcod],
                    bap_tab=bap_tab)
