"""Channel mixing matrix builder (reference: libavresample/
audio_mix_matrix.c avresample_build_matrix :87-294).

Implements the full downmix/upmix coefficient derivation: matched
channels route 1:1, then every unaccounted input position folds into
the nearest available outputs with the normative levels (center/
surround/LFE mix levels, sqrt(1/2) folds, Dolby/DPL-II phase-encoded
surround), followed by optional max-coefficient-sum normalization.
Defaults mirror options.c:60-63 (center/surround = sqrt(1/2), lfe = 0,
normalize = 1).
"""

from __future__ import annotations

import math

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL, PATCHWELCOME

M_SQRT1_2 = math.sqrt(0.5)
M_SQRT2 = math.sqrt(2.0)
SQRT3_2 = math.sqrt(1.5)

# channel position bit indices (reference: channel_layout.h)
FL, FR, FC, LFE, BL, BR = 0, 1, 2, 3, 4, 5
FLC, FRC, BC, SL, SR = 6, 7, 8, 9, 10
TC, TFL, TFC, TFR, TBL, TBC, TBR = 11, 12, 13, 14, 15, 16, 17
STL, STR = 29, 30           # stereo downmix
WL, WR = 31, 32
SDL, SDR = 33, 34
LFE2 = 35

CH = lambda i: 1 << i
LAYOUT_STEREO = CH(FL) | CH(FR)
LAYOUT_SURROUND = LAYOUT_STEREO | CH(FC)
LAYOUT_STEREO_DOWNMIX = CH(STL) | CH(STR)

# matrix encodings (reference: avresample.h AVMatrixEncoding)
ENC_NONE, ENC_DOLBY, ENC_DPLII = 0, 1, 2


def _even(layout: int) -> bool:
    return (not layout) or bool(layout & (layout - 1))


def _sane_layout(layout: int) -> bool:
    if not (layout & LAYOUT_SURROUND):
        return False
    for a, b in ((FL, FR), (SL, SR), (BL, BR), (FLC, FRC), (TFL, TFR),
                 (TBL, TBR), (STL, STR), (WL, WR), (SDL, SDR)):
        if not _even(layout & (CH(a) | CH(b))):
            return False
    return True


def build_matrix(in_layout: int, out_layout: int,
                 center_mix_level: float = M_SQRT1_2,
                 surround_mix_level: float = M_SQRT1_2,
                 lfe_mix_level: float = 0.0,
                 normalize: bool = True,
                 matrix_encoding: int = ENC_NONE) -> np.ndarray:
    """(out_channels, in_channels) float64 coefficients
    (reference: avresample_build_matrix audio_mix_matrix.c:87)."""
    if (out_layout & LAYOUT_STEREO_DOWNMIX) == LAYOUT_STEREO_DOWNMIX:
        out_layout = LAYOUT_STEREO

    unaccounted = in_layout & ~out_layout
    in_ch = bin(in_layout).count("1")
    out_ch = bin(out_layout).count("1")
    if not in_layout or not out_layout or in_ch > 32 or out_ch > 32:
        raise AVError(EINVAL, "bad channel layout")
    if not _sane_layout(in_layout) or not _sane_layout(out_layout):
        raise AVError(PATCHWELCOME, "unsupported (unbalanced) layout")

    m = np.zeros((64, 64))
    for i in range(64):
        if in_layout & out_layout & CH(i):
            m[i][i] = 1.0

    slev = surround_mix_level
    if unaccounted & CH(FC):
        if (out_layout & LAYOUT_STEREO) == LAYOUT_STEREO:
            if (in_layout & LAYOUT_STEREO) == LAYOUT_STEREO:
                m[FL][FC] += center_mix_level
                m[FR][FC] += center_mix_level
            else:
                m[FL][FC] += M_SQRT1_2
                m[FR][FC] += M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place FC")
    if unaccounted & LAYOUT_STEREO:
        if out_layout & CH(FC):
            m[FC][FL] += M_SQRT1_2
            m[FC][FR] += M_SQRT1_2
            if in_layout & CH(FC):
                m[FC][FC] = center_mix_level * M_SQRT2
        else:
            raise AVError(PATCHWELCOME, "cannot place FL/FR")
    if unaccounted & CH(BC):
        if out_layout & CH(BL):
            m[BL][BC] += M_SQRT1_2
            m[BR][BC] += M_SQRT1_2
        elif out_layout & CH(SL):
            m[SL][BC] += M_SQRT1_2
            m[SR][BC] += M_SQRT1_2
        elif out_layout & CH(FL):
            if matrix_encoding in (ENC_DOLBY, ENC_DPLII):
                if unaccounted & (CH(BL) | CH(SL)):
                    m[FL][BC] -= slev * M_SQRT1_2
                    m[FR][BC] += slev * M_SQRT1_2
                else:
                    m[FL][BC] -= slev
                    m[FR][BC] += slev
            else:
                m[FL][BC] += slev * M_SQRT1_2
                m[FR][BC] += slev * M_SQRT1_2
        elif out_layout & CH(FC):
            m[FC][BC] += slev * M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place BC")
    if unaccounted & CH(BL):
        if out_layout & CH(BC):
            m[BC][BL] += M_SQRT1_2
            m[BC][BR] += M_SQRT1_2
        elif out_layout & CH(SL):
            if in_layout & CH(SL):
                m[SL][BL] += M_SQRT1_2
                m[SR][BR] += M_SQRT1_2
            else:
                m[SL][BL] += 1.0
                m[SR][BR] += 1.0
        elif out_layout & CH(FL):
            if matrix_encoding == ENC_DOLBY:
                m[FL][BL] -= slev * M_SQRT1_2
                m[FL][BR] -= slev * M_SQRT1_2
                m[FR][BL] += slev * M_SQRT1_2
                m[FR][BR] += slev * M_SQRT1_2
            elif matrix_encoding == ENC_DPLII:
                m[FL][BL] -= slev * SQRT3_2
                m[FL][BR] -= slev * M_SQRT1_2
                m[FR][BL] += slev * M_SQRT1_2
                m[FR][BR] += slev * SQRT3_2
            else:
                m[FL][BL] += slev
                m[FR][BR] += slev
        elif out_layout & CH(FC):
            m[FC][BL] += slev * M_SQRT1_2
            m[FC][BR] += slev * M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place BL/BR")
    if unaccounted & CH(SL):
        if out_layout & CH(BL):
            if in_layout & CH(BL):
                m[BL][SL] += M_SQRT1_2
                m[BR][SR] += M_SQRT1_2
            else:
                m[BL][SL] += 1.0
                m[BR][SR] += 1.0
        elif out_layout & CH(BC):
            m[BC][SL] += M_SQRT1_2
            m[BC][SR] += M_SQRT1_2
        elif out_layout & CH(FL):
            if matrix_encoding == ENC_DOLBY:
                m[FL][SL] -= slev * M_SQRT1_2
                m[FL][SR] -= slev * M_SQRT1_2
                m[FR][SL] += slev * M_SQRT1_2
                m[FR][SR] += slev * M_SQRT1_2
            elif matrix_encoding == ENC_DPLII:
                m[FL][SL] -= slev * SQRT3_2
                m[FL][SR] -= slev * M_SQRT1_2
                m[FR][SL] += slev * M_SQRT1_2
                m[FR][SR] += slev * SQRT3_2
            else:
                m[FL][SL] += slev
                m[FR][SR] += slev
        elif out_layout & CH(FC):
            m[FC][SL] += slev * M_SQRT1_2
            m[FC][SR] += slev * M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place SL/SR")
    if unaccounted & CH(FLC):
        if out_layout & CH(FL):
            m[FL][FLC] += 1.0
            m[FR][FRC] += 1.0
        elif out_layout & CH(FC):
            m[FC][FLC] += M_SQRT1_2
            m[FC][FRC] += M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place FLC/FRC")
    if unaccounted & CH(LFE):
        if out_layout & CH(FC):
            m[FC][LFE] += lfe_mix_level
        elif out_layout & CH(FL):
            m[FL][LFE] += lfe_mix_level * M_SQRT1_2
            m[FR][LFE] += lfe_mix_level * M_SQRT1_2
        else:
            raise AVError(PATCHWELCOME, "cannot place LFE")

    out = np.zeros((out_ch, in_ch))
    maxcoef = 0.0
    out_i = 0
    for i in range(64):
        if out_i >= out_ch:
            break
        s = 0.0
        out_j = 0
        for j in range(64):
            if out_j >= in_ch:
                break
            out[out_i][out_j] = m[i][j]
            s += abs(m[i][j])
            if in_layout & CH(j):
                out_j += 1
        maxcoef = max(maxcoef, s)
        if out_layout & CH(i):
            out_i += 1

    if normalize and maxcoef > 1.0:
        out /= maxcoef
    return out
