"""ISO/IEC 14496-2 + H.263 spec constant tables (Annex B VLCs; same
normative values as reference libavcodec/mpeg4data.h / h263data.c)."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

from libav_tpu_torch.bitstream.vlc import VLC

# --- intra DC size tables (14496-2 table B-13/B-14): (code, bits) by size
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
          (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
            (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)]

# --- MCBPC (H.263 table 8 / 14496-2 B-6, B-7) ---
# intra picture: index = (0..3: intra cbpc) (4..7: intra+q cbpc)
INTRA_MCBPC = ([1, 1, 2, 3, 1, 1, 2, 3, 1],
               [1, 3, 3, 3, 4, 6, 6, 6, 9])
# inter picture: groups of 4 cbpc values: inter, intra, interQ, intraQ,
# inter4v, (stuffing), inter4vQ
INTER_MCBPC_CODE = [1, 3, 2, 5,
                    3, 4, 3, 3,
                    3, 7, 6, 5,
                    4, 4, 3, 2,
                    2, 5, 4, 5,
                    1, 0, 0, 0,
                    2, 12, 14, 15]
INTER_MCBPC_BITS = [1, 4, 4, 6,
                    5, 8, 8, 7,
                    3, 7, 7, 9,
                    6, 9, 9, 9,
                    3, 7, 7, 8,
                    9, 0, 0, 0,
                    11, 13, 13, 13]
# mb_type group indices in the tables above
MBT_INTER, MBT_INTRA, MBT_INTERQ, MBT_INTRAQ, MBT_INTER4V = 0, 1, 2, 3, 4

# --- CBPY (table B-8): (code, bits) indexed by intra cbpy value ---
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]

# --- motion vector table (B-12): (code, bits) for |value| 0..32,
# sign bit appended for nonzero ---
MVTAB = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
         (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
         (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10),
         (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11),
         (3, 11), (2, 11), (3, 12), (2, 12)]

# --- 3D run-level VLC tables (B-16 intra / B-17 inter): entry i decodes to
# (last, run, level); entries [0, LAST_SPLIT) are last=0. Index 102 = ESC.
INTRA_VLC = [
    (0x2, 2), (0x6, 3), (0xF, 4), (0xD, 5), (0xC, 5), (0x15, 6), (0x13, 6),
    (0x12, 6), (0x17, 7), (0x1F, 8), (0x1E, 8), (0x1D, 8), (0x25, 9),
    (0x24, 9), (0x23, 9), (0x21, 9), (0x21, 10), (0x20, 10), (0xF, 10),
    (0xE, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11), (0x50, 12),
    (0x51, 12), (0x52, 12), (0xE, 4), (0x14, 6), (0x16, 7), (0x1C, 8),
    (0x20, 9), (0x1F, 9), (0xD, 10), (0x22, 11), (0x53, 12), (0x55, 12),
    (0xB, 5), (0x15, 7), (0x1E, 9), (0xC, 10), (0x56, 12), (0x11, 6),
    (0x1B, 8), (0x1D, 9), (0xB, 10), (0x10, 6), (0x22, 9), (0xA, 10),
    (0xD, 6), (0x1C, 9), (0x8, 10), (0x12, 7), (0x1B, 9), (0x54, 12),
    (0x14, 7), (0x1A, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8),
    (0x23, 11), (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12),
    (0x7, 4), (0xC, 6), (0x16, 8), (0x17, 9), (0x6, 10), (0x5, 11),
    (0x4, 11), (0x59, 12), (0xF, 6), (0x16, 9), (0x5, 10), (0xE, 6),
    (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7),
    (0x5A, 12), (0x15, 8), (0x5B, 12), (0x14, 8), (0x13, 8), (0x1A, 8),
    (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x26, 11),
    (0x27, 11), (0x5C, 12), (0x5D, 12), (0x5E, 12), (0x5F, 12), (0x3, 7),
]
INTRA_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5,
    6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1,
    1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
]
INTRA_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11,
    12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2,
    3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
]
INTRA_LAST_SPLIT = 67   # entries >= 67 have last=1

INTER_VLC = [
    (0x2, 2), (0xF, 4), (0x15, 6), (0x17, 7), (0x1F, 8), (0x25, 9),
    (0x24, 9), (0x21, 10), (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x6, 3), (0x14, 6), (0x1E, 8), (0xF, 10), (0x21, 11), (0x50, 12),
    (0xE, 4), (0x1D, 8), (0xE, 10), (0x51, 12), (0xD, 5), (0x23, 9),
    (0xD, 10), (0xC, 5), (0x22, 9), (0x52, 12), (0xB, 5), (0xC, 10),
    (0x53, 12), (0x13, 6), (0xB, 10), (0x54, 12), (0x12, 6), (0xA, 10),
    (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10), (0x16, 7), (0x55, 12),
    (0x15, 7), (0x14, 7), (0x1C, 8), (0x1B, 8), (0x21, 9), (0x20, 9),
    (0x1F, 9), (0x1E, 9), (0x1D, 9), (0x1C, 9), (0x1B, 9), (0x1A, 9),
    (0x22, 11), (0x23, 11), (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9),
    (0x5, 11), (0xF, 6), (0x4, 11), (0xE, 6), (0xD, 6), (0xC, 6),
    (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1A, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8),
    (0x18, 9), (0x17, 9), (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9),
    (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10), (0x5, 10), (0x4, 10),
    (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12), (0x59, 12),
    (0x5A, 12), (0x5B, 12), (0x5C, 12), (0x5D, 12), (0x5E, 12), (0x5F, 12),
    (0x3, 7),
]
INTER_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4,
    5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1,
    2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
]
INTER_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6,
    6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2,
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
]
INTER_LAST_SPLIT = 58

ESC_INDEX = 102


@functools.lru_cache(maxsize=None)
def dc_lum_vlc() -> VLC:
    return VLC(9, codes=[c for c, b in DC_LUM], lengths=[b for c, b in DC_LUM])


@functools.lru_cache(maxsize=None)
def dc_chrom_vlc() -> VLC:
    return VLC(9, codes=[c for c, b in DC_CHROM],
               lengths=[b for c, b in DC_CHROM])


@functools.lru_cache(maxsize=None)
def intra_mcbpc_vlc() -> VLC:
    return VLC(9, codes=INTRA_MCBPC[0], lengths=INTRA_MCBPC[1])


@functools.lru_cache(maxsize=None)
def inter_mcbpc_vlc() -> VLC:
    codes, lengths, values = [], [], []
    for i, (c, b) in enumerate(zip(INTER_MCBPC_CODE, INTER_MCBPC_BITS)):
        if b == 0:
            continue
        codes.append(c)
        lengths.append(b)
        values.append(i)
    return VLC(9, codes=codes, lengths=lengths, values=values)


@functools.lru_cache(maxsize=None)
def cbpy_vlc() -> VLC:
    return VLC(6, codes=[c for c, b in CBPY], lengths=[b for c, b in CBPY])


@functools.lru_cache(maxsize=None)
def mv_vlc() -> VLC:
    return VLC(9, codes=[c for c, b in MVTAB], lengths=[b for c, b in MVTAB])


@functools.lru_cache(maxsize=None)
def rl_vlc(intra: bool) -> VLC:
    tab = INTRA_VLC if intra else INTER_VLC
    return VLC(9, codes=[c for c, b in tab], lengths=[b for c, b in tab])


@functools.lru_cache(maxsize=None)
def rl_decode_tuple(intra: bool):
    """index -> (last, run, level)"""
    runs = INTRA_RUN if intra else INTER_RUN
    levels = INTRA_LEVEL if intra else INTER_LEVEL
    split = INTRA_LAST_SPLIT if intra else INTER_LAST_SPLIT
    return [(1 if i >= split else 0, runs[i], levels[i])
            for i in range(102)]


@functools.lru_cache(maxsize=None)
def rl_encode_map(intra: bool) -> Dict[Tuple[int, int, int], Tuple[int, int]]:
    """(last, run, level>0) -> (code, bits); sign bit appended."""
    tab = INTRA_VLC if intra else INTER_VLC
    out = {}
    for i, (last, run, level) in enumerate(rl_decode_tuple(intra)):
        out[(last, run, level)] = tab[i]
    return out


@functools.lru_cache(maxsize=None)
def rl_max_level(intra: bool) -> Dict[Tuple[int, int], int]:
    """(last, run) -> LMAX for ESC type-1 coding."""
    out: Dict[Tuple[int, int], int] = {}
    for last, run, level in rl_decode_tuple(intra):
        out[(last, run)] = max(out.get((last, run), 0), level)
    return out


@functools.lru_cache(maxsize=None)
def rl_max_run(intra: bool) -> Dict[Tuple[int, int], int]:
    """(last, level) -> RMAX for ESC type-2 coding."""
    out: Dict[Tuple[int, int], int] = {}
    for last, run, level in rl_decode_tuple(intra):
        out[(last, level)] = max(out.get((last, level), 0), run)
    return out


# MPEG quant (quant_type=1) default matrices, raster order (ISO 14496-2
# Tables 6-9/6-10 — disclosed spec-constant extraction, reference
# mpeg4data.h:337/348)
DEFAULT_INTRA_MATRIX = [
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45,
]
DEFAULT_INTER_MATRIX = [
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33,
]


# sprite trajectory dmv length codes (ISO 14496-2 Table B-30; reference
# mpeg4data.h ff_sprite_trajectory_tab) — value = length class 0..14
SPRITE_TRAJ = (
    (0x00, 2), (0x02, 3), (0x03, 3), (0x04, 3), (0x05, 3), (0x06, 3),
    (0x0E, 4), (0x1E, 5), (0x3E, 6), (0x7E, 7), (0xFE, 8),
    (0x1FE, 9), (0x3FE, 10), (0x7FE, 11), (0xFFE, 12),
)


@functools.lru_cache(maxsize=None)
def sprite_traj_vlc() -> VLC:
    return VLC(9, codes=[c for c, b in SPRITE_TRAJ],
               lengths=[b for c, b in SPRITE_TRAJ])
