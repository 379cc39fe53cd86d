"""MPEG-4 part 2 host helpers that the encoder shares with the decoder
(counterpart of part of `libav_tpu/codecs/mpeg4/dec.py`; reference:
libavcodec/mpeg4videodec.c, h263.c, mpeg4video.c).

The JAX package's code, copied: `_rdiv` (ROUNDED_DIV), the picture types,
the video-packet markers and prefix length, the per-VOP prediction state
`_VopPred` (MV grid, DC grids, AC-prediction cells with video-packet
rules) and the AC prediction helpers `_ac_cell`, `_pred_ac` and
`_store_ac`. The encoder mirrors the decoder's prediction through them.

The MPEG-4 decoder itself is not ported yet: `find_decoder("mpeg4")`
raises DECODER_NOT_FOUND naming ROADMAP.md module queue step 8b.
"""

from __future__ import annotations

import numpy as np


def _rdiv(a: int, b: int) -> int:
    """ROUNDED_DIV with C truncation semantics (reference ROUNDED_DIV)."""
    if a >= 0:
        return (a + (b >> 1)) // b
    return -((-a + (b >> 1)) // b)

PICT_I, PICT_P, PICT_B, PICT_S = 0, 1, 2, 3

# data partitioning / video packet markers (reference: mpeg4video.h:53)
MOTION_MARKER = 0x1F001
DC_MARKER = 0x6B001


def _vpp_prefix_len(pict_type: int, fcode: int, bcode: int) -> int:
    """reference: mpeg4video.c:30 ff_mpeg4_get_video_packet_prefix_length"""
    if pict_type == PICT_I:
        return 16
    if pict_type == PICT_B:
        return max(fcode, bcode, 2) + 15
    return fcode + 15


def _med3(a, b, c):
    a, b, c = int(a), int(b), int(c)
    return min(max(a, b), max(b, c), max(a, c))


class _VopPred:
    """Per-VOP prediction state with video-packet (slice) semantics:
    the MV grid with ff_h263_pred_motion's first_slice_line/resync_mb_x
    candidate masking (h263.c:301), DC grids with ff_mpeg4_pred_dc's
    out-of-slice 1024 overrides (mpeg4video.h pred_dc), and the
    ff_mpeg4_clean_buffers ac_val region clear at each packet start
    (flat-range alias semantics preserved)."""

    _BLK_OFF = (2, 1, 1, -1)

    def __init__(self, mw: int, mh: int):
        self.mw, self.mh = mw, mh
        self.b8w = 2 * mw + 1
        self.motbuf = np.zeros(((2 * mh + 1) * self.b8w + 8, 2), np.int32)
        self.OFF = 4
        self.dc_y = np.full((2 * mh + 1, 2 * mw + 1), 1024, np.int64)
        self.dc_u = np.full((mh + 1, mw + 1), 1024, np.int64)
        self.dc_v = np.full((mh + 1, mw + 1), 1024, np.int64)
        self.acv = (np.zeros((2 * mh + 1, 2 * mw + 1, 14), np.int64),
                    np.zeros((mh + 1, mw + 1, 14), np.int64),
                    np.zeros((mh + 1, mw + 1, 14), np.int64))
        self.rx = 0
        self.ry = 0

    # -- slice bookkeeping -------------------------------------------- #

    def resync(self, mb_x: int, mb_y: int):
        """Start a new video packet at (mb_x, mb_y):
        reference h263dec.c:604 ff_mpeg4_clean_buffers at each resync."""
        self.rx, self.ry = mb_x, mb_y
        b8w = self.b8w
        # luma ac_val clear: flat range [(2y-1)*w + 2x-1, +2w+1) in the
        # reference's layout; ours is offset +3 (border convention)
        fl = self.acv[0].reshape(-1, 14)
        l0 = (2 * mb_y - 1) * b8w + 2 * mb_x - 1 + 3
        fl[max(0, l0):max(0, min(len(fl), l0 + 2 * b8w + 1))] = 0
        cw = self.mw + 1
        c0 = (mb_y - 1) * cw + mb_x - 1 + 2
        for g in (1, 2):
            fc = self.acv[g].reshape(-1, 14)
            fc[max(0, c0):max(0, min(len(fc), c0 + cw + 1))] = 0

    def first_line(self, mb_x: int, mb_y: int) -> bool:
        """s->first_slice_line (flips at mb_x==resync_mb_x on row
        resync_mb_y+1, h263dec.c:232)."""
        return mb_y == self.ry or (mb_y == self.ry + 1 and mb_x < self.rx)

    # -- MV prediction grid (ff_h263_pred_motion) --------------------- #

    def bidx(self, mb_x, mb_y, k):
        return self.b8w * (2 * mb_y + (k >> 1)) - 2 + 2 * mb_x + (k & 1)

    def grid_put(self, mb_x, mb_y, k, vx, vy):
        self.motbuf[self.OFF + self.bidx(mb_x, mb_y, k)] = (vx, vy)

    def grid_pred(self, mb_x, mb_y, k):
        xy = self.OFF + self.bidx(mb_x, mb_y, k)
        mot = self.motbuf
        b8w = self.b8w
        A = mot[xy - 1]
        if self.first_line(mb_x, mb_y) and k < 3:
            if k == 0:
                if mb_x == self.rx:
                    return 0, 0
                if mb_x + 1 == self.rx:
                    C = mot[xy + 2 - b8w]
                    if mb_x == 0:
                        return int(C[0]), int(C[1])
                    return (_med3(A[0], 0, C[0]), _med3(A[1], 0, C[1]))
                return int(A[0]), int(A[1])
            if k == 1:
                if mb_x + 1 == self.rx:
                    C = mot[xy + 1 - b8w]
                    return (_med3(A[0], 0, C[0]), _med3(A[1], 0, C[1]))
                return int(A[0]), int(A[1])
            # k == 2
            B = mot[xy - b8w]
            C = mot[xy + 1 - b8w]
            if mb_x == self.rx:
                mot[xy - 1] = 0          # the reference zeroes A in place
                A = mot[xy - 1]
            return (_med3(A[0], B[0], C[0]), _med3(A[1], B[1], C[1]))
        B = mot[xy - b8w]
        C = mot[xy + self._BLK_OFF[k] - b8w]
        return (_med3(A[0], B[0], C[0]), _med3(A[1], B[1], C[1]))

    # -- DC prediction (ff_mpeg4_pred_dc slice rules) ------------------ #

    def dc_ctx(self, n, mb_x, mb_y):
        if n < 4:
            bx = 2 * mb_x + (n & 1) + 1
            by = 2 * mb_y + (n >> 1) + 1
            grid = self.dc_y
        else:
            bx, by = mb_x + 1, mb_y + 1
            grid = self.dc_u if n == 4 else self.dc_v
        a = int(grid[by, bx - 1])
        b = int(grid[by - 1, bx - 1])
        c = int(grid[by - 1, bx])
        if self.first_line(mb_x, mb_y) and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and mb_x == self.rx:
                b = a = 1024
        if mb_x == self.rx and mb_y == self.ry + 1 and n in (0, 4, 5):
            b = 1024
        if abs(a - b) < abs(b - c):
            pred, dc_dir = c, 1
        else:
            pred, dc_dir = a, 0

        def store(val):
            grid[by, bx] = val
        return pred, store, dc_dir


def _ac_cell(b, mb_x, mb_y):
    """(grid index, bx, by) in the +1-offset ac_val grids."""
    if b < 4:
        return 0, 2 * mb_x + (b & 1) + 1, 2 * mb_y + (b >> 1) + 1
    return (1 if b == 4 else 2), mb_x + 1, mb_y + 1


def _pred_ac(ctx, raster, b, mb_x, mb_y, dc_dir, acv, qs_tab, qscale,
             mb_w):
    """Add the stored neighbor column/row (reference
    ff_mpeg4_pred_ac:78-110), rescaling by the neighbor MB's qscale when
    it lies in a different macroblock."""
    g, bx, by = _ac_cell(b, mb_x, mb_y)
    grid = acv[g]
    if dc_dir == 0:                     # left column
        vals = grid[by, bx - 1, 0:7]
        nq_i = (mb_y * mb_w + mb_x - 1)
        same = (mb_x == 0 or b in (1, 3) or qs_tab is None or
                int(qs_tab[nq_i]) == qscale or int(qs_tab[nq_i]) == 0)
        if same:
            raster[8::8] += vals
        else:
            nq = int(qs_tab[nq_i])
            for i in range(7):
                raster[8 * (i + 1)] += _rdiv(int(vals[i]) * nq, qscale)
    else:                               # top row
        vals = grid[by - 1, bx, 7:14]
        nq_i = ((mb_y - 1) * mb_w + mb_x)
        same = (mb_y == 0 or b in (2, 3) or qs_tab is None or
                int(qs_tab[nq_i]) == qscale or int(qs_tab[nq_i]) == 0)
        if same:
            raster[1:8] += vals
        else:
            nq = int(qs_tab[nq_i])
            for i in range(7):
                raster[i + 1] += _rdiv(int(vals[i]) * nq, qscale)


def _store_ac(raster, b, mb_x, mb_y, acv):
    g, bx, by = _ac_cell(b, mb_x, mb_y)
    acv[g][by, bx, 0:7] = raster[8::8]
    acv[g][by, bx, 7:14] = raster[1:8]
