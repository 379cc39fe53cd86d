"""MSMPEG4v3 (MPEG-4 part 2 Microsoft variant 3, 'DivX 3'), MSMPEG4v2 and
WMV1 decoders (counterpart of `libav_tpu/codecs/msmpeg4dec.py`, its host
code copied and changed only in its imports and where it reaches a device
program; reference: libavcodec/msmpeg4dec.c ff_msmpeg4_decode_picture_header /
msmpeg4v34_decode_mb / ff_msmpeg4_decode_block, msmpeg4.c
ff_msmpeg4_pred_dc + ff_msmpeg4_coded_block_pred, tables from
msmpeg4data.c via tools/gen_msmpeg4_tables.py).

Host: picture/MB entropy — 6 run-level codebooks selected per frame,
two DC codebooks with the divide-style gradient predictor, I-frame
coded-block-pattern prediction, paired-MV codebooks with the -32/±64
wrap. Device, on the decoder's torch device (`MSMPEG4v3Decoder(params,
device="cuda")` by default; "cpu" runs the same program on the CPU): one
`codecs/mpegvideo.py` `Recon` per picture, of the 'h263' kind (v3: the
same (2|L|+1)q dequant and MPEG-4 DC scalers as the reference's
unquantizers), 'h263sh' (v2: DC scale 8) or 'wmv1' (WMV1's DC scale
tables), whose IDCT is one launch of kernel K2."""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs import msmpeg4_tables as M
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpeg4 import tables as T
from libav_tpu_torch.codecs.mpeg4.dec import (_VopPred, _pred_ac,
                                              _store_ac, PICT_I, PICT_P)
from libav_tpu_torch.codecs.mpeg12.dec import MBData
from libav_tpu_torch.codecs import mpegvideo
from libav_tpu_torch.ops.quant import (alternate_horizontal_scan,
                                       alternate_scan, mpeg4_dc_scaler,
                                       zigzag_scan)

DC_MAX = 119


@functools.lru_cache(maxsize=None)
def _vlc_pairs(name: str) -> VLC:
    pairs = getattr(M, name)
    return VLC(9, codes=[c for c, b in pairs],
               lengths=[b for c, b in pairs])


@functools.lru_cache(maxsize=None)
def _rl(idx: int):
    """-> (vlc, tuples, esc_index, lmax, rmax) for ff_rl_table[idx]."""
    n, last, src = M.RL_META[idx]
    if src == "MPEG4_INTRA":
        return (T.rl_vlc(True), T.rl_decode_tuple(True), T.ESC_INDEX,
                T.rl_max_level(True), T.rl_max_run(True))
    if src == "H263_INTER":
        return (T.rl_vlc(False), T.rl_decode_tuple(False), T.ESC_INDEX,
                T.rl_max_level(False), T.rl_max_run(False))
    pairs = getattr(M, src + "_VLC")
    runs = getattr(M, src + "_RUN")
    lvls = getattr(M, src + "_LEVEL")
    vlc = VLC(9, codes=[c for c, b in pairs],
              lengths=[b for c, b in pairs])
    tuples = {i: (1 if i >= last else 0, runs[i], lvls[i])
              for i in range(n)}
    lmax, rmax = {}, {}
    for lastf, run, lvl in tuples.values():
        lmax[(lastf, run)] = max(lmax.get((lastf, run), 0), lvl)
        rmax[(lastf, lvl)] = max(rmax.get((lastf, lvl), 0), run)
    return vlc, tuples, n, lmax, rmax


@functools.lru_cache(maxsize=None)
def _mv_table(idx: int):
    code = getattr(M, f"TABLE{idx}_MV_CODE")
    bits = getattr(M, f"TABLE{idx}_MV_BITS")
    mvx = getattr(M, f"TABLE{idx}_MVX")
    mvy = getattr(M, f"TABLE{idx}_MVY")
    return (VLC(9, codes=code, lengths=bits), mvx, mvy,
            len(mvx))                          # n = escape symbol


def _decode012(gb) -> int:
    if not gb.get_bits(1):
        return 0
    return gb.get_bits(1) + 1


@register_codec
class MSMPEG4v3Decoder(Decoder):
    NAME = "msmpeg4v3"
    ALIASES = ("msmpeg4",)
    TYPE = MediaType.VIDEO
    LONG_NAME = "MPEG-4 part 2 Microsoft variant 3"
    QUANT_KIND = "h263"
    EXT_HEADER_BITS = 17
    # coefficient scans (v4/WMV1 overrides with its own tables)
    SCAN_INTER = None          # None = zigzag (sequence == storage)
    SCAN_INTRA = None
    SCAN_INTRA_V = "alt_v"
    SCAN_INTRA_H = "alt_h"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MSMPEG4v3Decoder(params, options, device=...) — planes of the
        output frames (and the references) are uint8 tensors on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _seq_remap(self, out, seq, scan):
        """sequence-order coefficients -> zigzag storage via a raster
        round-trip when the coding scan is not the zigzag."""
        raster = np.zeros(64, np.int64)
        raster[np.asarray(scan)] = seq
        out[np.arange(64)] = raster[np.asarray(zigzag_scan())]

    def _init(self):
        if self.width <= 0 or self.height <= 0:
            raise AVError(INVALIDDATA, "msmpeg4: container must supply "
                                       "dimensions")
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        self._refs = None

    def _flush(self):
        self._refs = None

    # -- picture layer -------------------------------------------------- #

    def _decode(self, pkt: Packet) -> List[Frame]:
        gb = GetBits(bytes(pkt.data))
        pict_type = gb.get_bits(2) + 1        # 1=I 2=P (AV enum)
        if pict_type not in (1, 2):
            raise AVError(INVALIDDATA, "msmpeg4: bad picture type")
        qscale = gb.get_bits(5)
        if qscale == 0:
            raise AVError(INVALIDDATA, "msmpeg4: qscale 0")
        self._use_skip = 0
        self._parse_header_tail(gb, pict_type)

        self._cur_qscale = qscale
        if pict_type == 1:
            self._no_rounding = 1
        elif getattr(self, "_flipflop", 0):
            self._no_rounding = getattr(self, "_no_rounding", 1) ^ 1
        else:
            self._no_rounding = 0

        nmb = self.mb_w * self.mb_h
        mb = MBData(nmb)
        mb.qscale[:] = qscale
        mb.skipped = np.zeros(nmb, dtype=bool)
        try:
            self._decode_mbs(gb, mb, pict_type, qscale)
        except AVError as e:
            mb.ok[:] = False
            log.warning(self, "msmpeg4 MB error, concealing: %s", e)
        if pict_type == 1 and self.EXT_HEADER_BITS:
            # trailing extension header on I frames (msmpeg4dec.c:538
            # ff_msmpeg4_decode_ext_header): fps(5) bitrate(11)
            # [flipflop_rounding(1) for v3]
            n = self.EXT_HEADER_BITS
            left = gb.size_bits - gb.pos
            if n <= left < n + 8:
                gb.skip_bits(5)
                gb.get_bits(11)
                if n >= 17:
                    self._flipflop = gb.get_bits(1)
            elif left < n + 8:
                self._flipflop = 0
        if not mb.ok.all():
            from libav_tpu_torch.codecs.er import conceal_missing
            conceal_missing(mb, self.mb_w, self.mb_h,
                            self._refs is not None)

        dummy_q = torch.ones(64, dtype=torch.int32, device=self.device)
        recon_jit = hwdevice.program_factory(mpegvideo.recon, self.device)
        fn = recon_jit(self.mb_w, self.mb_h, self.QUANT_KIND, False,
                       pict_type == 2, self._no_rounding)
        zero = mpegvideo.zero_pad_refs(self.mb_w, self.mb_h,
                                       device=self.device)
        r0 = self._refs or zero
        planes, padded = fn(mb.coeffs, mb.qscale, mb.intra, mb.use_fwd,
                            mb.use_bwd, mb.mv_fwd, mb.mv_bwd,
                            dummy_q, dummy_q, *r0, *zero)
        self._refs = padded
        f = Frame(width=self.width, height=self.height,
                  format="yuv420p")
        f.planes = [planes[0][:self.height, :self.width],
                    planes[1][:(self.height + 1) // 2,
                              :(self.width + 1) // 2],
                    planes[2][:(self.height + 1) // 2,
                              :(self.width + 1) // 2]]
        f.pict_type = PictureType.I if pict_type == 1 else PictureType.P
        f.key_frame = pict_type == 1
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        return [f]

    def _parse_header_tail(self, gb, pict_type):
        if pict_type == 1:
            code = gb.get_bits(5)
            if code < 0x17:
                raise AVError(INVALIDDATA, "msmpeg4: bad slice code")
            self._slice_height = self.mb_h // (code - 0x16)
            self._rl_chroma = _decode012(gb)
            self._rl = _decode012(gb)
            self._dc_idx = gb.get_bits(1)
        else:
            self._use_skip = gb.get_bits(1)
            self._rl = _decode012(gb)
            self._rl_chroma = self._rl
            self._dc_idx = gb.get_bits(1)
            self._mv_idx = gb.get_bits(1)
            self._slice_height = self.mb_h

    # -- MB layer -------------------------------------------------------- #

    def _decode_mbs(self, gb, mb: MBData, pict_type, qscale):
        mw, mh = self.mb_w, self.mb_h
        pred = _VopPred(mw, mh)
        # coded-block prediction grid for I frames (b8 layout, +1
        # borders = 0; reference ff_msmpeg4_coded_block_pred)
        cbg = np.zeros((2 * mh + 1, 2 * mw + 1), np.int8)
        self._acv = pred.acv
        self._dcg = (pred.dc_y, pred.dc_u, pred.dc_v)
        mb_i_vlc = _vlc_pairs("MB_I")
        mb_p_vlc = _vlc_pairs("MB_NON_INTRA")

        for mb_y in range(mh):
            if mb_y and mb_y % self._slice_height == 0:
                pred.resync(0, mb_y)          # slice: reset predictors
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                is_intra = True
                cbp = 0
                if pict_type == 2:
                    if self._use_skip and gb.get_bits(1):
                        mb.use_fwd[idx] = True
                        mb.mv_fwd[idx] = 0
                        mb.skipped[idx] = True
                        mb.ok[idx] = True
                        pred.grid_put(mb_x, mb_y, 0, 0, 0)
                        for k in range(1, 4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)
                        continue
                    code = mb_p_vlc.read(gb)
                    is_intra = not (code & 0x40)
                    cbp = code & 0x3F
                    if not is_intra and \
                            getattr(self, "_per_mb_rl", 0) and cbp:
                        self._rl = _decode012(gb)
                        self._rl_chroma = self._rl
                else:
                    code = mb_i_vlc.read(gb)
                    for i in range(6):
                        val = (code >> (5 - i)) & 1
                        if i < 4:
                            bx = 2 * mb_x + (i & 1) + 1
                            by = 2 * mb_y + (i >> 1) + 1
                            a = cbg[by, bx - 1]
                            b = cbg[by - 1, bx - 1]
                            c = cbg[by - 1, bx]
                            val ^= int(a if b == c else c)
                            cbg[by, bx] = val
                        cbp |= val << (5 - i)

                ac_pred = 0
                if not is_intra:
                    px, py = pred.grid_pred(mb_x, mb_y, 0)
                    vx, vy = self._decode_motion(gb, px, py)
                    mb.use_fwd[idx] = True
                    mb.mv_fwd[idx] = (vx, vy)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, vx, vy)
                else:
                    mb.intra[idx] = True
                    if pict_type == 2:
                        for k in range(4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)
                    ac_pred = gb.get_bits(1)
                    if getattr(self, "_per_mb_rl", 0) and cbp:
                        self._rl = _decode012(gb)
                        self._rl_chroma = self._rl

                first_line = pred.first_line(mb_x, mb_y)
                for b in range(6):
                    coded = (cbp >> (5 - b)) & 1
                    if is_intra:
                        self._intra_block(gb, mb.coeffs[idx, b], b,
                                          mb_x, mb_y, qscale, coded,
                                          ac_pred, first_line)
                    elif coded:
                        if self.SCAN_INTER is None:
                            self._rl_block(gb, mb.coeffs[idx, b], 0,
                                           3 + self._rl)
                        else:
                            seq = np.zeros(64, np.int64)
                            self._rl_block(gb, seq, 0, 3 + self._rl)
                            self._seq_remap(mb.coeffs[idx, b], seq,
                                            self.SCAN_INTER)
                mb.ok[idx] = True

    # -- motion ---------------------------------------------------------- #

    def _decode_motion(self, gb, px, py):
        """reference: msmpeg4dec.c ff_msmpeg4_decode_motion."""
        vlc, mvx, mvy, n = _mv_table(self._mv_idx)
        code = vlc.read(gb)
        if code == n:
            mx, my = gb.get_bits(6), gb.get_bits(6)
        else:
            mx, my = mvx[code], mvy[code]
        mx += px - 32
        my += py - 32
        if mx <= -64:
            mx += 64
        elif mx >= 64:
            mx -= 64
        if my <= -64:
            my += 64
        elif my >= 64:
            my -= 64
        return mx, my

    # -- blocks ----------------------------------------------------------#

    def _intra_block(self, gb, out, b, mb_x, mb_y, qscale, coded,
                     ac_pred, first_line):
        lvl, dc_dir = self._decode_dc(gb, b, mb_x, mb_y, qscale,
                                      first_line)
        out[0] = lvl
        rl_idx = self._rl if b < 4 else 3 + self._rl_chroma
        if ac_pred:
            if dc_dir == 0:
                scan = (np.asarray(alternate_scan())
                        if self.SCAN_INTRA_V == "alt_v"
                        else np.asarray(self.SCAN_INTRA_V))
            else:
                scan = (np.asarray(alternate_horizontal_scan())
                        if self.SCAN_INTRA_H == "alt_h"
                        else np.asarray(self.SCAN_INTRA_H))
            tmp = np.zeros(64, np.int64)
            if coded:
                self._rl_block(gb, tmp, 1, rl_idx)
            raster = np.zeros(64, np.int64)
            raster[scan] = tmp
            raster[0] = lvl
            _pred_ac(self, raster, b, mb_x, mb_y, dc_dir, self._acv,
                     None, qscale, self.mb_w)
            _store_ac(raster, b, mb_x, mb_y, self._acv)
            out[np.arange(64)] = raster[np.asarray(zigzag_scan())]
            out[0] = lvl
            return
        if coded:
            if self.SCAN_INTRA is None:
                self._rl_block(gb, out, 1, rl_idx)
            else:
                seq = np.zeros(64, np.int64)
                self._rl_block(gb, seq, 1, rl_idx)
                self._seq_remap(out, seq, self.SCAN_INTRA)
                out[0] = lvl
        raster = np.zeros(64, np.int64)
        raster[np.asarray(zigzag_scan())] = out
        _store_ac(raster, b, mb_x, mb_y, self._acv)

    def _decode_dc(self, gb, b, mb_x, mb_y, qscale, first_line):
        """reference: msmpeg4_decode_dc + ff_msmpeg4_pred_dc (v3:
        divide-then-compare with <=, first-line kill of b/c for the
        MB-top blocks)."""
        luma = b < 4
        name = ("TABLE%d_DC_%s" % (self._dc_idx,
                                   "LUM" if luma else "CHROMA"))
        level = _vlc_pairs(name).read(gb)
        if level == DC_MAX:
            level = gb.get_bits(8)
            if gb.get_bits(1):
                level = -level
        elif level != 0:
            if gb.get_bits(1):
                level = -level

        scale = mpeg4_dc_scaler(qscale, luma)
        if luma:
            bx = 2 * mb_x + (b & 1) + 1
            by = 2 * mb_y + (b >> 1) + 1
            grid = self._dcg[0]
        else:
            bx, by = mb_x + 1, mb_y + 1
            grid = self._dcg[1 if b == 4 else 2]
        a = int(grid[by, bx - 1])
        bb = int(grid[by - 1, bx - 1])
        c = int(grid[by - 1, bx])
        if first_line and (b & 2) == 0:
            bb = c = 1024
        a = (a + (scale >> 1)) // scale
        bb = (bb + (scale >> 1)) // scale
        c = (c + (scale >> 1)) // scale
        if abs(a - bb) <= abs(bb - c):
            pred, dc_dir = c, 1
        else:
            pred, dc_dir = a, 0
        level += pred
        if level < 0:
            raise AVError(INVALIDDATA, "msmpeg4: dc underflow")
        grid[by, bx] = level * scale
        return level, dc_dir

    INTER_RUN_DIFF = 1                       # v3; v2 uses 0

    def _rl_block(self, gb, out, start, rl_idx):
        """reference: ff_msmpeg4_decode_block AC loop: escape
        hierarchy 1 = level-extend, 01 = run-extend (+run_diff), 00 =
        FLC last/run/level."""
        vlc, tuples, esc, lmax, rmax = _rl(rl_idx)
        run_diff = 0 if start else self.INTER_RUN_DIFF
        k = start
        while True:
            v = vlc.read(gb)
            if v == esc:
                if gb.get_bits(1):             # first escape: level ext
                    v2 = vlc.read(gb)
                    if v2 == esc:
                        raise AVError(INVALIDDATA, "msmpeg4: double esc")
                    last, run, level = tuples[v2]
                    level += lmax.get((last, run), 0)
                    if gb.get_bits(1):
                        level = -level
                elif gb.get_bits(1):           # second: run extend
                    v2 = vlc.read(gb)
                    if v2 == esc:
                        raise AVError(INVALIDDATA, "msmpeg4: double esc")
                    last, run, level = tuples[v2]
                    run += rmax.get((last, abs(level)), 0) + run_diff
                    if gb.get_bits(1):
                        level = -level
                else:                          # third: FLC
                    last = gb.get_bits(1)
                    run = gb.get_bits(6)
                    level = gb.get_sbits(8)
            else:
                last, run, level = tuples[v]
                if gb.get_bits(1):
                    level = -level
            k += run
            if k > 63:
                raise AVError(INVALIDDATA, "msmpeg4: AC overflow")
            out[k] = level
            k += 1
            if last:
                break


@functools.lru_cache(maxsize=None)
def _v2_dc_vlc(luma: bool) -> VLC:
    """v1/v2 unified DC codebook, generated exactly like the reference
    (msmpeg4.c init_h263_dc_for_msmpeg4: inverted MPEG-4 DC size code +
    mantissa + marker past size 8); value = level + 256."""
    base = T.DC_LUM if luma else T.DC_CHROM
    codes, lens = [], []
    for level in range(-256, 256):
        v = abs(level)
        size = v.bit_length()
        l = (-level) ^ ((1 << size) - 1) if level < 0 else level
        code, ln = base[size]
        code ^= (1 << ln) - 1
        if size > 0:
            code = (code << size) | l
            ln += size
            if size > 8:
                code = (code << 1) | 1
                ln += 1
        codes.append(code)
        lens.append(ln)
    return VLC(9, codes=codes, lengths=lens)


@functools.lru_cache(maxsize=None)
def _v2_vlcs():
    # ff_v2_mb_type / ff_v2_intra_cbpc (msmpeg4data.c:1786)
    mbt = [(1, 1), (0, 2), (3, 3), (9, 5), (5, 4), (0x21, 7),
           (0x20, 7), (0x11, 6)]
    intra_cbpc = [(1, 1), (0, 3), (1, 3), (1, 2)]
    return (VLC(6, codes=[c for c, b in mbt],
                lengths=[b for c, b in mbt]),
            VLC(3, codes=[c for c, b in intra_cbpc],
                lengths=[b for c, b in intra_cbpc]))


@register_codec
class MSMPEG4v2Decoder(MSMPEG4v3Decoder):
    """MSMPEG4v2 (reference: msmpeg4dec.c msmpeg4v12_decode_mb with
    version 2): fixed codebooks (intra = MPEG-4 intra RL, inter = H.263
    RL), the generated unified DC book, H.263 MV codes with the ±64
    wrap, v2 MB-type/cbpc VLCs, DC scale fixed at 8."""
    NAME = "msmpeg4v2"
    ALIASES = ()
    LONG_NAME = "MPEG-4 part 2 Microsoft variant 2"
    INTER_RUN_DIFF = 0
    QUANT_KIND = "h263sh"
    EXT_HEADER_BITS = 16

    def _parse_header_tail(self, gb, pict_type):
        if pict_type == 1:
            code = gb.get_bits(5)
            if code < 0x17:
                raise AVError(INVALIDDATA, "msmpeg4v2: bad slice code")
            self._slice_height = self.mb_h // (code - 0x16)
        else:
            self._use_skip = gb.get_bits(1)
            self._slice_height = self.mb_h
        self._rl = 2
        self._rl_chroma = 2
        self._flipflop = 0

    def _decode_mbs(self, gb, mb: MBData, pict_type, qscale):
        mw, mh = self.mb_w, self.mb_h
        pred = _VopPred(mw, mh)
        self._acv = pred.acv
        self._dcg = (pred.dc_y, pred.dc_u, pred.dc_v)
        mbt_vlc, icbpc_vlc = _v2_vlcs()

        for mb_y in range(mh):
            if mb_y and mb_y % self._slice_height == 0:
                pred.resync(0, mb_y)
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                if pict_type == 2:
                    if self._use_skip and gb.get_bits(1):
                        mb.use_fwd[idx] = True
                        mb.mv_fwd[idx] = 0
                        mb.skipped[idx] = True
                        mb.ok[idx] = True
                        for k in range(4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)
                        continue
                    code = mbt_vlc.read(gb)
                    is_intra = bool(code >> 2)
                    cbp = code & 3
                else:
                    is_intra = True
                    cbp = icbpc_vlc.read(gb)

                ac_pred = 0
                if not is_intra:
                    cbpy = T.cbpy_vlc().read(gb)
                    cbp |= cbpy << 2
                    if (cbp & 3) != 3:
                        cbp ^= 0x3C
                    px, py = pred.grid_pred(mb_x, mb_y, 0)
                    vx = self._v2_motion(gb, px)
                    vy = self._v2_motion(gb, py)
                    mb.use_fwd[idx] = True
                    mb.mv_fwd[idx] = (vx, vy)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, vx, vy)
                else:
                    ac_pred = gb.get_bits(1)
                    cbp |= T.cbpy_vlc().read(gb) << 2
                    mb.intra[idx] = True
                    if pict_type == 2:
                        for k in range(4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)

                first_line = pred.first_line(mb_x, mb_y)
                for b in range(6):
                    coded = (cbp >> (5 - b)) & 1
                    if is_intra:
                        self._intra_block(gb, mb.coeffs[idx, b], b,
                                          mb_x, mb_y, qscale, coded,
                                          ac_pred, first_line)
                    elif coded:
                        self._rl_block(gb, mb.coeffs[idx, b], 0,
                                       3 + self._rl_chroma)
                mb.ok[idx] = True

    @staticmethod
    def _v2_motion(gb, pred_v):
        """msmpeg4v2_decode_motion (f_code 1): H.263 MV codes, ±64
        wrap."""
        code = T.mv_vlc().read(gb)
        if code == 0:
            val = pred_v
        else:
            val = -code if gb.get_bits(1) else code
            val += pred_v
        if val <= -64:
            val += 64
        elif val >= 64:
            val -= 64
        return val

    def _decode_dc(self, gb, b, mb_x, mb_y, qscale, first_line):
        level = _v2_dc_vlc(b < 4).read(gb) - 256
        scale = 8                              # ff_mpeg1_dc_scale_table
        if b < 4:
            bx = 2 * mb_x + (b & 1) + 1
            by = 2 * mb_y + (b >> 1) + 1
            grid = self._dcg[0]
        else:
            bx, by = mb_x + 1, mb_y + 1
            grid = self._dcg[1 if b == 4 else 2]
        a = int(grid[by, bx - 1])
        bb = int(grid[by - 1, bx - 1])
        c = int(grid[by - 1, bx])
        if first_line and (b & 2) == 0:
            bb = c = 1024
        a = (a + 4) // 8
        bb = (bb + 4) // 8
        c = (c + 4) // 8
        if abs(a - bb) <= abs(bb - c):
            pred, dc_dir = c, 1
        else:
            pred, dc_dir = a, 0
        level += pred
        if level < 0:
            raise AVError(INVALIDDATA, "msmpeg4v2: dc underflow")
        grid[by, bx] = level * scale
        return level, dc_dir


@register_codec
class WMV1Decoder(MSMPEG4v3Decoder):
    """WMV1 / msmpeg4 version 4 (reference: msmpeg4dec.c version-4
    branches): inline ext header (fps/bitrate/flipflop) in I headers,
    bitrate-gated per-MB RL table selection, the four WMV1 coefficient
    scans, stateful ESC3 (variable run/level field widths signalled
    once per frame), v4 DC prediction (strict <, no first-line kill),
    WMV1 DC scale tables.  inter_intra prediction (tiny low-rate
    streams) is rejected as unsupported."""
    NAME = "wmv1"
    ALIASES = ("msmpeg4v4",)
    LONG_NAME = "Windows Media Video 7"
    QUANT_KIND = "wmv1"
    EXT_HEADER_BITS = 0            # parsed inline in the I header
    SCAN_INTER = M.WMV1_SCAN[0]
    SCAN_INTRA = M.WMV1_SCAN[1]
    SCAN_INTRA_H = M.WMV1_SCAN[2]
    SCAN_INTRA_V = M.WMV1_SCAN[3]
    MBAC_BITRATE = 50 * 1024
    II_BITRATE = 128 * 1024

    def _parse_header_tail(self, gb, pict_type):
        self._esc3_ll = 0
        self._esc3_rl = 0
        if pict_type == 1:
            code = gb.get_bits(5)
            if code < 0x17:
                raise AVError(INVALIDDATA, "wmv1: bad slice code")
            self._slice_height = self.mb_h // (code - 0x16)
            # inline ext header (msmpeg4dec.c case 4:
            # ff_msmpeg4_decode_ext_header at a fixed offset)
            gb.skip_bits(5)                   # fps
            self._bit_rate = gb.get_bits(11) * 1024
            self._flipflop = gb.get_bits(1)
            self._per_mb_rl = gb.get_bits(1) \
                if self._bit_rate > self.MBAC_BITRATE else 0
            if not self._per_mb_rl:
                self._rl_chroma = _decode012(gb)
                self._rl = _decode012(gb)
            self._dc_idx = gb.get_bits(1)
            self._inter_intra = 0
        else:
            self._use_skip = gb.get_bits(1)
            self._per_mb_rl = gb.get_bits(1) \
                if getattr(self, "_bit_rate", 0) > self.MBAC_BITRATE \
                else 0
            if not self._per_mb_rl:
                self._rl = _decode012(gb)
                self._rl_chroma = self._rl
            self._dc_idx = gb.get_bits(1)
            self._mv_idx = gb.get_bits(1)
            self._inter_intra = (
                self.width * self.height < 320 * 240 and
                getattr(self, "_bit_rate", 0) <= self.II_BITRATE)
            if self._inter_intra:
                raise AVError(INVALIDDATA, "wmv1: inter_intra "
                              "prediction not supported")
            self._slice_height = self.mb_h

    def _decode_mbs(self, gb, mb, pict_type, qscale):
        self._gb_per_mb = gb                  # per-MB RL hook
        return super()._decode_mbs(gb, mb, pict_type, qscale)

    def _decode_dc(self, gb, b, mb_x, mb_y, qscale, first_line):
        """v4: strict < comparison, no first-line override
        (msmpeg4.c ff_msmpeg4_pred_dc version>3 path)."""
        luma = b < 4
        name = ("TABLE%d_DC_%s" % (self._dc_idx,
                                   "LUM" if luma else "CHROMA"))
        level = _vlc_pairs(name).read(gb)
        if level == DC_MAX:
            level = gb.get_bits(8)
            if gb.get_bits(1):
                level = -level
        elif level != 0:
            if gb.get_bits(1):
                level = -level
        tab = M.WMV1_Y_DC_SCALE if luma else M.WMV1_C_DC_SCALE
        scale = tab[min(max(qscale, 1), 31)]
        if luma:
            bx = 2 * mb_x + (b & 1) + 1
            by = 2 * mb_y + (b >> 1) + 1
            grid = self._dcg[0]
        else:
            bx, by = mb_x + 1, mb_y + 1
            grid = self._dcg[1 if b == 4 else 2]
        a = int(grid[by, bx - 1])
        bb = int(grid[by - 1, bx - 1])
        c = int(grid[by - 1, bx])
        a = (a + (scale >> 1)) // scale
        bb = (bb + (scale >> 1)) // scale
        c = (c + (scale >> 1)) // scale
        if abs(a - bb) < abs(bb - c):
            pred, dc_dir = c, 1
        else:
            pred, dc_dir = a, 0
        level += pred
        if level < 0:
            raise AVError(INVALIDDATA, "wmv1: dc underflow")
        grid[by, bx] = level * scale
        return level, dc_dir

    def _rl_block(self, gb, out, start, rl_idx):
        """v4: intra run_diff 1; ESC3 with signalled field widths."""
        vlc, tuples, esc, lmax, rmax = _rl(rl_idx)
        run_diff = 1
        k = start
        while True:
            v = vlc.read(gb)
            if v == esc:
                if gb.get_bits(1):             # level extend
                    v2 = vlc.read(gb)
                    if v2 == esc:
                        raise AVError(INVALIDDATA, "wmv1: double esc")
                    last, run, level = tuples[v2]
                    level += lmax.get((last, run), 0)
                    if gb.get_bits(1):
                        level = -level
                elif gb.get_bits(1):           # run extend
                    v2 = vlc.read(gb)
                    if v2 == esc:
                        raise AVError(INVALIDDATA, "wmv1: double esc")
                    last, run, level = tuples[v2]
                    run += rmax.get((last, abs(level)), 0) + run_diff
                    if gb.get_bits(1):
                        level = -level
                else:                          # ESC3 (v4 form)
                    last = gb.get_bits(1)
                    if not self._esc3_ll:
                        if self._cur_qscale < 8:
                            ll = gb.get_bits(3)
                            if ll == 0:
                                ll = 8 + gb.get_bits(1)
                        else:
                            ll = 2
                            while ll < 8 and gb.get_bits(1) == 0:
                                ll += 1
                            if ll < 8:
                                gb.skip_bits(0)   # stop bit consumed
                        self._esc3_ll = ll
                        self._esc3_rl = gb.get_bits(2) + 3
                    run = gb.get_bits(self._esc3_rl)
                    sign = gb.get_bits(1)
                    level = gb.get_bits(self._esc3_ll)
                    if sign:
                        level = -level
            else:
                last, run, level = tuples[v]
                if gb.get_bits(1):
                    level = -level
            k += run
            if k > 63:
                raise AVError(INVALIDDATA, "wmv1: AC overflow")
            out[k] = level
            k += 1
            if last:
                break
