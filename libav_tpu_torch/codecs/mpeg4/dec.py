"""MPEG-4 part 2 decoder (counterpart of `libav_tpu/codecs/mpeg4/dec.py`;
reference: libavcodec/mpeg4videodec.c, h263.c, mpeg4video.c).

Host, the JAX package's code, copied and changed only in its imports and
where it reaches a device program: VOS/VOL/VOP parsing with custom
quantiser matrices, the MB layer (MCBPC/CBPY, median MV prediction on the
8x8 grid, gradient DC prediction, AC prediction with the alternate scans
and qscale rescale, 3D run-level VLC with all three escapes), B-VOPs
(direct mode with TRB/TRD scaling, 8x8 direct from a 4MV colocated MB or
in quarter-sample mode, colocated-skip inheritance), S(GMC)-VOP sprite
trajectories and mcsel macroblocks, video packets with resync markers and
slice-aware prediction, data partitioning, and the concealment of a
damaged packet (codecs/er.py). Its per-VOP state is numpy and goes to the
device once per VOP.

Device, on the decoder's torch device (`MPEG4Decoder(params,
device="cuda")` by default; "cpu" runs the same programs on the CPU): one
`codecs/mpegvideo.py` `Recon` per coded VOP ('h263' or 'mpeg4mq'
dequant, quarter-sample and 4MV MC), whose IDCT is one launch of kernel
K2, and for an S-VOP the GMC warp of the reference planes (ops/gmc.py),
which mcsel macroblocks read as a zero-motion backward reference.

The encoder shares `_rdiv`, the picture types, the markers,
`_vpp_prefix_len`, `_VopPred`, `_ac_cell`, `_pred_ac` and `_store_ac`.
The JAX decoder's `_mv_pred`, which nothing calls, is left out.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs import mpegvideo
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.er import conceal_missing
from libav_tpu_torch.codecs.mpeg12.dec import MBData, find_start_codes
from libav_tpu_torch.codecs.mpeg4 import tables as T
from libav_tpu_torch.ops.gmc import (GMCParams, compute_warp_params,
                                     get_amv, warp_refs)
from libav_tpu_torch.ops.quant import (alternate_horizontal_scan,
                                       alternate_scan, mpeg4_dc_scaler,
                                       zigzag_scan)


def _rdiv(a: int, b: int) -> int:
    """ROUNDED_DIV with C truncation semantics (reference ROUNDED_DIV)."""
    if a >= 0:
        return (a + (b >> 1)) // b
    return -((-a + (b >> 1)) // b)

PICT_I, PICT_P, PICT_B, PICT_S = 0, 1, 2, 3

# data partitioning / video packet markers (reference: mpeg4video.h:53)
MOTION_MARKER = 0x1F001
DC_MARKER = 0x6B001
# 16-bit stuffing+marker prefixes per bit phase (mpeg4data.h:368)
RESYNC_PREFIX = (0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000,
                 0x0000)


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



@register_codec
class MPEG4Decoder(Decoder):
    NAME = "mpeg4"
    TYPE = MediaType.VIDEO
    LONG_NAME = "MPEG-4 part 2 (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MPEG4Decoder(params, options, device=...) — planes of the
        output frames (and the references) are uint8 tensors on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self.vol_width = 0
        self.vol_height = 0
        self.mb_w = self.mb_h = 0
        self.time_res = 25
        self.time_inc_bits = 5
        self.quant_type = 0
        self.quarter_sample = 0
        self._refs = None
        self._refs_prev = None
        self._dummy_q = torch.ones(64, dtype=torch.int32,
                                   device=self.device)
        # B-VOP state (reference: MpegEncContext time bookkeeping)
        self._time_base = 0
        self._last_time_base = 0
        self._last_nonb = 0
        self._pp_time = 0
        self._pb_time = 0
        self._col_mv = None          # next-P per-MB motion for direct
        self._col_skip = None
        self._pending = None         # (frame, pts): anchor reorder delay

    def _flush(self):
        self._refs = None
        self._refs_prev = None
        self._pending = None
        self._time_base = self._last_time_base = self._last_nonb = 0

    def _drain(self):
        if self._pending is not None:
            f, pts = self._pending
            self._pending = None
            f.pts = pts
            return [f]
        return []

    # ------------------------------------------------------------------ #

    def _decode(self, pkt: Packet) -> List[Frame]:
        data = pkt.data
        if self.extradata and self.vol_width == 0:
            self._parse_headers(self.extradata)
        frames = []
        codes = find_start_codes(data)
        for i, (off, code) in enumerate(codes):
            end = codes[i + 1][0] - 3 if i + 1 < len(codes) else len(data)
            seg = data[off + 1:end]
            if code == 0x20 or (0x20 <= code <= 0x2F):
                self._parse_vol(seg)
            elif code == 0xB6:
                out = self._decode_vop(seg, pkt)
                for f in out:
                    f.time_base = pkt.time_base
                    frames.append(f)
        return frames

    def _parse_headers(self, data: bytes):
        codes = find_start_codes(data)
        for i, (off, code) in enumerate(codes):
            end = codes[i + 1][0] - 3 if i + 1 < len(codes) else len(data)
            if 0x20 <= code <= 0x2F:
                self._parse_vol(data[off + 1:end])

    # ------------------------------------------------------------------ #

    def _parse_vol(self, seg: bytes):
        """reference: mpeg4videodec.c decode_vol_header"""
        gb = GetBits(seg)
        gb.get_bits(1)          # random_accessible
        gb.get_bits(8)          # type indication
        ver_id = 1
        if gb.get_bits(1):      # is_object_layer_identifier
            ver_id = gb.get_bits(4)
            gb.get_bits(3)      # priority
        aspect = gb.get_bits(4)
        if aspect == 15:
            gb.get_bits(16)
        if gb.get_bits(1):      # vol_control_parameters
            gb.get_bits(2 + 1)  # chroma_format, low_delay
            if gb.get_bits(1):  # vbv_parameters
                gb.get_bits(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1)
        shape = gb.get_bits(2)
        if shape != 0:
            raise AVError(INVALIDDATA, "only rectangular VOL supported")
        gb.get_bits(1)          # marker
        self.time_res = gb.get_bits(16) or 1
        self.time_inc_bits = max(1, (self.time_res - 1).bit_length())
        gb.get_bits(1)          # marker
        if gb.get_bits(1):      # fixed_vop_rate
            gb.get_bits(self.time_inc_bits)
        gb.get_bits(1)          # marker
        self.vol_width = gb.get_bits(13)
        gb.get_bits(1)
        self.vol_height = gb.get_bits(13)
        gb.get_bits(1)
        gb.get_bits(1)          # interlaced
        gb.get_bits(1)          # obmc_disable
        # vol_sprite_usage: 1 bit for ver_id 1, 2 bits otherwise
        # (reference mpeg4videodec.c:1782)
        sprite = gb.get_bits(1 if ver_id == 1 else 2)
        self.sprite_usage = sprite
        if sprite == 1:
            raise AVError(INVALIDDATA, "static sprites not supported")
        if sprite == 2:          # GMC (reference :1790-1813)
            self.num_warp_points = gb.get_bits(6)
            if self.num_warp_points > 3:
                raise AVError(INVALIDDATA, "too many warping points")
            self.warp_accuracy = gb.get_bits(2)
            if gb.get_bits(1):   # sprite_brightness_change
                raise AVError(INVALIDDATA,
                              "sprite brightness change not supported")
        if gb.get_bits(1):      # not_8_bit
            raise AVError(INVALIDDATA, "only 8-bit supported")
        self.quant_type = gb.get_bits(1)
        if self.quant_type:
            # MPEG quant: default matrices + optional zigzag-coded
            # custom lists with last-value replication (reference
            # mpeg4videodec.c:1830)
            self.intra_mat = self._parse_qmat(gb, T.DEFAULT_INTRA_MATRIX)
            self.inter_mat = self._parse_qmat(gb, T.DEFAULT_INTER_MATRIX)
        self.quarter_sample = gb.get_bits(1) if ver_id != 1 else 0
        if not gb.get_bits(1):  # complexity_estimation_disable
            raise AVError(INVALIDDATA, "complexity estimation not supported")
        self.resync_marker = not gb.get_bits(1)  # resync_marker_disable
        self.data_partitioning = gb.get_bits(1)
        if self.data_partitioning:
            self.rvlc = gb.get_bits(1)
            if self.rvlc:
                raise AVError(INVALIDDATA, "reversible VLC not supported")
        if ver_id != 1:
            if gb.get_bits(1):  # newpred_enable
                raise AVError(INVALIDDATA, "newpred not supported")
            gb.get_bits(1)      # reduced_res_vop_enable
        if gb.get_bits(1):      # scalability
            raise AVError(INVALIDDATA, "scalability not supported")
        self.width = self.vol_width
        self.height = self.vol_height
        self.mb_w = (self.vol_width + 15) >> 4
        self.mb_h = (self.vol_height + 15) >> 4

    @staticmethod
    def _parse_qmat(gb, default):
        m = np.array(default, np.int32)          # raster order
        if gb.get_bits(1):
            zz = np.asarray(zigzag_scan())
            last = 0
            i = 0
            while i < 64:
                v = gb.get_bits(8)
                if v == 0:
                    break
                last = v
                m[zz[i]] = v
                i += 1
            if i < 64 and last:
                for j in range(i, 64):
                    m[zz[j]] = last
        return m

    # ------------------------------------------------------------------ #

    def _decode_vop(self, seg: bytes, pkt) -> List[Frame]:
        """reference: mpeg4videodec.c ff_mpeg4_decode_picture_header +
        decode loop. Anchors are held one AU for B reordering; B-VOPs
        are emitted immediately (display order)."""
        if self.mb_w == 0:
            raise AVError(INVALIDDATA, "VOP before VOL header")
        gb = GetBits(seg)
        pict_type = gb.get_bits(2)
        if pict_type == PICT_S and getattr(self, "sprite_usage", 0) != 2:
            raise AVError(INVALIDDATA, "S-VOP without GMC VOL")
        time_incr = 0
        while gb.get_bits(1):   # modulo_time_base
            time_incr += 1
        gb.get_bits(1)          # marker
        time_increment = gb.get_bits(self.time_inc_bits)
        gb.get_bits(1)          # marker
        # TRB/TRD bookkeeping for direct mode (reference
        # mpeg4videodec.c decode_vop_header time handling)
        if pict_type != PICT_B:
            self._last_time_base = self._time_base
            self._time_base += time_incr
            t = self._time_base * self.time_res + time_increment
            self._pp_time = t - self._last_nonb
            self._last_nonb = t
        else:
            t = (self._last_time_base + time_incr) * self.time_res + \
                time_increment
            self._pb_time = self._pp_time - (self._last_nonb - t)
            if self._pp_time <= 0 or self._pb_time <= 0 or \
                    self._pp_time <= self._pb_time:
                return []        # messed-up order (e.g. after seek)
        if not gb.get_bits(1):  # vop_coded
            return []
        rounding = 0
        if pict_type in (PICT_P, PICT_S):
            rounding = gb.get_bits(1)
        intra_dc_thr = gb.get_bits(3)
        gmc_params = None
        if pict_type == PICT_S:
            # sprite trajectory (reference decode_vop_header sprite
            # block between intra_dc_thr and vop_quant)
            traj = []
            for _ in range(self.num_warp_points):
                ln = T.sprite_traj_vlc().read(gb)
                x = gb.get_xbits(ln) if ln else 0
                gb.get_bits(1)
                ln = T.sprite_traj_vlc().read(gb)
                y = gb.get_xbits(ln) if ln else 0
                gb.get_bits(1)
                traj.append((x, y))
            off, dlt, shf, rp = compute_warp_params(
                traj, self.num_warp_points, self.warp_accuracy,
                self.vol_width, self.vol_height)
            gmc_params = GMCParams(off, dlt, shf, rp,
                                   self.warp_accuracy, rounding)
        qscale = gb.get_bits(5)
        fcode = bcode = 1
        if pict_type in (PICT_P, PICT_B, PICT_S):
            fcode = gb.get_bits(3)
        if pict_type == PICT_B:
            bcode = gb.get_bits(3)

        nmb = self.mb_w * self.mb_h
        mb = MBData(nmb)
        mb.qscale[:] = max(qscale, 1)
        mb.skipped = np.zeros(nmb, dtype=bool)
        mb.use4 = np.zeros(nmb, dtype=bool)
        mb.mv4f = np.zeros((nmb, 4, 2), dtype=np.int32)
        mb.mv4b = np.zeros((nmb, 4, 2), dtype=np.int32)
        # slice (video packet) loop: decode resync-to-resync, parse each
        # video packet header, reset predictors per packet (reference:
        # h263dec.c ff_h263_decode_frame decode_slice loop :589-608)
        self._amv_cache = {}
        pred = _VopPred(self.mb_w, self.mb_h)
        partitioned = getattr(self, "data_partitioning", 0) and \
            pict_type != PICT_B
        col_skip_b = self._col_skip if pict_type == PICT_B and \
            self._col_skip is not None else None
        idx = 0
        while idx < nmb:
            slice_start = idx
            try:
                if partitioned:
                    idx, qscale = self._decode_partitions(
                        gb, mb, pict_type, fcode, qscale, pred, idx,
                        gmc_params)
                elif pict_type == PICT_B:
                    idx, qscale = self._decode_mbs_b(
                        gb, mb, fcode, bcode, qscale, idx)
                else:
                    idx, qscale = self._decode_mbs(
                        gb, mb, pict_type, fcode, intra_dc_thr, qscale,
                        gmc_params, pred, idx)
            except AVError as e:
                log.warning(self, "MB decode error at %d, concealing: "
                            "%s", idx, e)
                idx = nmb   # unless a resync marker rescues us below
                try:
                    mb_num, q2 = self._resync_scan(gb, pict_type,
                                                   fcode, bcode)
                    if mb_num > slice_start:
                        idx = mb_num
                        if q2:
                            qscale = q2
                        mb.ok[slice_start:idx] = False
                        if col_skip_b is not None:
                            while idx < nmb and col_skip_b[idx]:
                                mb.use_fwd[idx] = True
                                mb.ok[idx] = True
                                idx += 1
                        pred.resync(idx % self.mb_w, idx // self.mb_w)
                        continue
                except AVError:
                    pass
                mb.ok[slice_start:] = False
                break
            # B-VOPs: colocated-skip MBs consume no bits and may sit
            # between the slice end and the next packet's mb_num
            # (reference vph :425 skips them when locating the start)
            if col_skip_b is not None:
                while idx < nmb and col_skip_b[idx]:
                    mb.use_fwd[idx] = True
                    mb.ok[idx] = True
                    idx += 1
            if idx >= nmb:
                break
            # mid-frame: a resync marker follows — parse the header
            try:
                mb_num, q2 = self._resync_scan(gb, pict_type, fcode,
                                               bcode)
            except AVError as e:
                log.warning(self, "bad video packet header: %s", e)
                mb.ok[idx:] = False
                break
            if col_skip_b is not None:
                while mb_num < nmb and col_skip_b[mb_num]:
                    mb_num += 1
            if mb_num != idx:
                mb.ok[min(mb_num, idx):max(mb_num, idx)] = False
                idx = mb_num
            if q2:
                qscale = q2
            if idx >= nmb:
                break
            pred.resync(idx % self.mb_w, idx // self.mb_w)
        if not mb.ok.all():
            n = conceal_missing(mb, self.mb_w, self.mb_h,
                                self._refs is not None)
            if n > 0:
                log.warning(self, "concealed %d missing MBs", n)
                self._concealed_inter = True

        kind = "mpeg4mq" if self.quant_type else "h263"
        any4 = bool(np.any(mb.use4))
        if self.quant_type:
            zz = np.asarray(zigzag_scan())
            qi = self.intra_mat[zz].astype(np.int32)
            qp_ = self.inter_mat[zz].astype(np.int32)
        else:
            qi = qp_ = self._dummy_q
        inter = pict_type != PICT_I or \
            getattr(self, "_concealed_inter", False)
        self._concealed_inter = False
        recon_jit = hwdevice.program_factory(mpegvideo.recon, self.device)
        fn = recon_jit(self.mb_w, self.mb_h, kind, False,
                       inter, rounding,
                       qpel=bool(self.quarter_sample), any_4mv=any4)
        zero = mpegvideo.zero_pad_refs(self.mb_w, self.mb_h,
                                       device=self.device)
        if pict_type == PICT_B:
            r0 = self._refs_prev or zero      # forward = past anchor
            r1 = self._refs or zero           # backward = future anchor
        elif pict_type == PICT_S:
            # GMC: the whole-frame warp is computed once; mcsel MBs
            # read it as a zero-motion "backward" reference
            r0 = self._refs or zero
            r1 = warp_refs(r0, gmc_params, self.mb_w, self.mb_h)
        else:
            r0 = self._refs or zero
            r1 = zero
        dkw = {"use4": mb.use4, "mv4f": mb.mv4f,
               "mv4b": mb.mv4b} if any4 else {}
        planes, padded = fn(mb.coeffs, mb.qscale, mb.intra, mb.use_fwd,
                            mb.use_bwd, mb.mv_fwd, mb.mv_bwd,
                            qi, qp_, *r0, *r1, **dkw)
        f = Frame(width=self.vol_width, height=self.vol_height,
                  format="yuv420p")
        cw, ch = (self.vol_width + 1) // 2, (self.vol_height + 1) // 2
        f.planes = [planes[0][:self.vol_height, :self.vol_width],
                    planes[1][:ch, :cw], planes[2][:ch, :cw]]
        f.pict_type = (PictureType.I if pict_type == PICT_I else
                       PictureType.B if pict_type == PICT_B else
                       PictureType.P)
        f.key_frame = pict_type == PICT_I
        if pict_type == PICT_B:
            f.pts = pkt.pts
            return [f]
        # anchor: save refs/colocated motion, emit the held anchor
        self._refs_prev = self._refs
        self._refs = padded
        if pict_type in (PICT_P, PICT_S):
            self._col_mv = mb.mv_fwd.copy()
            self._col_skip = mb.skipped.copy()
            # per-block colocated motion for direct (4MV P -> 8x8
            # direct, reference ff_mpeg4_set_direct_mv IS_8X8 branch)
            cm4 = np.repeat(mb.mv_fwd[:, None, :], 4, axis=1)
            cm4[mb.use4] = mb.mv4f[mb.use4]
            self._col_mv4 = cm4
            self._col_is4 = mb.use4.copy()
        else:
            self._col_mv = np.zeros((nmb, 2), dtype=np.int32)
            self._col_skip = np.zeros(nmb, dtype=bool)
            self._col_mv4 = np.zeros((nmb, 4, 2), dtype=np.int32)
            self._col_is4 = np.zeros(nmb, dtype=bool)
        out = []
        if self._pending is not None:
            pf, ppts = self._pending
            pf.pts = ppts
            out.append(pf)
        self._pending = (f, pkt.pts)
        return out

    @staticmethod
    def _tdiv(a: int, b: int) -> int:
        """C integer division (truncation toward zero), b > 0."""
        q = abs(a) // b
        return q if a >= 0 else -q

    def _decode_mbs_b(self, gb, mb: MBData, fcode, bcode, qscale,
                      start_idx=0):
        """B-VOP macroblock layer (reference: mpeg4videodec.c
        mpeg4_decode_mb B branch; direct mode per
        ff_mpeg4_set_one_direct_mv with TRB/TRD scaling).  Returns
        (next_idx, qscale) like _decode_mbs."""
        mw, mh = self.mb_w, self.mb_h
        tp = self._pp_time & 0xFFFF
        tb = self._pb_time & 0xFFFF
        col_mv = self._col_mv if self._col_mv is not None else \
            np.zeros((mw * mh, 2), dtype=np.int32)
        col_skip = self._col_skip if self._col_skip is not None else \
            np.zeros(mw * mh, dtype=bool)
        col_mv4 = getattr(self, "_col_mv4", None)
        if col_mv4 is None:
            col_mv4 = np.zeros((mw * mh, 4, 2), dtype=np.int32)
        col_is4 = getattr(self, "_col_is4", None)
        if col_is4 is None:
            col_is4 = np.zeros(mw * mh, dtype=bool)

        def wrap(v, fc):
            rng = 32 << (fc - 1)
            if v < -rng:
                v += 2 * rng
            elif v >= rng:
                v -= 2 * rng
            return v

        nmb = mw * mh
        idx = start_idx
        last_mv = [[0, 0], [0, 0]]       # per direction
        last_row = start_idx // mw
        while idx < nmb:
            mb_y, mb_x = divmod(idx, mw)
            if mb_y != last_row:
                last_mv = [[0, 0], [0, 0]]
                last_row = mb_y
            if True:
                if col_skip[idx]:
                    # colocated next-P MB was skipped: skip here too
                    mb.use_fwd[idx] = True
                    mb.mv_fwd[idx] = 0
                    mb.ok[idx] = True
                    idx += 1
                    continue
                modb1 = gb.get_bits(1)
                direct = False
                cbp = 0
                if modb1:
                    direct = True
                else:
                    modb2 = gb.get_bits(1)
                    # mb_type: unary '1'=direct '01'=bi '001'=bwd
                    # '0001'=fwd (ff_mb_type_b_tab)
                    zeros = 0
                    while not gb.get_bits(1):
                        zeros += 1
                        if zeros > 3:
                            raise AVError(INVALIDDATA, "bad B mb_type")
                    mbt = zeros          # 0=direct 1=bi 2=bwd 3=fwd
                    direct = mbt == 0
                    cbp = 0 if modb2 else gb.get_bits(6)
                    if not direct and cbp:
                        if gb.get_bits(1):       # dquant: +-2
                            dq = gb.get_bits(1) * 4 - 2
                            qscale = max(1, min(31, qscale + dq))
                    mb.qscale[idx] = qscale
                    if not direct:
                        if mbt in (1, 3):        # forward
                            mx = self._decode_mv(gb, fcode)
                            my = self._decode_mv(gb, fcode)
                            vx = wrap(last_mv[0][0] + mx, fcode)
                            vy = wrap(last_mv[0][1] + my, fcode)
                            last_mv[0] = [vx, vy]
                            mb.use_fwd[idx] = True
                            mb.mv_fwd[idx] = (vx, vy)
                        if mbt in (1, 2):        # backward
                            mx = self._decode_mv(gb, bcode)
                            my = self._decode_mv(gb, bcode)
                            vx = wrap(last_mv[1][0] + mx, bcode)
                            vy = wrap(last_mv[1][1] + my, bcode)
                            last_mv[1] = [vx, vy]
                            mb.use_bwd[idx] = True
                            mb.mv_bwd[idx] = (vx, vy)
                if direct:
                    if modb1:
                        dmx = dmy = 0
                    else:
                        dmx = self._decode_mv(gb, 1)
                        dmy = self._decode_mv(gb, 1)

                    def dscale(cx, cy):
                        fx = self._tdiv(cx * tb, tp) + dmx
                        fy = self._tdiv(cy * tb, tp) + dmy
                        bx = (fx - cx) if dmx else self._tdiv(
                            cx * (tb - tp), tp)
                        by = (fy - cy) if dmy else self._tdiv(
                            cy * (tb - tp), tp)
                        return (fx, fy), (bx, by)

                    if self.quarter_sample or col_is4[idx]:
                        # MV_TYPE_8X8 direct: per-block colocated MVs
                        # (also taken for EQUAL vectors in qpel mode —
                        # 8-wide qpel reflection + 4MV chroma rounding)
                        mb.use4[idx] = True
                        for k in range(4):
                            f, b_ = dscale(int(col_mv4[idx, k, 0]),
                                           int(col_mv4[idx, k, 1]))
                            mb.mv4f[idx, k] = f
                            mb.mv4b[idx, k] = b_
                        mb.mv_fwd[idx] = mb.mv4f[idx, 0]
                        mb.mv_bwd[idx] = mb.mv4b[idx, 0]
                    else:
                        f, b_ = dscale(int(col_mv[idx][0]),
                                       int(col_mv[idx][1]))
                        mb.mv_fwd[idx] = f
                        mb.mv_bwd[idx] = b_
                    mb.use_fwd[idx] = True
                    mb.use_bwd[idx] = True
                    mb.qscale[idx] = qscale
                for b in range(6):
                    if cbp & (0x20 >> b):
                        self._decode_rl_block(gb, mb.coeffs[idx, b], 0,
                                              False)
                mb.ok[idx] = True
                idx += 1
                if idx < nmb and self._is_resync(gb, PICT_B, fcode,
                                                 bcode, False):
                    return idx, qscale
        return idx, qscale

    # ------------------------------------------------------------------ #

    def _decode_partitions(self, gb, mb: MBData, pict_type, fcode,
                           qscale, pred: "_VopPred", start_idx,
                           gmc_params):
        """Data-partitioned video packet (reference: mpeg4videodec.c:886
        ff_mpeg4_decode_partitions — partition A (mcbpc+DC / mcbpc+MV),
        DC/MOTION marker, partition B (ac_pred+cbpy / cbpy+dquant+DC),
        then the texture partition per mpeg4_decode_partitioned_mb).
        Returns (next_idx, qscale)."""
        mw = self.mb_w
        nmb = mw * self.mb_h
        grid_pred, grid_put = pred.grid_pred, pred.grid_put
        wrap_mv = self._wrap_mv
        quant_tab = (-1, -2, 1, 2)

        kind = {}       # idx -> 'i' | 'p' | 'skip'
        cbp_t = {}      # idx -> partial cbp (bit 3 = dquant pending)
        dcs = {}        # idx -> [(level, dir)] * 6 (I-VOP: from part A)
        mcsel_t = {}
        acp_t = {}
        qs = qscale
        idx = start_idx

        # ---- partition A --------------------------------------------- #
        while idx < nmb:
            mb_y, mb_x = divmod(idx, mw)
            if pict_type == PICT_I:
                hit = False
                while True:
                    if gb.show_bits(19) == DC_MARKER:
                        hit = True
                        break
                    v = T.intra_mcbpc_vlc().read(gb)
                    if v != 8:          # not stuffing
                        break
                if hit:
                    break
                cbp_t[idx] = v & 3
                kind[idx] = 'i'
                mb.intra[idx] = True
                if v >= 4:
                    qs = max(1, min(31, qs + quant_tab[gb.get_bits(2)]))
                mb.qscale[idx] = qs
                d6 = []
                for b in range(6):
                    d6.append(self._decode_dc(gb, b, mb_x, mb_y, qs,
                                              pred))
                dcs[idx] = d6
                idx += 1
            else:                        # P / S
                hit = False
                while True:
                    bits = gb.show_bits(17)
                    if bits == MOTION_MARKER:
                        hit = True
                        break
                    gb.skip_bits(1)
                    if bits & 0x10000:   # not_coded: skip MB
                        if pict_type == PICT_S and \
                                getattr(self, "sprite_usage", 0) == 2:
                            mx, my = self._amv(gmc_params, fcode,
                                               mb_x, mb_y)
                            kind[idx] = 'gmcskip'
                            mb.use_bwd[idx] = True
                            mb.mv_fwd[idx] = (mx, my)
                        else:
                            mx = my = 0
                            kind[idx] = 'skip'
                            mb.use_fwd[idx] = True
                            mb.skipped[idx] = True
                        for k in range(4):
                            grid_put(mb_x, mb_y, k, mx, my)
                        break
                    v = T.inter_mcbpc_vlc().read(gb)
                    if (v >> 2) == 5:    # stuffing: try again
                        continue
                    # group 6 = INTER4V+Q (mpeg4videodec.c:1327 layout)
                    cbp_t[idx] = (v & 3) | \
                        (8 if (v >> 2) in (T.MBT_INTERQ, T.MBT_INTRAQ, 6)
                         else 0)
                    if (v >> 2) in (T.MBT_INTRA, T.MBT_INTRAQ):
                        kind[idx] = 'i'
                        mb.intra[idx] = True
                        for k in range(4):
                            grid_put(mb_x, mb_y, k, 0, 0)
                    else:
                        kind[idx] = 'p'
                        mcsel = 0
                        four_mv = (v >> 2) in (T.MBT_INTER4V, 6)
                        if pict_type == PICT_S and not four_mv and \
                                getattr(self, "sprite_usage", 0) == 2:
                            mcsel = gb.get_bits(1)
                        mcsel_t[idx] = mcsel
                        if not four_mv:
                            if mcsel:
                                mx, my = self._amv(gmc_params, fcode,
                                                   mb_x, mb_y)
                                kind[idx] = 'gmc'
                                mb.use_bwd[idx] = True
                                mb.mv_fwd[idx] = (mx, my)
                            else:
                                px, py = grid_pred(mb_x, mb_y, 0)
                                mx = wrap_mv(
                                    px + self._decode_mv(gb, fcode),
                                    fcode)
                                my = wrap_mv(
                                    py + self._decode_mv(gb, fcode),
                                    fcode)
                                mb.use_fwd[idx] = True
                                mb.mv_fwd[idx] = (mx, my)
                            for k in range(4):
                                grid_put(mb_x, mb_y, k, mx, my)
                        else:
                            mb.use_fwd[idx] = True
                            mb.use4[idx] = True
                            for k in range(4):
                                px, py = grid_pred(mb_x, mb_y, k)
                                vx = wrap_mv(
                                    px + self._decode_mv(gb, fcode),
                                    fcode)
                                vy = wrap_mv(
                                    py + self._decode_mv(gb, fcode),
                                    fcode)
                                grid_put(mb_x, mb_y, k, vx, vy)
                                mb.mv4f[idx, k] = (vx, vy)
                            mb.mv_fwd[idx] = mb.mv4f[idx, 0]
                    break
                if hit:
                    break
                idx += 1

        mb_count = idx - start_idx
        if mb_count <= 0:
            raise AVError(INVALIDDATA, "empty partition")

        # ---- inter-partition marker ---------------------------------- #
        if pict_type == PICT_I:
            while gb.show_bits(9) == 1:
                gb.skip_bits(9)
            if gb.get_bits(19) != DC_MARKER:
                raise AVError(INVALIDDATA, "DC marker missing")
        else:
            while gb.show_bits(10) == 1:
                gb.skip_bits(10)
            if gb.get_bits(17) != MOTION_MARKER:
                raise AVError(INVALIDDATA, "motion marker missing")

        # ---- partition B --------------------------------------------- #
        for i in range(start_idx, idx):
            mb_y, mb_x = divmod(i, mw)
            k = kind[i]
            if pict_type == PICT_I:
                acp_t[i] = gb.get_bits(1)
                cbpy = T.cbpy_vlc().read(gb)
                cbp_t[i] |= cbpy << 2
            elif k == 'i':
                acp_t[i] = gb.get_bits(1)
                cbpy = T.cbpy_vlc().read(gb)
                if cbp_t[i] & 8:
                    qs = max(1, min(31,
                                    qs + quant_tab[gb.get_bits(2)]))
                mb.qscale[i] = qs
                d6 = []
                for b in range(6):
                    d6.append(self._decode_dc(gb, b, mb_x, mb_y, qs,
                                              pred))
                dcs[i] = d6
                cbp_t[i] = (cbp_t[i] & 3) | (cbpy << 2)
            elif k in ('skip', 'gmcskip'):
                mb.qscale[i] = qs
                cbp_t[i] = 0
            else:
                cbpy = T.cbpy_vlc().read(gb)
                if cbp_t[i] & 8:
                    qs = max(1, min(31,
                                    qs + quant_tab[gb.get_bits(2)]))
                mb.qscale[i] = qs
                cbp_t[i] = (cbp_t[i] & 3) | ((cbpy ^ 0xF) << 2)

        # ---- texture partition --------------------------------------- #
        for i in range(start_idx, idx):
            mb_y, mb_x = divmod(i, mw)
            k = kind[i]
            if k in ('skip', 'gmcskip'):
                mb.ok[i] = True
                continue
            cbp = cbp_t[i]
            q = int(mb.qscale[i])
            for b in range(6):
                coded = bool(cbp & (0x20 >> b))
                if k == 'i':
                    lvl, ddir = dcs[i][b]
                    self._decode_intra_block(
                        gb, mb.coeffs[i, b], b, mb_x, mb_y, q, pred,
                        coded, acp_t[i], mb.qscale, dc_lvl=lvl,
                        dc_dir=ddir)
                elif coded:
                    self._decode_rl_block(gb, mb.coeffs[i, b], 0, False)
            mb.ok[i] = True
        return idx, qs

    def _amv(self, gmc_params, fcode, mb_x, mb_y):
        """GMC average MV (get_amv), cached — constant across the
        frame when real_sprite_warping_points == 1."""
        cache = self._amv_cache
        key = (0, 0) if gmc_params.real_points == 1 else (mb_x, mb_y)
        if key not in cache:
            cache[key] = (
                get_amv(gmc_params, self.quarter_sample, fcode,
                        key[0], key[1], 0),
                get_amv(gmc_params, self.quarter_sample, fcode,
                        key[0], key[1], 1))
        return cache[key]

    def _is_resync(self, gb, pict_type, fcode, bcode, partitioned):
        """reference: mpeg4videodec.c:124 mpeg4_is_resync — true if the
        next bits are a resync marker or the stream end.  Skips the
        stuffing-MB patterns exactly like the reference (consuming!)."""
        bits_count = gb.pos
        v = gb.show_bits(16)
        av_pt = (1, 2, 3, 4)[pict_type]      # AV_PICTURE_TYPE numbering
        while v <= 0xFF:
            if pict_type == PICT_B or (v >> (8 - av_pt)) != 1 or \
                    partitioned:
                break
            gb.skip_bits(8 + av_pt)
            bits_count += 8 + av_pt
            v = gb.show_bits(16)
        if bits_count + 8 >= gb.size_bits:
            v >>= 8
            v |= 0x7F >> (7 - (bits_count & 7))
            return v == 0x7F
        if v == RESYNC_PREFIX[bits_count & 7]:
            save = gb.pos
            gb.skip_bits(1)
            gb.align()
            length = 0
            while length < 32 and gb.bits_left() > 0 and \
                    not gb.get_bits(1):
                length += 1
            gb.pos = save
            if length >= _vpp_prefix_len(pict_type, fcode, bcode):
                return True
        return False

    def _read_video_packet_header(self, gb, pict_type, fcode, bcode):
        """reference: mpeg4videodec.c:391
        ff_mpeg4_decode_video_packet_header (rectangular shape).
        -> (mb_num, qscale or 0)."""
        nmb = self.mb_w * self.mb_h
        mb_num_bits = max(1, (nmb - 1).bit_length())
        if gb.bits_left() < 20:
            raise AVError(INVALIDDATA, "no room for video packet")
        length = 0
        while length < 32 and not gb.get_bits(1):
            length += 1
        if length != _vpp_prefix_len(pict_type, fcode, bcode):
            raise AVError(INVALIDDATA, "resync marker does not match "
                                       "f_code")
        mb_num = gb.get_bits(mb_num_bits)
        if mb_num >= nmb:
            raise AVError(INVALIDDATA, "illegal mb_num in video packet")
        qscale = gb.get_bits(5)           # quant_precision
        if gb.get_bits(1):                # header_extension (HEC)
            while gb.get_bits(1):         # modulo_time_base
                pass
            gb.get_bits(1)                # marker
            gb.skip_bits(self.time_inc_bits)
            gb.get_bits(1)                # marker
            gb.skip_bits(2)               # vop_coding_type
            gb.skip_bits(3)               # intra_dc_vlc_threshold
            if pict_type != PICT_I:
                gb.get_bits(3)            # fcode_forward
            if pict_type == PICT_B:
                gb.get_bits(3)            # fcode_backward
        return mb_num, qscale

    def _resync_scan(self, gb, pict_type, fcode, bcode):
        """reference: ituh263dec.c:233 ff_h263_resync — find and parse
        the next video packet header.  -> (mb_num, qscale)."""
        gb.skip_bits(1)
        gb.align()
        if gb.show_bits(16) == 0:
            save = gb.pos
            try:
                return self._read_video_packet_header(gb, pict_type,
                                                      fcode, bcode)
            except AVError:
                gb.pos = save
        while gb.bits_left() > 16 + 1 + 5 + 5:
            if gb.show_bits(16) == 0:
                save = gb.pos
                try:
                    return self._read_video_packet_header(
                        gb, pict_type, fcode, bcode)
                except AVError:
                    gb.pos = save
            gb.skip_bits(8)
        raise AVError(INVALIDDATA, "no further resync marker")

    @staticmethod
    def _wrap_mv(v, fc):
        rng = 32 << (fc - 1)
        if v < -rng:
            v += 2 * rng
        elif v >= rng:
            v -= 2 * rng
        return v

    def _decode_mbs(self, gb, mb: MBData, pict_type, fcode, intra_dc_thr,
                    qscale, gmc_params, pred: "_VopPred", start_idx):
        """Decode MBs of one video packet from start_idx; returns
        (next_idx, qscale) — next_idx == nmb when the VOP is complete
        (reference: h263dec.c decode_slice + mpeg4_decode_mb per-MB end
        check)."""
        mw, mh = self.mb_w, self.mb_h
        nmb = mw * mh
        grid_pred, grid_put = pred.grid_pred, pred.grid_put
        wrap_mv = self._wrap_mv

        def amv(mb_x, mb_y):
            return self._amv(gmc_params, fcode, mb_x, mb_y)

        idx = start_idx
        while idx < nmb:
            mb_y, mb_x = divmod(idx, mw)
            if True:
                four_mv = False
                mcsel = 0
                if pict_type in (PICT_P, PICT_S):
                    if gb.get_bits(1):      # not_coded: skip MB
                        if pict_type == PICT_S:
                            # GMC skip: prediction from the warp, amv
                            # stored for neighbors/colocated (reference
                            # mpeg4videodec.c:1297-1306, mb_skipped=0)
                            vx, vy = amv(mb_x, mb_y)
                            mb.use_bwd[idx] = True
                            mb.mv_fwd[idx] = (vx, vy)
                            for k in range(4):
                                grid_put(mb_x, mb_y, k, vx, vy)
                        else:
                            mb.use_fwd[idx] = True
                            mb.mv_fwd[idx] = 0
                            mb.skipped[idx] = True
                        mb.ok[idx] = True
                        idx += 1
                        if idx < nmb and self._is_resync(
                                gb, pict_type, fcode, 1, False):
                            return idx, qscale
                        continue
                    v = T.inter_mcbpc_vlc().read(gb)
                    group, cbpc = v >> 2, v & 3
                    if group == 5:          # stuffing: retry same MB
                        continue
                    # group 6 = INTER4V+Q (reference: 28-entry
                    # inter MCBPC where bit4=4MV and bit3=dquant,
                    # mpeg4videodec.c:1327)
                    four_mv = group in (T.MBT_INTER4V, 6)
                    is_intra = group in (T.MBT_INTRA, T.MBT_INTRAQ)
                    has_q = group in (T.MBT_INTERQ, T.MBT_INTRAQ, 6)
                else:
                    v = T.intra_mcbpc_vlc().read(gb)
                    if v == 8:
                        continue            # stuffing: retry same MB
                    is_intra = True
                    has_q = v >= 4
                    cbpc = v & 3

                ac_pred = 0
                if is_intra:
                    ac_pred = gb.get_bits(1)
                if pict_type == PICT_S and not is_intra and not four_mv:
                    mcsel = gb.get_bits(1)  # reference :1332-1336
                cbpy_code = T.cbpy_vlc().read(gb)
                cbpy = cbpy_code if is_intra else 15 - cbpy_code
                if has_q:
                    dq = gb.get_bits(2)
                    qscale = max(1, min(31, qscale + (-1, -2, 1, 2)[dq]))
                mb.qscale[idx] = qscale

                if is_intra:
                    mb.intra[idx] = True
                elif four_mv:               # INTER4V (8x8 vectors)
                    mb.use_fwd[idx] = True
                    mb.use4[idx] = True
                    for k in range(4):
                        px, py = grid_pred(mb_x, mb_y, k)
                        vx = wrap_mv(px + self._decode_mv(gb, fcode),
                                     fcode)
                        vy = wrap_mv(py + self._decode_mv(gb, fcode),
                                     fcode)
                        grid_put(mb_x, mb_y, k, vx, vy)
                        mb.mv4f[idx, k] = (vx, vy)
                    mb.mv_fwd[idx] = mb.mv4f[idx, 0]
                elif mcsel:
                    vx, vy = amv(mb_x, mb_y)
                    mb.use_bwd[idx] = True   # GMC warp as zero-mv ref1
                    mb.mv_fwd[idx] = (vx, vy)
                    for k in range(4):
                        grid_put(mb_x, mb_y, k, vx, vy)
                else:
                    px, py = grid_pred(mb_x, mb_y, 0)
                    vx = wrap_mv(px + self._decode_mv(gb, fcode), fcode)
                    vy = wrap_mv(py + self._decode_mv(gb, fcode), fcode)
                    mb.use_fwd[idx] = True
                    mb.mv_fwd[idx] = (vx, vy)
                    for k in range(4):
                        grid_put(mb_x, mb_y, k, vx, vy)

                cbp = (cbpy << 2) | cbpc
                for b in range(6):
                    coded = bool(cbp & (0x20 >> b))
                    if is_intra:
                        self._decode_intra_block(
                            gb, mb.coeffs[idx, b], b, mb_x, mb_y,
                            qscale, pred, coded, ac_pred, mb.qscale)
                    elif coded:
                        self._decode_rl_block(gb, mb.coeffs[idx, b], 0,
                                              False)
                mb.ok[idx] = True
                idx += 1
                if idx < nmb and self._is_resync(gb, pict_type, fcode,
                                                 1, False):
                    return idx, qscale
        return idx, qscale

    def _decode_mv(self, gb, fcode: int) -> int:
        code = T.mv_vlc().read(gb)
        if code == 0:
            return 0
        sign = 0
        shift = fcode - 1
        if fcode == 1:
            sign = gb.get_bits(1)
            return -code if sign else code
        sign = gb.get_bits(1)
        residual = gb.get_bits(shift) if shift else 0
        val = ((code - 1) << shift) + residual + 1
        return -val if sign else val

    def _decode_dc(self, gb, b, mb_x, mb_y, qscale, pred: "_VopPred"):
        """DC diff decode + gradient prediction (mpeg4_decode_dc).
        -> (level, dc_dir); stores the dequantized DC in the grid."""
        luma = b < 4
        dcs = mpeg4_dc_scaler(qscale, luma)
        vlc = T.dc_lum_vlc() if luma else T.dc_chrom_vlc()
        size = vlc.read(gb)
        diff = 0
        if size:
            diff = gb.get_bits(size)
            if diff < (1 << (size - 1)):
                diff -= (1 << size) - 1
            if size > 8:
                gb.get_bits(1)  # marker
        p, store, dc_dir = pred.dc_ctx(b, mb_x, mb_y)
        pred_lvl = (p + dcs // 2) // dcs
        lvl = int(pred_lvl) + diff
        store(lvl * dcs)
        return lvl, dc_dir

    def _decode_intra_block(self, gb, out, b, mb_x, mb_y, qscale,
                            pred: "_VopPred", coded, ac_pred=0,
                            qs_tab=None, dc_lvl=None, dc_dir=None):
        """Intra block: DC (unless already decoded in partition A —
        dc_lvl/dc_dir given) + AC with optional prediction."""
        acv = pred.acv
        if dc_lvl is None:
            lvl, dc_dir = self._decode_dc(gb, b, mb_x, mb_y, qscale,
                                          pred)
        else:
            lvl = dc_lvl
        out[0] = lvl
        if ac_pred:
            # AC prediction (ISO 14496-2 §7.4.3.3; reference
            # ff_mpeg4_pred_ac mpeg4videodec.c:68): predicted blocks use
            # the alternate scan matching the DC direction
            scan = np.asarray(alternate_scan() if dc_dir == 0
                              else alternate_horizontal_scan())
            tmp = np.zeros(64, np.int64)
            if coded:
                self._decode_rl_block(gb, tmp, 1, True)
            raster = np.zeros(64, np.int64)
            raster[scan] = tmp
            raster[0] = lvl
            _pred_ac(self, raster, b, mb_x, mb_y, dc_dir, acv,
                     qs_tab, qscale, self.mb_w)
            _store_ac(raster, b, mb_x, mb_y, acv)
            out[np.arange(64)] = raster[np.asarray(zigzag_scan())]
            out[0] = lvl
            return
        if coded:
            self._decode_rl_block(gb, out, 1, True)
        if acv is not None:
            raster = np.zeros(64, np.int64)
            raster[np.asarray(zigzag_scan())] = out
            _store_ac(raster, b, mb_x, mb_y, acv)

    def _decode_rl_block(self, gb, out, start, intra):
        """3D RL decode incl. ESC1/2/3 (reference: mpeg4videodec.c
        mpeg4_decode_block)."""
        vlc = T.rl_vlc(intra)
        tuples = T.rl_decode_tuple(intra)
        lmax = T.rl_max_level(intra)
        rmax = T.rl_max_run(intra)
        k = start
        while True:
            v = vlc.read(gb)
            if v == T.ESC_INDEX:
                mode = 0
                if gb.get_bits(1):
                    mode = 2 if gb.get_bits(1) else 1
                if mode == 2:   # ESC3: fixed length
                    last = gb.get_bits(1)
                    run = gb.get_bits(6)
                    gb.get_bits(1)
                    level = gb.get_sbits(12)
                    gb.get_bits(1)
                else:
                    v2 = vlc.read(gb)
                    if v2 == T.ESC_INDEX:
                        raise AVError(INVALIDDATA, "double escape")
                    last, run, level = tuples[v2]
                    if gb.get_bits(1):
                        level = -level
                    if mode == 0:     # ESC1: level offset by LMAX
                        level += np.sign(level) * lmax.get((last, run), 0)
                    else:             # ESC2: run offset by RMAX+1
                        run += rmax.get((last, abs(level)), 0) + 1
            else:
                last, run, level = tuples[v]
                if gb.get_bits(1):
                    level = -level
            k += run
            if k > 63:
                raise AVError(INVALIDDATA, "AC index overflow")
            out[k] = level
            k += 1
            if last:
                break


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
