"""MPEG-1/2 video decoder (reference: libavcodec/mpeg12dec.c:
mpeg_decode_frame :2516 -> decode_chunks :2250 -> mpeg_decode_slice :1642,
per-MB mpeg_decode_mb :659 + ff_mpv_decode_mb path mpegvideo.c:1700).

Host: start-code walk, headers, per-slice entropy decode producing
whole-frame tensors (native/mpeg12_slice.c, with the Python MB loop
`_decode_slice_py` as its twin); device: one dequant+IDCT+MC+add program
per frame geometry (the port's `codecs/mpegvideo.py` modules on the
decoder's torch device, kernel K2 for the IDCT).

This is the JAX package's host decoder, copied (libav_tpu/codecs/mpeg12/
dec.py): start codes, headers, slice entropy, concealment, the DPB, field
pairing, the output crop and reordering are its code. What differs: the
places that reach a device program, `_reconstruct` (frame pictures),
`_reconstruct_field` (field pictures), `_finish_field` (the weave of a
field pair) and `_zero_refs`; and `_decode_slice`, which runs the native
slice decoder where the library is built, the copied MB loop
(`_decode_slice_py`) being its twin. The numpy inputs go to the device
synchronously (hwdevice.state_from_numpy) on the thread that decodes; on
the card the two recon programs then replay from CUDA graphs
(`mpegvideo.recon_graphed`, `recon_field_graphed`).

Supported: MPEG-1 I/P/B CPB; MPEG-2 main profile frame pictures
(progressive + interlaced tools: field MC in frame pictures with per-
field vectors/selects and field DCT, intra_dc_precision, q_scale_type,
intra_vlc_format, alternate_scan, both dequant paths with mismatch
control); MPEG-2 FIELD PICTURES (picture_structure top/bottom) with
whole-field MC, 16x8 MC and dual prime, incl. the second-field
most-recent-reference-fields rule (13818-2 7.6.2.1); dual prime in
frame pictures. Not yet: B field pictures are decoded but untested
(no conformance source), concealment for mpeg12 is fail-safe only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from libav_tpu_torch.avutil import hwdevice, log, timer
from libav_tpu_torch.avutil.error import AVError, EAGAIN, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs import mpegvideo
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpeg12 import tables as T
from libav_tpu_torch.native import mpeg12_slice
from libav_tpu_torch.ops.quant import zigzag_scan, alternate_scan

# picture_coding_type
PICT_I, PICT_P, PICT_B, PICT_D = 1, 2, 3, 4


@dataclass
class SeqContext:
    width: int = 0
    height: int = 0
    mb_width: int = 0
    mb_height: int = 0
    frame_rate: Rational = field(default_factory=lambda: Rational(25, 1))
    intra_matrix: np.ndarray = None      # raster order
    inter_matrix: np.ndarray = None
    mpeg2: bool = False
    progressive_sequence: bool = True
    chroma_format: int = 1               # 1=420


@dataclass
class PicContext:
    pict_type: int = PICT_I
    temporal_ref: int = 0
    full_pel: Tuple[int, int] = (0, 0)
    f_code: Tuple[Tuple[int, int], Tuple[int, int]] = ((15, 15), (15, 15))
    intra_dc_precision: int = 0
    picture_structure: int = 3           # 3 = frame
    frame_pred_frame_dct: int = 1
    concealment_mvs: int = 0
    q_scale_type: int = 0
    intra_vlc_format: int = 0
    alternate_scan: int = 0
    top_field_first: int = 0
    progressive_frame: int = 1


class MBData:
    """Per-frame tensor accumulation (the device-side program inputs)."""

    def __init__(self, nmb: int):
        self.coeffs = np.zeros((nmb, 6, 64), dtype=np.int16)
        self.qscale = np.ones(nmb, dtype=np.int32)
        self.intra = np.zeros(nmb, dtype=bool)
        self.use_fwd = np.zeros(nmb, dtype=bool)
        self.use_bwd = np.zeros(nmb, dtype=bool)
        self.mv_fwd = np.zeros((nmb, 2), dtype=np.int32)
        self.mv_bwd = np.zeros((nmb, 2), dtype=np.int32)
        self.coded = np.zeros(nmb, dtype=bool)
        # per-MB entropy-decode success, for error concealment (er.py)
        self.ok = np.zeros(nmb, dtype=bool)
        # MPEG-2 frame-picture interlace tools
        self.field_mc = np.zeros(nmb, dtype=bool)
        self.dct_field = np.zeros(nmb, dtype=bool)
        self.mv_fwd2 = np.zeros((nmb, 2, 2), dtype=np.int32)
        self.mv_bwd2 = np.zeros((nmb, 2, 2), dtype=np.int32)
        self.sel_fwd = np.zeros((nmb, 2), dtype=np.int32)
        self.sel_bwd = np.zeros((nmb, 2), dtype=np.int32)
        # dual prime (P only): averaged same/opposite-parity predictions
        self.dp = np.zeros(nmb, dtype=bool)
        self.mv_dp2 = np.zeros((nmb, 2, 2), dtype=np.int32)
        self.sel_dp = np.zeros((nmb, 2), dtype=np.int32)


def find_start_codes(data: bytes) -> List[Tuple[int, int]]:
    """[(offset_of_code_byte, code)] for every 00 00 01 xx."""
    out = []
    pos = 0
    while True:
        idx = data.find(b"\x00\x00\x01", pos)
        if idx < 0 or idx + 3 >= len(data):
            break
        out.append((idx + 3, data[idx + 3]))
        pos = idx + 3
    return out


class MPEG1Decoder(Decoder):
    NAME = "mpeg1video"
    TYPE = MediaType.VIDEO
    LONG_NAME = "MPEG-1 video (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MPEG1Decoder(params, options, device="cuda"|"cpu") — planes of the
        output frames (and of the DPB) are uint8 tensors on `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self.seq: Optional[SeqContext] = None
        self.pic = PicContext()
        # DPB: last two reference frames as device plane tuples
        self.ref_prev = None    # (y, u, v) padded device arrays
        self.ref_next = None
        self.ref_prev_frame: Optional[Frame] = None
        self.ref_next_frame: Optional[Frame] = None
        self._pending: List[Frame] = []
        self._frame_num = 0
        # field-picture state: pending first field + the two most recent
        # reference FIELDS by parity (13818-2 7.6.2.1)
        self._first_field = None
        self._recent_fields = {0: None, 1: None}
        # the picture in decode order (a field counts as one): the tag
        # of its spans
        self._pic_no = -1

    def _flush(self):
        self.ref_prev = self.ref_next = None
        self.ref_prev_frame = self.ref_next_frame = None
        self._first_field = None
        self._recent_fields = {0: None, 1: None}

    # ------------------------------------------------------------------ #

    def _decode(self, pkt: Packet) -> List[Frame]:
        # frames carry the pts of the packet they were *coded* in; with B
        # reordering a delayed anchor is emitted during a later packet and
        # must keep its own pts
        self._cur_pts = pkt.pts
        self._cur_tb = pkt.time_base
        frames = []
        data = pkt.data
        codes = find_start_codes(data)
        slices: List[Tuple[int, bytes]] = []
        pic_seen = False

        def segment(i):
            start = codes[i][0] + 1
            end = codes[i + 1][0] - 3 if i + 1 < len(codes) else len(data)
            return data[start:end]

        for i, (off, code) in enumerate(codes):
            if code == 0xB3:
                self._parse_seq_header(segment(i))
            elif code == 0xB5:
                self._parse_extension(segment(i))
            elif code == 0xB8:
                pass  # GOP header
            elif code == 0x00:
                if pic_seen and slices:
                    frames.extend(self._finish_picture(slices))
                    slices = []
                self._parse_picture_header(segment(i))
                pic_seen = True
            elif 0x01 <= code <= 0xAF:
                slices.append((code, segment(i)))
            elif code == 0xB7:  # sequence end
                pass
        if pic_seen and slices:
            frames.extend(self._finish_picture(slices))
        return frames

    def _drain(self) -> List[Frame]:
        # emit the held-back last reference frame (reordering delay)
        if self.ref_next_frame is not None and \
                getattr(self.ref_next_frame, "_emitted", False) is False:
            self.ref_next_frame._emitted = True
            return [self.ref_next_frame]
        return []

    # ------------------------------------------------------------------ #
    # Headers
    # ------------------------------------------------------------------ #

    def _parse_seq_header(self, seg: bytes):
        """reference: mpeg12dec.c mpeg1_decode_sequence"""
        gb = GetBits(seg)
        w = gb.get_bits(12)
        h = gb.get_bits(12)
        gb.get_bits(4)   # aspect
        frc = gb.get_bits(4)
        gb.get_bits(18)  # bit_rate
        gb.get_bits(1)   # marker
        gb.get_bits(10)  # vbv buffer size
        gb.get_bits(1)   # constrained
        seq = self.seq or SeqContext()
        seq.width, seq.height = w, h
        seq.mb_width = (w + 15) >> 4
        seq.mb_height = (h + 15) >> 4
        if 1 <= frc <= 8:
            n, d = T.FRAME_RATES[frc]
            seq.frame_rate = Rational(n, d)
        if gb.get_bits(1):  # load_intra_quantiser_matrix
            zz = zigzag_scan()
            m = np.zeros(64, dtype=np.int32)
            for k in range(64):
                m[zz[k]] = gb.get_bits(8)
            seq.intra_matrix = m
        elif seq.intra_matrix is None:
            seq.intra_matrix = T.DEFAULT_INTRA_MATRIX.copy()
        if gb.get_bits(1):  # load_non_intra
            zz = zigzag_scan()
            m = np.zeros(64, dtype=np.int32)
            for k in range(64):
                m[zz[k]] = gb.get_bits(8)
            seq.inter_matrix = m
        elif seq.inter_matrix is None:
            seq.inter_matrix = T.DEFAULT_NON_INTRA_MATRIX.copy()
        self.seq = seq
        self.width, self.height = w, h

    def _parse_extension(self, seg: bytes):
        """reference: mpeg12dec.c mpeg_decode_postinit + extension parsers"""
        gb = GetBits(seg)
        ext_id = gb.get_bits(4)
        if ext_id == 1:      # sequence extension -> this is MPEG-2
            self.seq.mpeg2 = True
            gb.get_bits(8)   # profile/level
            self.seq.progressive_sequence = gb.get_bits(1)
            self.seq.chroma_format = gb.get_bits(2)
            horiz_ext = gb.get_bits(2)
            vert_ext = gb.get_bits(2)
            if horiz_ext or vert_ext:
                self.seq.width |= horiz_ext << 12
                self.seq.height |= vert_ext << 12
                self.seq.mb_width = (self.seq.width + 15) >> 4
                self.seq.mb_height = (self.seq.height + 15) >> 4
        elif ext_id == 8:    # picture coding extension
            p = self.pic
            p.f_code = ((gb.get_bits(4), gb.get_bits(4)),
                        (gb.get_bits(4), gb.get_bits(4)))
            p.intra_dc_precision = gb.get_bits(2)
            p.picture_structure = gb.get_bits(2)
            p.top_field_first = gb.get_bits(1)
            p.frame_pred_frame_dct = gb.get_bits(1)
            p.concealment_mvs = gb.get_bits(1)
            p.q_scale_type = gb.get_bits(1)
            p.intra_vlc_format = gb.get_bits(1)
            p.alternate_scan = gb.get_bits(1)
            gb.get_bits(1)   # repeat_first_field
            gb.get_bits(1)   # chroma_420_type
            p.progressive_frame = gb.get_bits(1)
        elif ext_id == 2:    # sequence display extension
            pass
        elif ext_id == 3:    # quant matrix extension
            zz = zigzag_scan()
            if gb.get_bits(1):
                m = np.zeros(64, dtype=np.int32)
                for k in range(64):
                    m[zz[k]] = gb.get_bits(8)
                self.seq.intra_matrix = m
            if gb.get_bits(1):
                m = np.zeros(64, dtype=np.int32)
                for k in range(64):
                    m[zz[k]] = gb.get_bits(8)
                self.seq.inter_matrix = m

    def _parse_picture_header(self, seg: bytes):
        """reference: mpeg12dec.c mpeg1_decode_picture"""
        gb = GetBits(seg)
        p = PicContext()
        p.temporal_ref = gb.get_bits(10)
        p.pict_type = gb.get_bits(3)
        gb.get_bits(16)  # vbv_delay
        if p.pict_type in (PICT_P, PICT_B):
            fp = gb.get_bits(1)
            fc = gb.get_bits(3)
            p.full_pel = (fp, 0)
            p.f_code = ((fc, fc), (15, 15))
        if p.pict_type == PICT_B:
            fpb = gb.get_bits(1)
            fcb = gb.get_bits(3)
            p.full_pel = (p.full_pel[0], fpb)
            p.f_code = (p.f_code[0], (fcb, fcb))
        self.pic = p

    # ------------------------------------------------------------------ #
    # Slice entropy decode
    # ------------------------------------------------------------------ #

    def _finish_picture(self, slices) -> List[Frame]:
        seq, pic = self.seq, self.pic
        self._pic_no += 1
        if seq.mpeg2 and pic.picture_structure != 3:
            return self._finish_field(slices)
        nmb = seq.mb_width * seq.mb_height
        mb = MBData(nmb)
        for code, seg in slices:
            ok_before = mb.ok.copy()
            try:
                with timer.timer("mpeg2.entropy", pic=self._pic_no):
                    self._decode_slice(code, seg, mb)
            except AVError as e:
                # the whole slice is suspect: error detection lags the
                # actual corruption (reference er_add_slice marks the
                # resync-to-resync range damaged)
                mb.ok[:] = ok_before
                log.warning(self, "slice %d decode error: %s", code, e)
        if not mb.ok.all():
            # shared temporal concealment (er.py; reference
            # error_resilience.c guess_mv path)
            from libav_tpu_torch.codecs.er import conceal_missing
            n = conceal_missing(mb, seq.mb_width, seq.mb_height,
                                self.ref_next is not None)
            if n:
                log.warning(self, "concealed %d missing MBs", n)
                self._concealed_inter = True
        if pic.pict_type == PICT_B:
            timer.count("mpeg2.mb.b", nmb)
            timer.count("mpeg2.mb.bipred",
                        int(np.count_nonzero(mb.use_fwd & mb.use_bwd)))
            inner = timer.timer("mpeg2.recon.b", pic=self._pic_no)
        else:
            inner = timer.timer("mpeg2.recon.anchor", pic=self._pic_no,
                                type="P" if pic.pict_type == PICT_P
                                else "I")
        with timer.timer("mpeg2.recon", pic=self._pic_no), inner:
            frame = self._reconstruct(mb)
        frame.pts = getattr(self, "_cur_pts", None)
        frame.time_base = getattr(self, "_cur_tb", None)
        frame.pict_type = {PICT_I: PictureType.I, PICT_P: PictureType.P,
                           PICT_B: PictureType.B}.get(pic.pict_type,
                                                      PictureType.I)
        frame.key_frame = pic.pict_type == PICT_I
        # reorder: B frames output immediately; I/P delayed by one ref
        out = []
        if pic.pict_type == PICT_B:
            out.append(frame)
        else:
            if self.ref_next_frame is not None and \
                    not getattr(self.ref_next_frame, "_emitted", False):
                self.ref_next_frame._emitted = True
                out.append(self.ref_next_frame)
            self.ref_prev = self.ref_next
            self.ref_prev_frame = self.ref_next_frame
            self.ref_next = self._padded_refs
            self.ref_next_frame = frame
            if self.ref_prev is None:
                self.ref_prev = self.ref_next
                self.ref_prev_frame = frame
        return out

    def _finish_field(self, slices) -> List[Frame]:
        """One FIELD picture decoded; two consecutive field pictures
        weave into a frame (reference: mpeg12dec.c mpeg_field_start +
        frame_end logic)."""
        weave_fields_jit = hwdevice.program_factory(mpegvideo.weave_fields,
                                                    self.device)
        seq, pic = self.seq, self.pic
        if seq.mb_height % 2:
            raise AVError(INVALIDDATA, "field pictures need even MB "
                                       "height")
        mb_h_f = self._cur_mb_h()
        nmb = seq.mb_width * mb_h_f
        mb = MBData(nmb)
        for code, seg in slices:
            try:
                with timer.timer("mpeg2.entropy", pic=self._pic_no):
                    self._decode_slice(code, seg, mb)
            except AVError as e:
                log.warning(self, "field slice %d decode error: %s",
                            code, e)
        parity = pic.picture_structure - 1
        with timer.timer("mpeg2.recon", pic=self._pic_no):
            planes, padded = self._reconstruct_field(mb)
        is_ref = pic.pict_type != PICT_B
        if is_ref:
            self._recent_fields[parity] = padded
        if self._first_field is None:
            self._first_field = (parity, planes, pic.pict_type,
                                 getattr(self, "_cur_pts", None),
                                 getattr(self, "_cur_tb", None))
            return []
        p0, planes0, type0, pts0, tb0 = self._first_field
        self._first_field = None
        if p0 == parity:
            # same parity twice: treat the earlier one as lost
            self._first_field = (parity, planes, pic.pict_type,
                                 getattr(self, "_cur_pts", None),
                                 getattr(self, "_cur_tb", None))
            return []
        top = planes0 if p0 == 0 else planes
        bot = planes if p0 == 0 else planes0
        fplanes, fpadded = weave_fields_jit(seq.mb_width,
                                            seq.mb_height)(*top, *bot)
        self._padded_refs = fpadded
        frame = Frame(width=seq.width, height=seq.height,
                      format="yuv420p")
        frame.planes = [p[:h, :w] for p, (w, h) in
                        zip(fplanes,
                            [(seq.width, seq.height),
                             ((seq.width + 1) // 2,
                              (seq.height + 1) // 2),
                             ((seq.width + 1) // 2,
                              (seq.height + 1) // 2)])]
        frame.pts = pts0
        frame.time_base = tb0
        frame.interlaced_frame = True
        frame.top_field_first = p0 == 0
        frame.pict_type = {PICT_I: PictureType.I, PICT_P: PictureType.P,
                           PICT_B: PictureType.B}.get(type0,
                                                      PictureType.I)
        frame.key_frame = type0 == PICT_I
        out = []
        if type0 == PICT_B and pic.pict_type == PICT_B:
            out.append(frame)
        else:
            if self.ref_next_frame is not None and \
                    not getattr(self.ref_next_frame, "_emitted", False):
                self.ref_next_frame._emitted = True
                out.append(self.ref_next_frame)
            self.ref_prev = self.ref_next
            self.ref_prev_frame = self.ref_next_frame
            self.ref_next = fpadded
            self.ref_next_frame = frame
            if self.ref_prev is None:
                self.ref_prev = self.ref_next
                self.ref_prev_frame = frame
        return out

    def _reconstruct_field(self, mb: MBData):
        """Run the field-picture device program; returns (planes,
        padded) in FIELD geometry."""
        fields_of_frame_jit = hwdevice.program_factory(
            mpegvideo.fields_of_frame, self.device)
        recon_field_jit = hwdevice.program_factory(
            mpegvideo.recon_field_graphed, self.device)
        zero_pad_refs = functools.partial(mpegvideo.zero_pad_refs,
                                          device=self.device)
        seq, pic = self.seq, self.pic
        mb_h_f = self._cur_mb_h()
        zero_f = zero_pad_refs(seq.mb_width, mb_h_f)

        def fields_of(frame_padded):
            if frame_padded is None:
                return (zero_f, zero_f)
            return fields_of_frame_jit(seq.mb_width,
                                       seq.mb_height)(*frame_padded)

        if pic.pict_type == PICT_B:
            f0t, f0b = fields_of(self.ref_prev)
            f1t, f1b = fields_of(self.ref_next or self.ref_prev)
        else:
            # P/I: the two most recent reference fields (incl. the first
            # field of the current frame when decoding the second)
            f0t = self._recent_fields[0] or zero_f
            f0b = self._recent_fields[1] or zero_f
            # second-field rule: exclude the current picture's own slot
            # is unnecessary — _recent_fields was updated only after the
            # previous field finished, so slots hold the legal sources
            f1t, f1b = zero_f, zero_f

        dual = bool(mb.dp.any())
        fn = recon_field_jit(seq.mb_width, mb_h_f,
                             bool(pic.alternate_scan),
                             pic.pict_type != PICT_I, dual)
        scan = alternate_scan() if pic.alternate_scan else zigzag_scan()
        intra_q = self.seq.intra_matrix[scan].astype(np.int32)
        inter_q = self.seq.inter_matrix[scan].astype(np.int32)
        kw = {}
        if dual:
            kw = dict(dp=mb.dp, mv_dp2=mb.mv_dp2, sel_dp=mb.sel_dp)
        return fn(mb.coeffs, mb.qscale, mb.intra, mb.use_fwd, mb.use_bwd,
                  mb.mv_fwd2, mb.sel_fwd, mb.mv_bwd2, mb.sel_bwd,
                  intra_q, inter_q,
                  *f0t, *f0b, *f1t, *f1b, **kw)

    def _decode_slice(self, code: int, seg: bytes, mb: MBData):
        """One slice's entropy decode into `mb`: the native C decoder
        (native/mpeg12_slice.c) when the library is built and not
        switched off, else its Python twin `_decode_slice_py`. Both write
        the same arrays and raise the same error at the same MB; the port
        counters mpeg2.slice.native and mpeg2.slice.python count which
        ran."""
        if mpeg12_slice.available():
            timer.count("mpeg2.slice.native")
            mpeg12_slice.decode_slice(seg, mb, self.seq, self.pic,
                                      self._cur_mb_h(), code - 1)
        else:
            timer.count("mpeg2.slice.python")
            self._decode_slice_py(code, seg, mb)

    def _decode_slice_py(self, code: int, seg: bytes, mb: MBData):
        """reference: mpeg12dec.c mpeg_decode_slice :1642"""
        seq, pic = self.seq, self.pic
        gb = GetBits(seg)
        mb_y = code - 1
        if seq.mb_height > 175 and False:
            pass  # slice_vertical_position_extension for >2800 tall
        qscale = self._qscale(gb.get_bits(5))
        while gb.get_bits(1):   # extra_bit_slice
            gb.get_bits(8)

        mb_h_cur = self._cur_mb_h()
        mb_x = -1
        dc_pred = self._dc_reset()     # lum, cb, cr
        # motion predictors PMV[dir][vector][xy] (ISO 13818-2 7.6.3)
        pmv = np.zeros((2, 2, 2), dtype=np.int32)
        first_in_slice = True
        prev_mb_params = None   # for B skipped

        addr_vlc = T.mb_addr_vlc()

        while gb.bits_left() > 0 and gb.show_bits(23) != 0:
            # macroblock address increment
            inc = 0
            while True:
                v = addr_vlc.read(gb)
                if v == T.MB_ADDR_ESCAPE:
                    inc += 33
                    continue
                if v == T.MB_ADDR_STUFFING:
                    continue
                inc += v + 1
                break
            def advance():
                # MPEG-1 slices may span multiple MB rows; wrap like the
                # reference (mpeg12dec.c:1782 '++mb_x >= mb_width' path)
                nonlocal mb_x, mb_y
                mb_x += 1
                if mb_x >= seq.mb_width:
                    mb_x = 0
                    mb_y += 1
                if mb_y >= mb_h_cur:
                    raise AVError(INVALIDDATA, "MB address out of range")

            if first_in_slice:
                mb_x = inc - 1
                first_in_slice = False
                if mb_x >= seq.mb_width or mb_y >= mb_h_cur:
                    raise AVError(INVALIDDATA, "MB address out of range")
            else:
                # skipped MBs
                for s in range(inc - 1):
                    advance()
                    self._skipped_mb(mb, mb_y * seq.mb_width + mb_x,
                                     pmv, prev_mb_params)
                    mb.ok[mb_y * seq.mb_width + mb_x] = True
                advance()
                if inc > 1:
                    dc_pred = self._dc_reset()
                    if pic.pict_type == PICT_P:
                        pmv[:] = 0
            idx = mb_y * seq.mb_width + mb_x
            qscale, dc_pred, prev_mb_params = self._decode_mb(
                gb, mb, idx, qscale, dc_pred, pmv)
            mb.ok[idx] = True

    def _cur_mb_h(self) -> int:
        """MB rows of the current picture (field pictures cover half the
        frame height; ISO 13818-2 6.3.10)."""
        if self.seq.mpeg2 and self.pic.picture_structure != 3:
            return (self.seq.mb_height + 1) >> 1
        return self.seq.mb_height

    def _qscale(self, code: int) -> int:
        """MPEG-2 linear: 2*code; non-linear: table 7-6; MPEG-1: code."""
        if self.seq.mpeg2:
            if self.pic.q_scale_type:
                return int(T.NON_LINEAR_QSCALE[code])
            return code << 1
        return code

    def _dc_reset(self):
        # Predictors live in IDCT-input units: MPEG-1 stores pixel units
        # (device dequant scales DC x8 -> 1024); MPEG-2 diffs are
        # pre-scaled by (3 - intra_dc_precision) so the reset is the
        # constant 1<<10 regardless of precision (ISO 13818-2 §7.2.1).
        p = 1024 if self.seq.mpeg2 else 128
        return [p, p, p]

    def _decode_mb(self, gb, mb: MBData, idx: int, qscale: int,
                   dc_pred, pmv):
        """reference: mpeg12dec.c mpeg_decode_mb :659"""
        seq, pic = self.seq, self.pic
        if seq.mpeg2 and pic.picture_structure != 3:
            return self._decode_mb_field(gb, mb, idx, qscale, dc_pred,
                                         pmv)
        # macroblock_type
        if pic.pict_type == PICT_I:
            if gb.get_bits(1):
                flags = T.MB_INTRA
            else:
                if not gb.get_bits(1):
                    raise AVError(INVALIDDATA, "bad I-MB type code")
                flags = T.MB_QUANT | T.MB_INTRA
        elif pic.pict_type == PICT_P:
            flags = T.mb_ptype_vlc().read(gb)
        else:
            flags = T.mb_btype_vlc().read(gb)

        # macroblock_modes() tail (ISO 13818-2 6.2.5.1): frame_motion_type
        # then dct_type, BEFORE quantiser_scale_code and the MVs
        # (reference mpeg12dec.c:741 intra, :799 zero-MV, :823-825 MC).
        motion_type = 2  # frame MC
        if seq.mpeg2 and pic.picture_structure == 3 and \
                not pic.frame_pred_frame_dct:
            if flags & (T.MB_FOR | T.MB_BACK):
                motion_type = gb.get_bits(2)
            if flags & (T.MB_PAT | T.MB_INTRA):
                mb.dct_field[idx] = bool(gb.get_bits(1))

        if flags & T.MB_QUANT:
            qscale = self._qscale(gb.get_bits(5))
        mb.qscale[idx] = max(qscale, 1)

        if flags & T.MB_INTRA:
            mb.intra[idx] = True
            pmv[:] = 0
            if pic.concealment_mvs:
                self._read_mv_pair(gb, pmv, 0, 2)
                gb.get_bits(1)  # marker
        else:
            dc_pred[:] = self._dc_reset()

        if motion_type == 3 and (flags & T.MB_FOR):
            # frame-picture dual prime (13818-2 7.6.3.6; reference
            # mpeg_decode_mb MT_DMV + mpegvideo_motion.c MV_TYPE_DMV):
            # same-parity field predictions with the transmitted vector,
            # averaged with cross-parity predictions from the derived
            # vectors
            fx, fy = pic.f_code[0][0], pic.f_code[0][1]
            mx = self._decode_motion(gb, fx, int(pmv[0, 0, 0]))
            dmx = self._read_dmv(gb)
            my = self._decode_motion(gb, fy, int(pmv[0, 0, 1]) >> 1)
            dmy = self._read_dmv(gb)
            pmv[0, :, 0] = mx
            pmv[0, :, 1] = my << 1
            mb.use_fwd[idx] = True
            mb.field_mc[idx] = True
            mb.mv_fwd2[idx, 0] = mb.mv_fwd2[idx, 1] = (mx, my)
            mb.sel_fwd[idx] = (0, 1)          # top<-top, bottom<-bottom
            mb.mv_fwd[idx] = (mx, 2 * my)
            m = 1 if pic.top_field_first else 3
            mb.dp[idx] = True
            mb.mv_dp2[idx, 0] = (((mx * m + (1 if mx > 0 else 0)) >> 1)
                                 + dmx,
                                 ((my * m + (1 if my > 0 else 0)) >> 1)
                                 + dmy - 1)
            m = 4 - m
            mb.mv_dp2[idx, 1] = (((mx * m + (1 if mx > 0 else 0)) >> 1)
                                 + dmx,
                                 ((my * m + (1 if my > 0 else 0)) >> 1)
                                 + dmy + 1)
            mb.sel_dp[idx] = (1, 0)           # top<-bottom, bottom<-top
        elif flags & T.MB_FOR:
            kind, mv2, sels = self._read_mv_pair(gb, pmv, 0, motion_type)
            mb.use_fwd[idx] = True
            if kind == "field":
                mb.field_mc[idx] = True
                mb.mv_fwd2[idx] = mv2
                mb.sel_fwd[idx] = sels
                mb.mv_fwd[idx] = (mv2[0, 0], 2 * mv2[0, 1])
            else:
                # MPEG-1 full_pel: coded vector is in full-pel units
                mb.mv_fwd[idx] = pmv[0, 0] * \
                    (2 if self.pic.full_pel[0] else 1)
        if flags & T.MB_BACK:
            kind, mv2, sels = self._read_mv_pair(gb, pmv, 1, motion_type)
            mb.use_bwd[idx] = True
            if kind == "field":
                mb.field_mc[idx] = True
                mb.mv_bwd2[idx] = mv2
                mb.sel_bwd[idx] = sels
                mb.mv_bwd[idx] = (mv2[0, 0], 2 * mv2[0, 1])
            else:
                mb.mv_bwd[idx] = pmv[1, 0] * \
                    (2 if self.pic.full_pel[1] else 1)
        if mb.field_mc[idx] and (flags & (T.MB_FOR | T.MB_BACK)) and \
                not (flags & T.MB_FOR):
            # bwd-only field MB: fwd side must not contribute
            mb.mv_fwd2[idx] = 0
        if pic.pict_type == PICT_P and not (flags & (T.MB_FOR | T.MB_INTRA)):
            # no-MV P macroblock: zero forward vector
            pmv[:] = 0
            mb.use_fwd[idx] = True
            mb.mv_fwd[idx] = 0

        cbp = 0
        if flags & T.MB_PAT:
            cbp = T.cbp_vlc().read(gb)
            if cbp == 0 and not seq.mpeg2:
                raise AVError(INVALIDDATA, "zero CBP invalid in MPEG-1")
        elif flags & T.MB_INTRA:
            cbp = 0x3F

        if cbp or (flags & T.MB_INTRA):
            for blk in range(6):
                if cbp & (0x20 >> blk):
                    if flags & T.MB_INTRA:
                        dc_pred = self._decode_intra_block(
                            gb, mb.coeffs[idx, blk], blk, dc_pred)
                    else:
                        self._decode_inter_block(gb, mb.coeffs[idx, blk])
            mb.coded[idx] = True

        prev_params = (mb.use_fwd[idx], mb.use_bwd[idx],
                       mb.mv_fwd[idx].copy(), mb.mv_bwd[idx].copy())
        return qscale, dc_pred, prev_params

    # -- field pictures (ISO 13818-2 6.3.10/7.6; reference:
    #    mpeg12dec.c mpeg_decode_mb field branches) ---------------------- #

    def _decode_mb_field(self, gb, mb: MBData, idx: int, qscale: int,
                         dc_pred, pmv):
        """MB layer of a field picture: field_motion_type selects whole-
        field MC (1 vector), 16x8 MC (2 vectors) or dual prime; vertical
        predictors are NOT halved; no dct_type flag."""
        seq, pic = self.seq, self.pic
        parity = pic.picture_structure - 1      # 0 top, 1 bottom
        if pic.pict_type == PICT_I:
            if gb.get_bits(1):
                flags = T.MB_INTRA
            else:
                if not gb.get_bits(1):
                    raise AVError(INVALIDDATA, "bad I-MB type code")
                flags = T.MB_QUANT | T.MB_INTRA
        elif pic.pict_type == PICT_P:
            flags = T.mb_ptype_vlc().read(gb)
        else:
            flags = T.mb_btype_vlc().read(gb)

        motion_type = 0
        if flags & (T.MB_FOR | T.MB_BACK):
            if pic.frame_pred_frame_dct:
                motion_type = 2
            else:
                motion_type = gb.get_bits(2)
        if flags & T.MB_QUANT:
            qscale = self._qscale(gb.get_bits(5))
        mb.qscale[idx] = max(qscale, 1)

        if flags & T.MB_INTRA:
            mb.intra[idx] = True
            pmv[:] = 0
            if pic.concealment_mvs:
                self._read_field_mv(gb, mb, idx, pmv, 0, 1, parity)
                gb.get_bits(1)
                mb.use_fwd[idx] = False
            mb.coded[idx] = True
        else:
            dc_pred[:] = self._dc_reset()

        for d, fl in ((0, T.MB_FOR), (1, T.MB_BACK)):
            if flags & fl:
                self._read_field_mv(gb, mb, idx, pmv, d, motion_type,
                                    parity)
                (mb.use_fwd, mb.use_bwd)[d][idx] = True
        if pic.pict_type == PICT_P and \
                not (flags & (T.MB_FOR | T.MB_INTRA)):
            # no-MV P macroblock: same-parity field, zero vector
            pmv[:] = 0
            mb.use_fwd[idx] = True
            mb.mv_fwd2[idx] = 0
            mb.sel_fwd[idx] = parity

        cbp = 0
        if flags & T.MB_PAT:
            cbp = T.cbp_vlc().read(gb)
        elif flags & T.MB_INTRA:
            cbp = 0x3F
        if cbp or (flags & T.MB_INTRA):
            for blk in range(6):
                if cbp & (0x20 >> blk):
                    if flags & T.MB_INTRA:
                        dc_pred = self._decode_intra_block(
                            gb, mb.coeffs[idx, blk], blk, dc_pred)
                    else:
                        self._decode_inter_block(gb, mb.coeffs[idx, blk])
            mb.coded[idx] = True

        prev_params = (bool(mb.use_fwd[idx]), bool(mb.use_bwd[idx]),
                       mb.mv_fwd2[idx].copy(), mb.mv_bwd2[idx].copy(),
                       mb.sel_fwd[idx].copy(), mb.sel_bwd[idx].copy())
        return qscale, dc_pred, prev_params

    def _read_field_mv(self, gb, mb: MBData, idx: int, pmv, d: int,
                       motion_type: int, parity: int):
        """One direction's vectors in a field picture (reference:
        mpeg_decode_mb MT_FIELD/MT_16X8/MT_DMV field branches)."""
        pic = self.pic
        fx, fy = pic.f_code[d][0], pic.f_code[d][1]
        mv2 = mb.mv_fwd2 if d == 0 else mb.mv_bwd2
        sel = mb.sel_fwd if d == 0 else mb.sel_bwd
        if motion_type == 1:            # whole-field MC, one vector
            s = gb.get_bits(1)
            x = self._decode_motion(gb, fx, int(pmv[d, 0, 0]))
            y = self._decode_motion(gb, fy, int(pmv[d, 0, 1]))
            pmv[d, :, 0] = x
            pmv[d, :, 1] = y
            mv2[idx, 0] = mv2[idx, 1] = (x, y)
            sel[idx, 0] = sel[idx, 1] = s
        elif motion_type == 2:          # 16x8: upper and lower halves
            for j in range(2):
                s = gb.get_bits(1)
                x = self._decode_motion(gb, fx, int(pmv[d, j, 0]))
                y = self._decode_motion(gb, fy, int(pmv[d, j, 1]))
                pmv[d, j] = (x, y)
                mv2[idx, j] = (x, y)
                sel[idx, j] = s
        elif motion_type == 3:          # dual prime (P only)
            x = self._decode_motion(gb, fx, int(pmv[d, 0, 0]))
            dmx = self._read_dmv(gb)
            y = self._decode_motion(gb, fy, int(pmv[d, 0, 1]))
            dmy = self._read_dmv(gb)
            pmv[d, :, 0] = x
            pmv[d, :, 1] = y
            # same-parity prediction
            mv2[idx, 0] = mv2[idx, 1] = (x, y)
            sel[idx, 0] = sel[idx, 1] = parity
            # opposite-parity prediction (7.6.3.6, m=1 for fields)
            ox = ((x + (1 if x > 0 else 0)) >> 1) + dmx
            oy = ((y + (1 if y > 0 else 0)) >> 1) + dmy
            oy += -1 if parity == 0 else 1
            mb.dp[idx] = True
            mb.mv_dp2[idx, 0] = mb.mv_dp2[idx, 1] = (ox, oy)
            mb.sel_dp[idx, 0] = mb.sel_dp[idx, 1] = 1 - parity
        else:
            raise AVError(INVALIDDATA, "motion_type 0 in field picture")

    def _read_dmv(self, gb) -> int:
        """dmvector[] (ISO 13818-2 Table B-11: '0'=0, '10'=+1, '11'=-1;
        reference get_dmv)."""
        if gb.get_bits(1):
            return -1 if gb.get_bits(1) else 1
        return 0

    def _skipped_mb_field(self, mb: MBData, idx: int, prev_params):
        """Skipped MB in a field picture: P = same-parity zero vector,
        B = repeat previous MB's prediction (13818-2 7.6.6)."""
        parity = self.pic.picture_structure - 1
        if self.pic.pict_type == PICT_P:
            mb.use_fwd[idx] = True
            mb.mv_fwd2[idx] = 0
            mb.sel_fwd[idx] = parity
        elif self.pic.pict_type == PICT_B and prev_params is not None:
            uf, ub, mf2, mb2, sf, sb = prev_params
            mb.use_fwd[idx] = uf
            mb.use_bwd[idx] = ub
            mb.mv_fwd2[idx] = mf2
            mb.mv_bwd2[idx] = mb2
            mb.sel_fwd[idx] = sf
            mb.sel_bwd[idx] = sb

    def _skipped_mb(self, mb: MBData, idx: int, pmv, prev_params):
        """reference: mpeg12dec.c skipped-MB handling in mpeg_decode_slice"""
        if self.seq.mpeg2 and self.pic.picture_structure != 3:
            return self._skipped_mb_field(mb, idx, prev_params)
        if self.pic.pict_type == PICT_P:
            mb.use_fwd[idx] = True
            mb.mv_fwd[idx] = 0
        elif self.pic.pict_type == PICT_B and prev_params is not None:
            uf, ub, mf, mbk = prev_params
            mb.use_fwd[idx] = uf
            mb.use_bwd[idx] = ub
            mb.mv_fwd[idx] = mf
            mb.mv_bwd[idx] = mbk

    # -- motion vectors -------------------------------------------------- #

    def _read_mv_pair(self, gb, pmv, direction: int, motion_type: int):
        """reference: mpeg12dec.c mpeg_decode_mb MT_FRAME/MT_FIELD
        branches. Frame MC updates both PMV rows; field MC in frame
        pictures reads two field vectors, the vertical component
        predicted from PMV>>1 and stored back doubled (frame units).
        Returns ('frame', None, None) or ('field', mv2 (2,2), sels)."""
        if self.seq.mpeg2 and motion_type == 1 and \
                self.pic.picture_structure == 3:
            mv2 = np.zeros((2, 2), dtype=np.int32)
            sels = np.zeros(2, dtype=np.int32)
            for v in range(2):
                sels[v] = gb.get_bits(1)   # motion_vertical_field_select
                fx = self.pic.f_code[direction][0]
                fy = self.pic.f_code[direction][1]
                x = self._decode_motion(gb, fx, int(pmv[direction, v, 0]))
                pmv[direction, v, 0] = x
                y = self._decode_motion(gb, fy,
                                        int(pmv[direction, v, 1]) >> 1)
                pmv[direction, v, 1] = 2 * y
                mv2[v] = (x, y)
            return "field", mv2, sels
        for xy in range(2):
            fcode = self.pic.f_code[direction][xy]
            val = self._decode_motion(gb, fcode,
                                      int(pmv[direction, 0, xy]))
            pmv[direction, 0, xy] = val
            pmv[direction, 1, xy] = val
        return "frame", None, None

    def _decode_motion(self, gb, fcode: int, pred: int) -> int:
        """reference: mpeg12dec.c mpeg_decode_motion (ISO 11172-2
        §2.4.4.2 reconstruction)."""
        code_vlc = T.motion_vlc()
        code = code_vlc.read(gb)
        if code == 0:
            return pred
        sign = gb.get_bits(1)
        shift = fcode - 1
        if shift > 0:
            residual = gb.get_bits(shift)
            delta = ((code - 1) << shift) + residual + 1
        else:
            delta = code
        if sign:
            delta = -delta
        val = pred + delta
        # wrap into legal range
        lim = 1 << (shift + 4)
        if val < -lim:
            val += 2 * lim
        elif val >= lim:
            val -= 2 * lim
        if self.pic.full_pel[0]:
            pass  # handled by caller scaling (rare; MPEG-1 only)
        return val

    # -- block coefficient decode ---------------------------------------- #

    def _decode_intra_block(self, gb, out: np.ndarray, blk: int, dc_pred):
        """reference: mpeg12dec.c mpeg1_decode_block_intra /
        mpeg2_decode_block_intra"""
        seq, pic = self.seq, self.pic
        comp = 0 if blk < 4 else (1 if blk == 4 else 2)
        dc_vlc = T.dc_lum_vlc() if blk < 4 else T.dc_chroma_vlc()
        size = dc_vlc.read(gb)
        if size > 0:
            diff = gb.get_bits(size)
            if diff < (1 << (size - 1)):
                diff -= (1 << size) - 1
        else:
            diff = 0
        dc_pred[comp] += diff << (3 - pic.intra_dc_precision) \
            if seq.mpeg2 else diff
        out[0] = dc_pred[comp] if seq.mpeg2 else dc_pred[comp]
        # MPEG-1: DC stored in "pixel" units (x1); device dequant scales x8.
        # MPEG-2: host pre-scales by (3 - intra_dc_precision); device
        # passes DC through.
        use_b15 = seq.mpeg2 and pic.intra_vlc_format
        self._decode_ac(gb, out, first=False, mpeg2_table=use_b15,
                        start=1)
        return dc_pred

    def _decode_inter_block(self, gb, out: np.ndarray):
        self._decode_ac(gb, out, first=True, mpeg2_table=False, start=0)

    def _decode_ac(self, gb, out: np.ndarray, first: bool,
                   mpeg2_table: bool, start: int):
        """Run-level loop, table B.14/B.15 (reference: mpeg12dec.c
        mpeg1_decode_block_inter inner loop)."""
        seq = self.seq
        vlc = T.dct_vlc(mpeg2_table)
        i = start
        if first:
            # special case: first coefficient '1s' means (0, +-1)
            if gb.show_bits(1) == 1:
                gb.skip_bits(1)
                level = 1 if gb.get_bits(1) == 0 else -1
                out[0] = level
                i = 1
                first = False
        while True:
            v = vlc.read(gb)
            if v == T.EOB_INDEX:
                break
            if v == T.ESCAPE_INDEX:
                run = gb.get_bits(6)
                if seq.mpeg2:
                    level = gb.get_sbits(12)
                else:
                    level = gb.get_sbits(8)
                    if level == -128:
                        level = gb.get_bits(8) - 256
                    elif level == 0:
                        level = gb.get_bits(8)
            else:
                run = T.RUN_LEVEL[0][v]
                level = T.RUN_LEVEL[1][v]
                if gb.get_bits(1):
                    level = -level
            i += run
            if i > 63:
                raise AVError(INVALIDDATA, "AC index overflow")
            out[i] = level
            i += 1
            if i > 64:
                break

    # ------------------------------------------------------------------ #
    # Device reconstruction
    # ------------------------------------------------------------------ #

    def _reconstruct(self, mb: MBData) -> Frame:
        recon_jit = hwdevice.program_factory(mpegvideo.recon_graphed,
                                             self.device)
        seq, pic = self.seq, self.pic
        interlaced = bool(mb.field_mc.any() or mb.dct_field.any())
        dual = bool(mb.dp.any())
        inter = pic.pict_type != PICT_I or \
            getattr(self, "_concealed_inter", False)
        self._concealed_inter = False
        fn = recon_jit(seq.mb_width, seq.mb_height,
                       "mpeg2" if seq.mpeg2 else "mpeg1",
                       bool(pic.alternate_scan), inter,
                       interlaced=interlaced, dual=dual)

        scan = alternate_scan() if pic.alternate_scan else zigzag_scan()
        # qmat in scan order to match coefficient layout
        intra_q = self.seq.intra_matrix[scan]
        inter_q = self.seq.inter_matrix[scan]

        # P pictures predict from the most recent reference; B pictures
        # use (older, newer) as (forward, backward)
        if pic.pict_type == PICT_B:
            ref0 = self.ref_prev or _zero_refs(seq, self.device)
            ref1 = self.ref_next or ref0
        else:
            ref0 = self.ref_next or self.ref_prev or \
                _zero_refs(seq, self.device)
            ref1 = ref0

        kw = {}
        if interlaced:
            kw = dict(field_mc=mb.field_mc, dct_field=mb.dct_field,
                      mvf2=mb.mv_fwd2, mvb2=mb.mv_bwd2,
                      sel_f=mb.sel_fwd, sel_b=mb.sel_bwd)
            if dual:
                kw.update(dp=mb.dp, mv_dp2=mb.mv_dp2, sel_dp=mb.sel_dp)
        planes, padded = fn(mb.coeffs, mb.qscale, mb.intra, mb.use_fwd,
                            mb.use_bwd, mb.mv_fwd, mb.mv_bwd,
                            intra_q.astype(np.int32),
                            inter_q.astype(np.int32),
                            ref0[0], ref0[1], ref0[2],
                            ref1[0], ref1[1], ref1[2], **kw)
        self._padded_refs = padded
        f = Frame(width=seq.width, height=seq.height, format="yuv420p")
        f.planes = [p[:h, :w] for p, (w, h) in
                    zip(planes, [(seq.width, seq.height),
                                 ((seq.width + 1) // 2, (seq.height + 1) // 2),
                                 ((seq.width + 1) // 2, (seq.height + 1) // 2)])]
        return f


@register_codec
class MPEG2Decoder(MPEG1Decoder):
    NAME = "mpeg2video"
    LONG_NAME = "MPEG-2 video (PyTorch device reconstruction)"


# register mpeg1 as well
register_codec(MPEG1Decoder)


def _zero_refs(seq: SeqContext, device):
    return mpegvideo.zero_pad_refs(seq.mb_width, seq.mb_height,
                                   device=device)
