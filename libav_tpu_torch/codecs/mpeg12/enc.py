"""MPEG-1 and MPEG-2 video encoders (counterpart of
`libav_tpu/codecs/mpeg12/enc.py`; reference: libavcodec/mpeg12enc.c and
the mpegvideo_enc.c driver ff_mpv_encode_picture).

Device, on the encoder's torch device (`MPEG2Encoder(params,
device="cuda")` by default; "cpu" runs the same programs on the CPU):
the diamond + half-pel motion search bounded to the picture (ops/me.py),
prediction, FDCT and the MPEG-1/2 quantiser through the port's
`codecs/mpegvideo.py` programs `encode` (I/P pictures), `encode_b` (B
pictures) and `encode_field_stress` (P field pictures), and the anchors'
reconstruction through `recon` or `recon_field`, whose IDCT is kernel
K2: one launch per I/P picture, two per field-coded frame. The input
planes are padded to whole macroblocks on the device and the reference
planes stay there from one picture to the next. The levels (cast to
int16 on the device), vectors and intra flags come to the host once per
picture for the packer.

Host, the JAX package's code, copied and changed only in its imports and
where it reaches a device program: the sequence, picture and extension
headers, slice/MB VLC packing (I/P/B and MPEG-2 field pictures with every
field_motion_type), the frame reordering (I B..B P, coded anchor-first,
a trailing B run drained behind a P), rate control (ratecontrol.py),
adaptive quantisation over the downloaded planes, and trellis
quantisation of the downloaded coefficients (codecs/trellis.py).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpeg12 import tables as T
from libav_tpu_torch.codecs.mpeg12.dec import PICT_B, PICT_I, PICT_P
from libav_tpu_torch.codecs.mpegvideo import (encode, encode_b,
                                              encode_field_stress, recon,
                                              recon_field, zero_pad_refs)
from libav_tpu_torch.ops.mc import EDGE
from libav_tpu_torch.ops.quant import zigzag_scan


@functools.lru_cache(maxsize=None)
def _rl_encode_map() -> Dict[Tuple[int, int], Tuple[int, int]]:
    """(run, level>0) -> (code, bits) from table B.14 (sign bit appended
    by the packer)."""
    m = {}
    for i in range(111):
        run = T.RUN_LEVEL[0][i]
        level = T.RUN_LEVEL[1][i]
        code, bits = T.DCT_VLC_MPEG1[i]
        m[(run, level)] = (code, bits)
    return m


def _encode_motion(pb: PutBits, delta: int, fcode: int):
    """Inverse of dec._decode_motion (ISO 11172-2 §2.4.4.2)."""
    shift = fcode - 1
    lim = 1 << (shift + 4)
    if delta < -lim:
        delta += 2 * lim
    elif delta >= lim:
        delta -= 2 * lim
    if delta == 0:
        pb.put_bits(T.MOTION_CODE[1][0], T.MOTION_CODE[0][0])
        return
    a = abs(delta)
    code = ((a - 1) >> shift) + 1
    residual = a - 1 - ((code - 1) << shift)
    pb.put_bits(T.MOTION_CODE[1][code], T.MOTION_CODE[0][code])
    pb.put_bits(1, 1 if delta < 0 else 0)
    if shift:
        pb.put_bits(shift, residual)


def _encode_dc(pb: PutBits, diff: int, lum: bool):
    """Table B.5a/b DC size + differential."""
    size = abs(diff).bit_length()
    codes, bits = T.DC_LUM if lum else T.DC_CHROMA
    pb.put_bits(bits[size], codes[size])
    if size:
        v = diff if diff > 0 else diff + (1 << size) - 1
        pb.put_bits(size, v)


def _encode_block_ac(pb: PutBits, levels: np.ndarray, start: int,
                     first_inter: bool, mpeg2: bool = False):
    """Run-level coding, table B.14 + escapes; levels in zigzag order.
    MPEG-2 escapes carry a single 12-bit signed level (ISO 13818-2
    §7.2.2.3); MPEG-1 uses the 8/16-bit two-step form."""
    m = _rl_encode_map()
    run = 0
    first = first_inter
    for k in range(start, 64):
        lvl = int(levels[k])
        if lvl == 0:
            run += 1
            continue
        a = abs(lvl)
        if first and run == 0 and a == 1:
            # dct_coeff_first special case: '1' + sign
            pb.put_bits(1, 1)
            pb.put_bits(1, 1 if lvl < 0 else 0)
        elif (run, a) in m:
            code, bits = m[(run, a)]
            pb.put_bits(bits, code)
            pb.put_bits(1, 1 if lvl < 0 else 0)
        else:
            pb.put_bits(6, 0x1)      # escape
            pb.put_bits(6, run)
            if mpeg2:
                pb.put_sbits(12, lvl)
            elif -127 <= lvl <= 127:
                pb.put_sbits(8, lvl)
            elif lvl > 0:
                pb.put_bits(8, 0x00)
                pb.put_bits(8, lvl)
            else:
                pb.put_bits(8, 0x80)
                pb.put_bits(8, lvl + 256)
        run = 0
        first = False
    pb.put_bits(2, 0x2)  # EOB


@register_codec
class MPEG1Encoder(Encoder):
    NAME = "mpeg1video"
    TYPE = MediaType.VIDEO
    LONG_NAME = "MPEG-1 video (PyTorch ME/DCT/quant)"

    OPTIONS = Encoder.OPTIONS + [
        Option("qscale", "fixed quantizer 1-31", "int", 8, 1, 31),
        Option("gop_size", "GOP length", "int", 12, 1, 600),
        Option("rc_eq", "rate control equation", "string", "tex^qComp"),
        Option("qcompress", "rc qscale compression", "float", 0.6, 0.0, 1.0),
        Option("pass_", "2-pass mode: 1 or 2", "int", 0, 0, 2),
        Option("b_frames", "max B frames between references", "int",
               0, 0, 4),
        Option("trellis", "rate-distortion optimal quantization of "
               "inter blocks (codecs/trellis.py, table B.14 costs)",
               "int", 0, 0, 1),
        Option("mbcmp", "macroblock decision metric: sad or satd "
               "(Hadamard einsum, ops/mecmp.py)", "string", "sad"),
        Option("trellis_lambda", "trellis RD lambda scale x100", "int",
               25, 1, 400),
        # adaptive quantization (ratecontrol.c:703): any nonzero
        # masking enables per-MB qscale coded through the QUANT
        # macroblock_type variants (tables B.2a/B.2b)
        Option("lumi_masking", "bright-region masking strength",
               "float", 0.0, -10.0, 10.0),
        Option("dark_masking", "dark-region masking strength",
               "float", 0.0, -10.0, 10.0),
        Option("tcplx_masking", "temporal complexity masking",
               "float", 0.0, -10.0, 10.0),
        Option("scplx_masking", "spatial complexity masking",
               "float", 0.0, -10.0, 10.0),
        Option("p_masking", "inter-MB masking", "float", 0.0,
               -10.0, 10.0),
        Option("border_masking", "frame-border masking strength",
               "float", 0.0, -10.0, 10.0),
        Option("mb_qmin", "per-MB quantizer floor", "int", 2, 1, 31),
        Option("mb_qmax", "per-MB quantizer ceiling", "int", 31, 1, 31),
    ]

    F_CODE = 2   # supports +-31.5 pel half-pel vectors (search range 15)
    QUANT_KIND = "mpeg1"
    DEVICE_PART = True

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MPEG1Encoder(params, options, device=...): the device programs
        run on `device`; frames may hold numpy arrays or tensors."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    @property
    def _adaptive_quant(self) -> bool:
        return bool((self.lumi_masking or self.dark_masking or
                     self.tcplx_masking or self.scplx_masking or
                     self.p_masking or self.border_masking)
                    and not getattr(self, "fieldpic", 0))

    def _frame_qscale(self, y, q: int, is_i: bool):
        """Per-MB qscale field.  MPEG-1/2 quantiser_scale_code is an
        absolute 5-bit value, so no step constraint is needed — any
        quant-capable MB (intra or coded-pattern) re-anchors the
        decoder's running qscale; motion-only MBs carry no
        coefficients, so their field value is moot.  MPEG-2 linear
        q_scale_type keeps the field even (qscale = 2*code)."""
        nmb = self.mb_w * self.mb_h
        if not self._adaptive_quant:
            return np.full(nmb, q, dtype=np.int32)
        from libav_tpu_torch.codecs.ratecontrol import adaptive_qscale_field
        ref_y = None
        if not is_i and self._refs is not None:
            ref_y = self._refs[0][EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
        qs = adaptive_qscale_field(
            q, y.cpu().numpy(), ref_y, self.mb_w, self.mb_h, force_intra=is_i,
            lumi_masking=self.lumi_masking,
            dark_masking=self.dark_masking,
            temporal_cplx_masking=self.tcplx_masking,
            spatial_cplx_masking=self.scplx_masking,
            p_masking=self.p_masking,
            border_masking=self.border_masking,
            qmin=self.mb_qmin, qmax=self.mb_qmax)
        if self.QUANT_KIND == "mpeg2":
            qs = qs + (qs & 1)
        return qs

    def _qscale_code(self, q: int) -> int:
        return q              # MPEG-1: quantizer_scale_code == qscale

    def _dc_for_pack(self, dc: int) -> int:
        return dc             # MPEG-1 levels carry DC in pixel units

    def _init(self):
        if self.width <= 0 or self.height <= 0:
            raise AVError(EINVAL, "mpeg1video: width/height required")
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        self.intra_q = T.DEFAULT_INTRA_MATRIX.copy()
        self.inter_q = T.DEFAULT_NON_INTRA_MATRIX.copy()
        zz = zigzag_scan()
        self.intra_q_zz = self.intra_q[zz].astype(np.int32)
        self.inter_q_zz = self.inter_q[zz].astype(np.int32)
        self._qi, self._qp = (torch.as_tensor(m).to(self.device)
                              for m in (self.intra_q_zz, self.inter_q_zz))
        self._frame_idx = 0
        self._refs = None      # padded recon planes (device), newest anchor
        self._ref_old = None   # previous anchor (forward ref for B)
        self._pending_b = []   # [(frame, display_idx)] awaiting an anchor
        self._disp_idx = 0
        self._coded_idx = 0
        self._pts_seq = []     # display-order pts for delayed-dts mapping
        self._fr = self.params.framerate if self.params.framerate else Rational(25, 1)
        # rate control: engaged when a target bitrate is configured
        # (reference: mpegvideo_enc.c wiring of ratecontrol.c)
        self.rc = None
        if self.bit_rate:
            from libav_tpu_torch.codecs.ratecontrol import RateControl
            self.rc = RateControl(self.bit_rate, self._fr,
                                  rc_eq=self.rc_eq,
                                  qcompress=self.qcompress)
            if self.pass_ == 2 and getattr(self, "stats_in", None):
                self.rc.load_pass1(self.stats_in)

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        """Frame reordering driver (reference: mpegvideo_enc.c
        select_input_picture / set_frame_distances): display order
        I B..B P B..B P ... is coded anchor-first."""
        disp = self._disp_idx
        self._disp_idx += 1
        self._pts_seq.append(frame.pts if frame.pts is not None else disp)
        is_i = (disp % self.gop_size) == 0 or self._refs is None
        if not is_i and self.b_frames and \
                len(self._pending_b) < self.b_frames and \
                (disp + 1) % self.gop_size != 0:
            self._pending_b.append((frame, disp))
            return []
        pkts = [self._encode_anchor(frame, disp,
                                    PICT_I if is_i else PICT_P)]
        for bf, bd in self._pending_b:
            pkts.append(self._encode_b(bf, bd))
        self._pending_b = []
        return pkts

    def _drain(self) -> List[Packet]:
        pkts = []
        if self._pending_b:
            # stream ends inside a B run: promote the last held frame to a
            # P anchor, code the rest as Bs between the two anchors
            last_f, last_d = self._pending_b[-1]
            rest = self._pending_b[:-1]
            self._pending_b = []
            pkts.append(self._encode_anchor(last_f, last_d, PICT_P))
            for bf, bd in rest:
                pkts.append(self._encode_b(bf, bd))
        return pkts

    def _next_dts(self):
        """Coded packet k gets dts = display pts[k-1] (one-frame delay)
        so dts <= pts and dts is monotone in coded order. Without B
        frames dts == pts (no reordering delay)."""
        c = self._coded_idx
        self._coded_idx += 1
        if not self.b_frames:
            return None
        if c == 0:
            return self._pts_seq[0] - 1
        return self._pts_seq[c - 1]

    def _encode_anchor(self, frame: Frame, disp: int,
                       pict_type: int) -> Packet:
        is_i = pict_type == PICT_I
        prev_anchor = self._refs          # forward ref for the B run
        y, u, v = self._padded_input(frame)
        nmb = self.mb_w * self.mb_h
        q = self.qscale
        if self.rc is not None:
            q = self.rc.qscale_for_frame("I" if is_i else "P")
            if self.QUANT_KIND == "mpeg2":
                q = max(2, q + (q & 1))
        qscale = self._frame_qscale(y, q, is_i)
        qs = torch.as_tensor(qscale).to(self.device)

        want_tr = bool(self.trellis and not is_i)
        enc = encode(self.mb_w, self.mb_h, not is_i, self.QUANT_KIND,
                     want_coeffs=want_tr, mbcmp=self.mbcmp,
                     device=self.device)
        zero = zero_pad_refs(self.mb_w, self.mb_h, device=self.device)
        outs = enc(y, u, v, qs, self._qi, self._qp,
                   *(zero if is_i else self._refs))
        lv, mv, intra_d = outs[0].to(torch.int16), outs[1], outs[2]
        levels, mvs, intra = self._download(lv, mv, intra_d)
        if want_tr and not intra.all():
            # RD re-quantization of the inter blocks (reference role:
            # mpegvideo_enc.c dct_quantize_trellis_c with MPEG-1/2
            # table B.14 run/level + EOB costs)
            from libav_tpu_torch.codecs.trellis import trellis_inter
            czz, = self._download(outs[3])
            sel = np.repeat(~intra, 6)
            flat = levels.reshape(-1, 64).copy()
            flat[sel] = trellis_inter(
                czz.reshape(-1, 64)[sel], flat[sel],
                np.repeat(qscale, 6)[sel], kind=self.QUANT_KIND,
                lam_scale=self.trellis_lambda / 100.0)
            levels = flat.reshape(levels.shape).astype(np.int16)
            lv = torch.as_tensor(levels).to(self.device)

        # reconstruction through the decoder's own device program
        rec = recon(self.mb_w, self.mb_h, self.QUANT_KIND, False, not is_i,
                    device=self.device)
        no = torch.zeros(nmb, dtype=torch.bool, device=self.device)
        use_fwd = no if is_i else ~intra_d
        _, padded = rec(lv, qs, intra_d, use_fwd, no, mv,
                        torch.zeros_like(mv), self._qi, self._qp,
                        *(zero if is_i else self._refs), *zero)
        self._refs = padded

        self._ref_old = prev_anchor or padded

        data = self._pack(levels, mvs, intra, pict_type, qscale, disp)
        if self.rc is not None:
            self.rc.frame_done("I" if is_i else "P", len(data) * 8, q)
        dts = self._next_dts()
        pkt = Packet(data=data, pts=frame.pts,
                     dts=frame.pts if dts is None else dts, duration=1,
                     flags=PKT_FLAG_KEY if is_i else 0,
                     time_base=frame.time_base)
        self._frame_idx += 1
        return pkt

    def _encode_b(self, frame: Frame, disp: int) -> Packet:
        """B picture: ME against both anchors on device, pack B slices."""
        y, u, v = self._padded_input(frame)
        nmb = self.mb_w * self.mb_h
        q = self.qscale
        if self.rc is not None:
            q = self.rc.qscale_for_frame("P")
            if self.QUANT_KIND == "mpeg2":
                q = max(2, q + (q & 1))
        qscale = np.full(nmb, q, dtype=np.int32)
        fn = encode_b(self.mb_w, self.mb_h, self.QUANT_KIND,
                      device=self.device)
        ref_f = self._ref_old
        ref_b = self._refs
        levels, mvf, mvb, use_fwd, use_bwd = fn(
            y, u, v, torch.as_tensor(qscale).to(self.device), self._qp,
            *ref_f, *ref_b)
        levels, mvf, mvb, use_fwd, use_bwd = self._download(
            levels.to(torch.int16), mvf, mvb, use_fwd, use_bwd)

        pb_data = bytearray()
        pb_data += self._picture_header(PICT_B, disp)
        pb_data += self._slices_b(levels, mvf, mvb, use_fwd, use_bwd,
                                  qscale)
        data = bytes(pb_data)
        if self.rc is not None:
            self.rc.frame_done("P", len(data) * 8, q)
        dts = self._next_dts()
        self._frame_idx += 1
        return Packet(data=data, pts=frame.pts,
                      dts=frame.pts if dts is None else dts, duration=1,
                      flags=0, time_base=frame.time_base)

    @staticmethod
    def _download(*tensors):
        """Device tensors -> host numpy arrays, for the packer."""
        return tuple(t.cpu().numpy() for t in tensors)

    def _padded_input(self, frame: Frame):
        """The frame's planes as uint8 tensors on the encoder's device,
        edge-padded at the bottom and right to whole macroblocks (an
        index gather: replicate padding takes no uint8 on CUDA)."""
        H, W = self.mb_h * 16, self.mb_w * 16
        out = []
        for p, (h, w) in zip(frame.planes[:3], ((H, W), (H // 2, W // 2),
                                                (H // 2, W // 2))):
            if not isinstance(p, torch.Tensor):
                p = torch.as_tensor(np.asarray(p))
            p = p.to(self.device)
            rows = torch.arange(h, device=self.device).clamp_(
                max=p.shape[0] - 1)
            cols = torch.arange(w, device=self.device).clamp_(
                max=p.shape[1] - 1)
            out.append(p[rows[:, None], cols[None, :]])
        return tuple(out)

    # ------------------------------------------------------------------ #

    def _pack(self, levels, mvs, intra, pict_type, qscale,
              disp: int) -> bytes:
        out = bytearray()
        if pict_type == PICT_I:
            out += self._seq_header()
        out += self._picture_header(pict_type, disp)
        out += self._slices(levels, mvs, intra, pict_type, qscale)
        if (self._frame_idx + 1) % self.gop_size == 0:
            pass
        return bytes(out)

    def _seq_header(self) -> bytes:
        """ISO 11172-2 §2.4.2.3 (reference: mpeg12enc.c
        mpeg1_encode_sequence_header)."""
        pb = PutBits()
        pb.put_bits(12, self.width)
        pb.put_bits(12, self.height)
        pb.put_bits(4, 1)            # aspect: square pixels
        frc = _frame_rate_code(self._fr)
        pb.put_bits(4, frc)
        pb.put_bits(18, 0x3FFFF)     # bit_rate: variable
        pb.put_bits(1, 1)            # marker
        pb.put_bits(10, 0)           # vbv buffer size
        pb.put_bits(1, 0)            # constrained
        pb.put_bits(1, 0)            # no custom intra matrix
        pb.put_bits(1, 0)            # no custom inter matrix
        return b"\x00\x00\x01\xB3" + pb.flush()

    def _picture_header(self, pict_type, disp: int) -> bytes:
        pb = PutBits()
        pb.put_bits(10, disp % 1024)  # temporal_reference = display order
        pb.put_bits(3, pict_type)
        pb.put_bits(16, 0xFFFF)      # vbv_delay: variable
        if pict_type in (PICT_P, PICT_B):
            pb.put_bits(1, 0)        # full_pel_forward
            pb.put_bits(3, self.F_CODE)
        if pict_type == PICT_B:
            pb.put_bits(1, 0)        # full_pel_backward
            pb.put_bits(3, self.F_CODE)
        return b"\x00\x00\x01\x00" + pb.flush()

    def _slices(self, levels, mvs, intra, pict_type, qscale) -> bytes:
        out = bytearray()
        for mb_y in range(self.mb_h):
            pb = PutBits()
            pb.put_bits(5, self._qscale_code(int(qscale[mb_y * self.mb_w])))
            pb.put_bits(1, 0)        # extra_bit_slice
            self._slice_mbs(pb, mb_y, levels, mvs, intra, pict_type, qscale)
            # zero-pad to byte alignment: slice end is detected by the
            # >=23 zero bits of the next start code (ISO 11172-2 §2.3)
            pb.align(pad_bit=0)
            out += b"\x00\x00\x01" + bytes([1 + mb_y]) + pb.flush()
        return bytes(out)

    def _slice_mbs(self, pb, mb_y, levels, mvs, intra, pict_type, qscale):
        mw = self.mb_w
        dc_pred = [128, 128, 128]
        pmv = np.zeros(2, dtype=np.int32)
        pending_skip = 0
        cur_q = int(qscale[mb_y * mw])   # decoder mirror: slice header q
        for mb_x in range(mw):
            idx = mb_y * mw + mb_x
            lv = levels[idx]
            is_intra = bool(intra[idx])
            mv = mvs[idx]
            q = int(qscale[idx])
            cbp = 0
            for b in range(6):
                if np.any(lv[b][1:] if is_intra else lv[b]):
                    cbp |= 0x20 >> b
                if is_intra:
                    cbp |= 0x20 >> b     # intra blocks always coded
            # skip decision (P only, not first/last MB of slice)
            can_skip = (pict_type == PICT_P and not is_intra and cbp == 0
                        and mv[0] == 0 and mv[1] == 0
                        and 0 < mb_x < mw - 1)
            if can_skip:
                pending_skip += 1
                pmv[:] = 0
                dc_pred = [128, 128, 128]
                continue
            # address increment
            inc = pending_skip + 1
            pending_skip = 0
            while inc > 33:
                pb.put_bits(T.MB_ADDR_INC[1][T.MB_ADDR_ESCAPE],
                            T.MB_ADDR_INC[0][T.MB_ADDR_ESCAPE])
                inc -= 33
            pb.put_bits(T.MB_ADDR_INC[1][inc - 1], T.MB_ADDR_INC[0][inc - 1])

            # QUANT variants (tables B.2a/B.2b) re-anchor the decoder's
            # running qscale with an absolute 5-bit code; motion-only
            # MBs have no quant variant and no coefficients either
            want_q = q != cur_q
            if pict_type == PICT_I:
                if want_q:
                    pb.put_bits(2, 0b01)        # intra + quant
                    flags = T.MB_QUANT | T.MB_INTRA
                else:
                    pb.put_bits(1, 1)           # intra
                    flags = T.MB_INTRA
            else:
                if is_intra:
                    if want_q:
                        pb.put_bits(6, 0b000001)
                        flags = T.MB_QUANT | T.MB_INTRA
                    else:
                        pb.put_bits(5, 0b00011)     # MB_INTRA ptype code
                        flags = T.MB_INTRA
                elif cbp:
                    if want_q:
                        pb.put_bits(5, 0b00010)
                        flags = T.MB_QUANT | T.MB_FOR | T.MB_PAT
                    else:
                        pb.put_bits(1, 1)           # MB_FOR|MB_PAT
                        flags = T.MB_FOR | T.MB_PAT
                else:
                    pb.put_bits(3, 0b001)       # MB_FOR only
                    flags = T.MB_FOR
            if flags & T.MB_QUANT:
                pb.put_bits(5, self._qscale_code(q))
                cur_q = q
            if flags & T.MB_INTRA and pict_type == PICT_P:
                pmv[:] = 0
            if flags & T.MB_FOR:
                _encode_motion(pb, int(mv[0]) - int(pmv[0]), self.F_CODE)
                _encode_motion(pb, int(mv[1]) - int(pmv[1]), self.F_CODE)
                pmv[:] = mv
            if flags & T.MB_PAT:
                code, bits = T.MB_PAT_CODES[cbp]
                pb.put_bits(bits, code)
            if not (flags & T.MB_INTRA):
                dc_pred = [128, 128, 128]
            for b in range(6):
                if not (cbp & (0x20 >> b)):
                    continue
                if flags & T.MB_INTRA:
                    comp = 0 if b < 4 else (1 if b == 4 else 2)
                    dc = self._dc_for_pack(int(lv[b][0]))
                    _encode_dc(pb, dc - dc_pred[comp], lum=b < 4)
                    dc_pred[comp] = dc
                    _encode_block_ac(pb, lv[b], start=1, first_inter=False,
                                     mpeg2=self.QUANT_KIND == "mpeg2")
                else:
                    _encode_block_ac(pb, lv[b], start=0, first_inter=True,
                                     mpeg2=self.QUANT_KIND == "mpeg2")


def _slices_b_impl(self, levels, mvf, mvb, use_fwd, use_bwd, qscale):
    out = bytearray()
    for mb_y in range(self.mb_h):
        pb = PutBits()
        pb.put_bits(5, self._qscale_code(int(qscale[mb_y * self.mb_w])))
        pb.put_bits(1, 0)            # extra_bit_slice
        self._slice_mbs_b(pb, mb_y, levels, mvf, mvb, use_fwd, use_bwd)
        pb.align(pad_bit=0)
        out += b"\x00\x00\x01" + bytes([1 + mb_y]) + pb.flush()
    return bytes(out)


def _slice_mbs_b_impl(self, pb, mb_y, levels, mvf, mvb, use_fwd, use_bwd):
    """B-picture MB layer (table B.2c; reference: mpeg12enc.c
    mpeg1_encode_mb_internal B branches). Predictors persist across MBs
    and skips; a skipped B MB repeats the previous MB's direction flags
    and vectors (ISO 11172-2 §2.4.4.4)."""
    mw = self.mb_w
    bmap = _btype_encode_map()
    pmv = np.zeros((2, 2), dtype=np.int32)
    prev_flags = None
    pending_skip = 0
    for mb_x in range(mw):
        idx = mb_y * mw + mb_x
        lv = levels[idx]
        uf, ub = bool(use_fwd[idx]), bool(use_bwd[idx])
        flags = (T.MB_FOR if uf else 0) | (T.MB_BACK if ub else 0)
        cbp = 0
        for b in range(6):
            if np.any(lv[b]):
                cbp |= 0x20 >> b
        mv_match = ((not uf or tuple(mvf[idx]) == tuple(pmv[0])) and
                    (not ub or tuple(mvb[idx]) == tuple(pmv[1])))
        if (cbp == 0 and flags == prev_flags and mv_match and
                0 < mb_x < mw - 1):
            pending_skip += 1
            continue
        inc = pending_skip + 1
        pending_skip = 0
        while inc > 33:
            pb.put_bits(T.MB_ADDR_INC[1][T.MB_ADDR_ESCAPE],
                        T.MB_ADDR_INC[0][T.MB_ADDR_ESCAPE])
            inc -= 33
        pb.put_bits(T.MB_ADDR_INC[1][inc - 1], T.MB_ADDR_INC[0][inc - 1])

        if cbp:
            flags |= T.MB_PAT
        code, bits = bmap[flags]
        pb.put_bits(bits, code)
        if flags & T.MB_FOR:
            _encode_motion(pb, int(mvf[idx][0]) - int(pmv[0][0]),
                           self.F_CODE)
            _encode_motion(pb, int(mvf[idx][1]) - int(pmv[0][1]),
                           self.F_CODE)
            pmv[0] = mvf[idx]
        if flags & T.MB_BACK:
            _encode_motion(pb, int(mvb[idx][0]) - int(pmv[1][0]),
                           self.F_CODE)
            _encode_motion(pb, int(mvb[idx][1]) - int(pmv[1][1]),
                           self.F_CODE)
            pmv[1] = mvb[idx]
        if flags & T.MB_PAT:
            code, bits = T.MB_PAT_CODES[cbp]
            pb.put_bits(bits, code)
        for b in range(6):
            if cbp & (0x20 >> b):
                _encode_block_ac(pb, lv[b], start=0, first_inter=True,
                                 mpeg2=self.QUANT_KIND == "mpeg2")
        prev_flags = flags & (T.MB_FOR | T.MB_BACK)
    # pending_skip is always 0 here: the last MB of a slice is never
    # skipped (mb_x < mw - 1 in the skip condition)


@functools.lru_cache(maxsize=None)
def _btype_encode_map():
    """flags -> (code, bits) from table B.2c (no-quant variants)."""
    codes, lens, vals = T.MB_BTYPE
    return {v: (c, l) for c, l, v in zip(codes, lens, vals)
            if not (v & T.MB_QUANT)}


def _frame_rate_code(fr: Rational) -> int:
    best, bc = 1e9, 3
    for code in range(1, 9):
        n, d = T.FRAME_RATES[code]
        err = abs(float(fr) - n / d)
        if err < best:
            best, bc = err, code
    return bc


MPEG1Encoder._slices_b = _slices_b_impl
MPEG1Encoder._slice_mbs_b = _slice_mbs_b_impl


@register_codec
class MPEG2Encoder(MPEG1Encoder):
    """MPEG-2 main-profile encoder (reference: mpeg12enc.c MPEG-2 branches:
    sequence/picture-coding extensions, linear q_scale_type 0).

    fieldpic=1 emits FIELD PICTURES (picture_structure top/bottom): each
    input frame codes as two field pictures; P-field MBs cycle every
    field_motion_type (whole-field / 16x8 / dual prime) as a
    conformance-stream generator for the interlaced decode paths."""

    NAME = "mpeg2video"
    LONG_NAME = "MPEG-2 video (PyTorch ME/DCT/quant)"

    QUANT_KIND = "mpeg2"
    OPTIONS = MPEG1Encoder.OPTIONS + [
        Option("fieldpic", "code field pictures (1080i-style interlaced "
               "coding; I+P, cycles every field_motion_type)", "int",
               0, 0, 1),
        Option("fieldstress", "P-field motion-type mix: same, opp, "
               "whole, h16, dponly or full", "string", "full"),
    ]

    def _init(self):
        super()._init()
        # linear MPEG-2 qscale = 2 * code -> keep qscale even
        if self.qscale & 1:
            self.qscale += 1
        if self.fieldpic:
            if self.b_frames:
                raise AVError(EINVAL, "mpeg2video: fieldpic with "
                                      "b_frames not supported")
            if self.mb_h % 2:
                raise AVError(EINVAL, "mpeg2video: fieldpic needs "
                                      "height multiple of 32")
            self._recent_fields = {0: None, 1: None}

    def _encode(self, frame: Frame) -> List[Packet]:
        if not self.fieldpic:
            return super()._encode(frame)
        return [self._encode_field_frame(frame)]

    def _encode_field_frame(self, frame: Frame) -> Packet:
        """Two field pictures (top first) in one packet; the first field
        of a GOP-start frame is I, everything else P (13818-2 allows
        I+P frames)."""
        disp = self._disp_idx
        self._disp_idx += 1
        is_i = (disp % self.gop_size) == 0 or \
            self._recent_fields[0] is None
        y, u, v = self._padded_input(frame)
        mb_h_f = self.mb_h // 2
        nmb_f = self.mb_w * mb_h_f
        q = self.qscale
        qs = np.full(nmb_f, q, dtype=np.int32)
        qs_d = torch.as_tensor(qs).to(self.device)
        dev = self.device
        out = bytearray()
        out_first = True
        for parity in (0, 1):       # top field first
            # the fields as contiguous planes for the programs' reshapes
            fy, fu, fv = (p[parity::2].contiguous() for p in (y, u, v))
            # I frames code both fields intra: keeps the reference
            # decoder from synthesizing a dummy prior reference for an
            # I+P first frame, and matches common broadcast practice
            ftype = PICT_I if is_i else PICT_P
            if ftype == PICT_I:
                enc = encode(self.mb_w, mb_h_f, False, self.QUANT_KIND,
                             device=dev)
                zero = zero_pad_refs(self.mb_w, mb_h_f, device=dev)
                lv, mv_d, _ = enc(fy, fu, fv, qs_d, self._qi, self._qp,
                                  *zero)
                lv = lv.to(torch.int16)
                levels, mvs = self._download(lv, mv_d)
                modes = None
            else:
                zero = zero_pad_refs(self.mb_w, mb_h_f, device=dev)
                st = self._recent_fields[0] or zero
                sb = self._recent_fields[1] or zero
                # never reference a field that does not exist yet
                # (second field of the very first frame has only the
                # opposite-parity I field)
                pat = getattr(self, "fieldstress", "full")
                if self._recent_fields[parity] is None:
                    pat = "opp"
                elif self._recent_fields[1 - parity] is None:
                    pat = "same"
                fn = encode_field_stress(self.mb_w, mb_h_f, parity,
                                         pattern=pat, device=dev)
                mode_pat = fn.mode_pat
                lv, mv_d = fn(fy, fu, fv, qs_d, self._qp, *st, *sb)
                lv = lv.to(torch.int16)
                levels, mvs = self._download(lv, mv_d)
                modes = mode_pat
            # closed loop: reconstruct through the decoder's program
            recf = recon_field(self.mb_w, mb_h_f, False, ftype != PICT_I,
                               dual=modes is not None and
                               bool((modes == 3).any()), device=dev)
            kw = {}
            intra_f = (np.zeros(nmb_f, bool) if ftype != PICT_I
                       else np.ones(nmb_f, bool))
            mv2 = np.zeros((nmb_f, 2, 2), np.int32)
            self_sel = np.zeros((nmb_f, 2), np.int32)
            if ftype != PICT_I:
                mv2[:, 0] = mvs
                mv2[:, 1] = mvs
                pat = modes
                # selects mirror the packer: 0 same, 1 opposite,
                # 2 = upper same/lower opposite, 3 = dual prime
                same_sel = parity
                opp_sel = 1 - parity
                self_sel[:, 0] = np.where(pat == 1, opp_sel, same_sel)
                self_sel[:, 1] = np.where((pat == 1) | (pat == 2),
                                          opp_sel, same_sel)
                if bool((pat == 3).any()):
                    dp = pat == 3
                    dx = (mvs[:, 0] + (mvs[:, 0] > 0)) >> 1
                    dy = ((mvs[:, 1] + (mvs[:, 1] > 0)) >> 1) + \
                        (-1 if parity == 0 else 1)
                    mv_dp2 = np.zeros((nmb_f, 2, 2), np.int32)
                    mv_dp2[:, 0, 0] = mv_dp2[:, 1, 0] = dx
                    mv_dp2[:, 0, 1] = mv_dp2[:, 1, 1] = dy
                    sel_dp = np.full((nmb_f, 2), opp_sel, np.int32)
                    kw = dict(dp=dp, mv_dp2=mv_dp2, sel_dp=sel_dp)
            zf = zero_pad_refs(self.mb_w, mb_h_f, device=dev)
            st = self._recent_fields[0] or zf
            sb = self._recent_fields[1] or zf
            args = hwdevice.state_from_numpy(
                (intra_f, ~intra_f, np.zeros(nmb_f, bool), mv2, self_sel,
                 np.zeros((nmb_f, 2, 2), np.int32),
                 np.zeros((nmb_f, 2), np.int32), kw), dev)
            _, padded = recf(lv, qs_d, *args[:7], self._qi, self._qp,
                             *st, *sb, *zf, *zf, **args[7])
            self._recent_fields[parity] = padded
            if out_first:
                if ftype == PICT_I:
                    out += self._seq_header()
                out_first = False
            out += self._picture_header_field(ftype, disp, parity)
            out += self._slices_field(levels, mvs, intra_f if ftype ==
                                      PICT_I else np.zeros(nmb_f, bool),
                                      ftype, qs, modes, parity, mb_h_f)
        self._frame_idx += 1
        return Packet(data=bytes(out), pts=frame.pts, dts=frame.pts,
                      duration=1,
                      flags=PKT_FLAG_KEY if is_i else 0,
                      time_base=frame.time_base)

    def _picture_header_field(self, pict_type, disp: int,
                              parity: int) -> bytes:
        pb = PutBits()
        pb.put_bits(10, disp % 1024)
        pb.put_bits(3, pict_type)
        pb.put_bits(16, 0xFFFF)
        if pict_type in (PICT_P, PICT_B):
            pb.put_bits(1, 0)
            pb.put_bits(3, self.F_CODE)
        if pict_type == PICT_B:
            pb.put_bits(1, 0)
            pb.put_bits(3, self.F_CODE)
        out = b"\x00\x00\x01\x00" + pb.flush()
        pb = PutBits()
        pb.put_bits(4, 8)
        fc = self.F_CODE if pict_type in (PICT_P, PICT_B) else 15
        pb.put_bits(4, fc)
        pb.put_bits(4, fc)
        pb.put_bits(4, 15)
        pb.put_bits(4, 15)
        pb.put_bits(2, 0)        # intra_dc_precision
        pb.put_bits(2, 1 + parity)   # picture_structure: top/bottom
        pb.put_bits(1, 0)        # top_field_first
        pb.put_bits(1, 0)        # frame_pred_frame_dct
        pb.put_bits(1, 0)        # concealment
        pb.put_bits(1, 0)        # q_scale_type
        pb.put_bits(1, 0)        # intra_vlc_format
        pb.put_bits(1, 0)        # alternate_scan
        pb.put_bits(1, 0)        # repeat_first_field
        pb.put_bits(1, 1)        # chroma_420_type
        pb.put_bits(1, 0)        # progressive_frame
        pb.put_bits(1, 0)        # composite_display
        return out + b"\x00\x00\x01\xB5" + pb.flush()

    def _slices_field(self, levels, mvs, intra, pict_type, qscale,
                      modes, parity, mb_h_f) -> bytes:
        out = bytearray()
        for mb_y in range(mb_h_f):
            pb = PutBits()
            pb.put_bits(5, self._qscale_code(
                int(qscale[mb_y * self.mb_w])))
            pb.put_bits(1, 0)
            self._slice_mbs_field(pb, mb_y, levels, mvs, intra,
                                  pict_type, modes, parity)
            pb.align(pad_bit=0)
            out += b"\x00\x00\x01" + bytes([1 + mb_y]) + pb.flush()
        return bytes(out)

    def _slice_mbs_field(self, pb, mb_y, levels, mvs, intra, pict_type,
                         modes, parity):
        """Field-picture MB layer emission (13818-2 6.3.17.2):
        field_motion_type + motion_vertical_field_select per vector."""
        mw = self.mb_w
        dc_pred = [128, 128, 128]
        pmv = np.zeros((2, 2), dtype=np.int32)   # rows 0/1
        for mb_x in range(mw):
            idx = mb_y * mw + mb_x
            lv = levels[idx]
            is_intra = bool(intra[idx])
            cbp = 0
            for b in range(6):
                if np.any(lv[b][1:] if is_intra else lv[b]):
                    cbp |= 0x20 >> b
                if is_intra:
                    cbp |= 0x20 >> b
            pb.put_bits(T.MB_ADDR_INC[1][0], T.MB_ADDR_INC[0][0])
            if pict_type == PICT_I:
                pb.put_bits(1, 1)
                flags = T.MB_INTRA
            else:
                if cbp:
                    pb.put_bits(1, 1)
                    flags = T.MB_FOR | T.MB_PAT
                else:
                    pb.put_bits(3, 0b001)
                    flags = T.MB_FOR
            if flags & T.MB_FOR:
                mode = int(modes[idx])
                mv = mvs[idx]
                same_sel, opp_sel = parity, 1 - parity
                if mode == 0 or mode == 1:
                    pb.put_bits(2, 1)            # field_motion_type 01
                    pb.put_bits(1, same_sel if mode == 0 else opp_sel)
                    _encode_motion(pb, int(mv[0]) - int(pmv[0, 0]),
                                   self.F_CODE)
                    _encode_motion(pb, int(mv[1]) - int(pmv[0, 1]),
                                   self.F_CODE)
                    pmv[:, 0] = mv[0]
                    pmv[:, 1] = mv[1]
                elif mode == 2:
                    pb.put_bits(2, 2)            # 16x8
                    for j, s in ((0, same_sel), (1, opp_sel)):
                        pb.put_bits(1, s)
                        _encode_motion(pb, int(mv[0]) - int(pmv[j, 0]),
                                       self.F_CODE)
                        _encode_motion(pb, int(mv[1]) - int(pmv[j, 1]),
                                       self.F_CODE)
                        pmv[j] = mv
                else:
                    pb.put_bits(2, 3)            # dual prime
                    _encode_motion(pb, int(mv[0]) - int(pmv[0, 0]),
                                   self.F_CODE)
                    pb.put_bits(1, 0)            # dmvector[0] = 0
                    _encode_motion(pb, int(mv[1]) - int(pmv[0, 1]),
                                   self.F_CODE)
                    pb.put_bits(1, 0)            # dmvector[1] = 0
                    pmv[:, 0] = mv[0]
                    pmv[:, 1] = mv[1]
            if flags & T.MB_PAT:
                code, bits = T.MB_PAT_CODES[cbp]
                pb.put_bits(bits, code)
            if not (flags & T.MB_INTRA):
                dc_pred = [128, 128, 128]
            for b in range(6):
                if not (cbp & (0x20 >> b)):
                    continue
                if flags & T.MB_INTRA:
                    comp = 0 if b < 4 else (1 if b == 4 else 2)
                    dc = self._dc_for_pack(int(lv[b][0]))
                    _encode_dc(pb, dc - dc_pred[comp], lum=b < 4)
                    dc_pred[comp] = dc
                    _encode_block_ac(pb, lv[b], start=1,
                                     first_inter=False, mpeg2=True)
                else:
                    _encode_block_ac(pb, lv[b], start=0,
                                     first_inter=True, mpeg2=True)

    def _seq_header(self) -> bytes:
        out = super()._seq_header()
        # sequence extension (ISO 13818-2 §6.2.2.3)
        pb = PutBits()
        pb.put_bits(4, 1)        # extension id: sequence
        pb.put_bits(8, 0x48)     # profile_and_level: main@main
        pb.put_bits(1, 0 if getattr(self, "fieldpic", 0) else 1)
        pb.put_bits(2, 1)        # chroma_format 4:2:0
        pb.put_bits(2, 0)        # horizontal_size_extension
        pb.put_bits(2, 0)        # vertical_size_extension
        pb.put_bits(12, 0)       # bit_rate_extension
        pb.put_bits(1, 1)        # marker
        pb.put_bits(8, 0)        # vbv_buffer_size_extension
        pb.put_bits(1, 0)        # low_delay
        pb.put_bits(2, 0)        # frame_rate_extension_n
        pb.put_bits(5, 0)        # frame_rate_extension_d
        return out + b"\x00\x00\x01\xB5" + pb.flush()

    def _picture_header(self, pict_type, disp: int) -> bytes:
        out = super()._picture_header(pict_type, disp)
        # picture coding extension (ISO 13818-2 §6.2.3.1)
        pb = PutBits()
        pb.put_bits(4, 8)        # extension id: picture coding
        fc = self.F_CODE if pict_type in (PICT_P, PICT_B) else 15
        fcb = self.F_CODE if pict_type == PICT_B else 15
        pb.put_bits(4, fc)       # f_code[0][0]
        pb.put_bits(4, fc)       # f_code[0][1]
        pb.put_bits(4, fcb)      # f_code[1][0]
        pb.put_bits(4, fcb)      # f_code[1][1]
        pb.put_bits(2, 0)        # intra_dc_precision (8 bit)
        pb.put_bits(2, 3)        # picture_structure: frame
        pb.put_bits(1, 0)        # top_field_first
        pb.put_bits(1, 1)        # frame_pred_frame_dct
        pb.put_bits(1, 0)        # concealment_motion_vectors
        pb.put_bits(1, 0)        # q_scale_type: linear
        pb.put_bits(1, 0)        # intra_vlc_format
        pb.put_bits(1, 0)        # alternate_scan
        pb.put_bits(1, 0)        # repeat_first_field
        pb.put_bits(1, 1)        # chroma_420_type
        pb.put_bits(1, 1)        # progressive_frame
        pb.put_bits(1, 0)        # composite_display_flag
        return out + b"\x00\x00\x01\xB5" + pb.flush()

    def _qscale_code(self, q: int) -> int:
        return max(1, q >> 1)    # linear: qscale = 2*code

    def _dc_for_pack(self, dc: int) -> int:
        return dc >> 3           # levels carry pixel*8 (IDCT units)
