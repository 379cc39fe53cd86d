"""H.264 encoder (counterpart of `libav_tpu/codecs/h264/enc.py`;
reference role: there is no H.264 encoder in libav's tree either (x264 is
external) — this encoder exists to stress-validate the decoder without
FATE sample files, mirroring the FATE enc_dec strategy, and doubles as
the bench-content generator).

Emits: IDR/I (I_16x16 + optional I_4x4/I_8x8 with 8x8 transform), P
(16x16..4x4 partitions, P_Skip, multi-ref, weighted), B (L0/L1/Bi,
B_Skip/B_Direct spatial, implicit/explicit weighting), CAVLC or CABAC
entropy, in-loop deblocking with slice alpha/beta offsets, multi-slice
frames, PAFF field pictures (-fieldpic), MBAFF, poc types 0/1/2, scaling
matrices.

Device, on the encoder's torch device (`H264Encoder(params,
device="cuda")` by default; "cpu" runs the same programs on the CPU):
the intra wavefront programs and the P/B search + transform/quant
programs of codecs/h264/encdev.py, and the closed loop's reference
reconstruction through the decoder's own program (codecs/h264/device.py
ReconH264, and recon_h264_deblock when deblocking is on, whose frame
deblock is kernel K1, h264_deblock_frame, one launch per reference
picture). The input planes are padded to whole macroblocks on the
device and the reference planes (the DPB) stay there; the levels,
modes and vectors come to the host once per picture for the packer.

Host, the JAX package's code, copied and changed only in its imports and
where it reaches a device program: the options, GOP and B-frame
reordering, PAFF/MBAFF field coding, the MMCO long-term schedule, slice
headers, and the CAVLC and CABAC macroblock packing.
"""


from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.h264 import cavlc, nal as nal_mod, sets
from libav_tpu_torch.codecs.h264.dec import (GOLOMB_TO_INTER_CBP, _BLK_XY,
                                             FrameData, SLICE_B, SLICE_I,
                                             SLICE_P)
from libav_tpu_torch.codecs.h264.device import (_BLK_XY as _BLK_XY_DEV,
                                                recon_h264,
                                                recon_h264_deblock,
                                                zero_refs_h264)
from libav_tpu_torch.codecs.h264.encdev import (encode_b, encode_i4,
                                                encode_i8, encode_i16,
                                                encode_p)
from libav_tpu_torch.codecs.h264 import part


class _UniformPlan:
    """16x16 per-MB coding plan for the shared inter walk."""

    def __init__(self, mv0, mv1=None, ref0=0, ref1=0):
        self.m = (mv0, mv1)
        self.r = (ref0, ref1)
        self.subs = None

    def mv(self, lst, bx, by):
        m = self.m[lst]
        return (int(m[0]), int(m[1]))

    def ref(self, lst, bx, by):
        return self.r[lst]


class _JitterPlan(_UniformPlan):
    """Stress-mode plan: the base MV plus a small deterministic offset
    per covered block position, so every partition of the MB carries a
    distinct motion vector (exercises per-block MC, mvd coding, and
    partition MV prediction end to end)."""

    def __init__(self, mv0, mv1=None, ref0=0, ref1=0, subs=None, seed=0,
                 nref0=1):
        super().__init__(mv0, mv1, ref0, ref1)
        self.subs = subs
        self.seed = seed
        self.nref0 = nref0

    def mv(self, lst, bx, by):
        m = self.m[lst]
        ox = ((bx & 3) * 2 + (by & 3) + self.seed) % 5 - 2
        oy = ((bx & 3) + (by & 3) * 2 + self.seed + lst) % 5 - 2
        return (int(m[0]) + ox, int(m[1]) + oy)

    def ref(self, lst, bx, by):
        if lst == 0 and self.nref0 > 1:
            return (((bx >> 1) & 1) + ((by >> 1) & 1) + self.seed) \
                % self.nref0
        return self.r[lst]


def _stress_p(i, fd, nref0):
    """Cycle P partition shapes per MB (conformance-stream generator).
    Returns (mb_type, plan)."""
    r = i % 6
    base = fd.mv[i]
    if r == 0 or r == 3:
        return 0, _UniformPlan(base, ref0=int(fd.ref_idx[i]))
    if r == 1:
        return 1, _JitterPlan(base, seed=i, nref0=nref0)        # 16x8
    if r == 2:
        return 2, _JitterPlan(base, seed=i, nref0=nref0)        # 8x16
    subs = [(i + q) % 4 for q in range(4)]                      # P_8x8
    return 3, _JitterPlan(base, subs=subs, seed=i, nref0=nref0)


def _stress_b(i, fd):
    """Cycle B mb_types incl. direct, two-partition shapes with every
    list combination, and B_8x8 with direct/L0/L1/Bi subs.
    Returns (mb_type, plan)."""
    r = i % 9
    sel = int(fd.sel[i])
    base0, base1 = fd.mv[i], fd.mv1[i]
    if r == 0:
        return 0, _UniformPlan(base0, base1)                    # direct
    if r in (1, 2, 3):
        return 1 + sel, _UniformPlan(base0, base1)
    if r == 4:
        return 4, _JitterPlan(base0, base1, seed=i)    # 16x8 L0,L0
    if r == 5:
        return 9, _JitterPlan(base0, base1, seed=i)    # 8x16 L0,L1
    if r == 6:
        return 20, _JitterPlan(base0, base1, seed=i)   # 16x8 Bi,Bi
    if r == 7:
        subs = [0, 1, 2, 3]                            # direct/L0/L1/Bi
        return 22, _JitterPlan(base0, base1, subs=subs, seed=i)
    subs = [4 + (i + q) % 9 for q in range(4)]         # 8x4..4x4 shapes
    return 22, _JitterPlan(base0, base1, subs=subs, seed=i)


class _CavlcWriter:
    """Encoder-side rd for part.code_inter_mb over a PutBits stream."""

    def __init__(self, pb, plan):
        self.pb = pb
        self.plan = plan
        self._q = 0

    def _sub(self):
        v = self.plan.subs[self._q]
        self._q += 1
        self.pb.put_ue_golomb(v)
        return v

    sub_mb_type_p = _sub
    sub_mb_type_b = _sub

    def ref_idx(self, lst, bx, by, nref):
        v = self.plan.ref(lst, bx, by)
        if nref == 2:
            self.pb.put_bits(1, 1 - v)           # te(v)
        else:
            self.pb.put_ue_golomb(v)
        return v

    def motion(self, lst, bx, by, pred):
        mv = self.plan.mv(lst, bx, by)
        mvd = (mv[0] - pred[0], mv[1] - pred[1])
        self.pb.put_se_golomb(mvd[0])
        self.pb.put_se_golomb(mvd[1])
        return mv, mvd


class _CabacWriter:
    """Encoder-side rd for part.code_inter_mb over a CabacMbLayer."""

    def __init__(self, layer, plan):
        self.layer = layer
        self.plan = plan
        self._q = 0

    def sub_mb_type_p(self):
        v = self.plan.subs[self._q]
        self._q += 1
        self.layer.sub_mb_type_p(v)
        return v

    def sub_mb_type_b(self):
        v = self.plan.subs[self._q]
        self._q += 1
        self.layer.sub_mb_type_b(v)
        return v

    def ref_idx(self, lst, bx, by, nref):
        v = self.plan.ref(lst, bx, by)
        self.layer.ref_idx(lst, bx, by, nref, value=v)
        return v

    def motion(self, lst, bx, by, pred):
        mv = self.plan.mv(lst, bx, by)
        mvd = (mv[0] - pred[0], mv[1] - pred[1])
        self.layer.mvd(lst, bx, by, 0, value=mvd[0])
        self.layer.mvd(lst, bx, by, 1, value=mvd[1])
        return mv, mvd

_INTER_CBP_TO_GOLOMB = {cbp: i for i, cbp in enumerate(GOLOMB_TO_INTER_CBP)}
from libav_tpu_torch.codecs.h264.dec import GOLOMB_TO_INTRA_CBP, pred_i4_mode
_INTRA_CBP_TO_GOLOMB = {cbp: i for i, cbp in enumerate(GOLOMB_TO_INTRA_CBP)}


@register_codec
class H264Encoder(Encoder):
    NAME = "h264"
    TYPE = MediaType.VIDEO
    LONG_NAME = "H.264/AVC (PyTorch wavefront encode)"

    OPTIONS = Encoder.OPTIONS + [
        Option("qp", "fixed QP 0-51", "int", 28, 0, 51),
        Option("qscale", "qscale alias (maps 1-31 -> qp)", "int", 0, 0, 31),
        Option("gop_size", "GOP length", "int", 12, 1, 600),
        Option("deblock", "apply in-loop deblocking (closed loop)",
               "int", 0, 0, 1),
        Option("refs", "number of reference frames (L0)", "int", 1, 1, 2),
        Option("entropy", "entropy coder: cavlc or cabac", "string",
               "cavlc"),
        Option("i4x4", "code I frames as I_4x4 with per-block mode "
               "decision", "int", 0, 0, 1),
        Option("b_frames", "max B frames between references", "int",
               0, 0, 2),
        Option("slices", "slices per frame (CABAC only; parallel "
               "entropy)", "int", 1, 1, 8),
        Option("weightp", "explicit weighted prediction for P slices "
               "(pred_weight_table)", "int", 0, 0, 1),
        Option("weightb", "B weighted prediction: off, explicit or "
               "implicit", "string", "off"),
        Option("parts", "partition mode: off or all (cycle every "
               "16x8/8x16/8x8 partition and sub-partition shape, plus "
               "B direct/skip — conformance-stream generator)",
               "string", "off"),
        Option("i8x8", "code I frames as I_8x8 (High profile 8x8 "
               "transform + filtered-edge prediction; CABAC)", "int",
               0, 0, 1),
        Option("dct8x8", "8x8 transform for P luma residuals "
               "(transform_size_8x8_flag, alternating per MB; CABAC)",
               "int", 0, 0, 1),
        Option("scmatrix", "scaling matrices in the SPS: off, default "
               "(JVT lists) — signalling-level conformance feature; the "
               "encoder's own quant stays flat", "string", "off"),
        Option("cqpo", "chroma_qp_index_offset", "int", 0, -12, 12),
        Option("cqpo2", "second_chroma_qp_index_offset (-99 = same as "
               "cqpo)", "int", -99, -99, 12),
        Option("direct", "B direct prediction mode signalled in slice "
               "headers: spatial or temporal (8.4.1.2.3)", "string",
               "spatial"),
        Option("ipcm", "emit every Nth I-frame MB as I_PCM carrying its "
               "own reconstruction (0 = off) — conformance stress for "
               "raw-sample macroblocks", "int", 0, 0, 16),
        Option("poc", "pic_order_cnt_type in the SPS: -1 auto (0 with "
               "B frames, 2 otherwise), 0 lsb-coded, 1 ref-frame offset "
               "cycle (8.2.1.2), 2 decode-order (P-only)", "int",
               -1, -1, 2),
        Option("mmco", "long-term reference stress: IDR long_term flag, "
               "MMCO 1/2/3/4/6 marking schedule and long-term list "
               "reordering across each GOP (P-only)", "int", 0, 0, 1),
        Option("fgap", "advance frame_num by 1+N per reference frame "
               "with gaps_in_frame_num_value_allowed set — decoders "
               "must insert non-existing frames (8.2.5.2)", "int",
               0, 0, 8),
        Option("fieldpic", "PAFF interlaced coding: each frame as two "
               "field pictures (field_pic_flag=1, top then bottom), "
               "per-parity prediction chains", "int", 0, 0, 1),
        Option("fieldref", "PAFF P-field reference policy: same "
               "(same-parity chains) or pair (1-frame window: bottom "
               "fields reference the same frame's top field -> "
               "cross-parity chroma offset stress)", "string", "same"),
        Option("mbaff", "MBAFF interlaced coding: frame pictures of "
               "MB pairs, every pair field-coded (mb_adaptive_frame_"
               "field_flag=1, mb_field_decoding_flag=1); I and P "
               "frames (per-parity field P prediction)", "int", 0, 0, 1),
    ]
    CAPABILITIES = ("delay",)
    DEVICE_PART = True

    def __init__(self, params=None, options=None, *, device="cuda"):
        """H264Encoder(params, options, device=...): the device programs
        run on `device`; frames may hold numpy arrays or tensors."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)
        # the closed loop's reconstruction programs, taking host state
        self._recon = hwdevice.program_factory(recon_h264, self.device)
        self._recon_deblock = hwdevice.program_factory(recon_h264_deblock,
                                                       self.device)

    def _zero_refs(self):
        return zero_refs_h264(self.mb_w, self.mb_h, device=self.device)

    def _plane(self, p) -> torch.Tensor:
        """A plane (numpy or tensor) as a tensor on the device."""
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(np.ascontiguousarray(p))
        return p.to(self.device)

    @staticmethod
    def _download(*tensors):
        """Device tensors -> host numpy arrays, for the packer."""
        return tuple(t.cpu().numpy() for t in tensors)

    def _init(self):
        if self.width <= 0 or self.height <= 0:
            raise AVError(EINVAL, "h264: width/height required")
        if self.qscale:
            self.qp = min(51, 12 + self.qscale)
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        if self.fieldpic:
            # PAFF: the whole MB pipeline runs on HALF-height fields;
            # the SPS carries the frame geometry (frame_mbs_only=0)
            if self.width % 16 or self.height % 32:
                raise AVError(EINVAL, "h264: fieldpic needs width%16==0 "
                                      "and height%32==0")
            if self.b_frames or self.mmco or self.fgap or \
                    self.refs > 1 or self.parts != "off" or \
                    self.weightp or self.slices > 1 or \
                    self.i8x8 or self.dct8x8:
                raise AVError(EINVAL, "h264: fieldpic combines only "
                              "with cavlc/cabac i4x4/deblock here")
            self._field_refs = [None, None]
            self._cur_parity = 0
        if self.mbaff:
            # MBAFF all-field: the MB pipeline codes per-parity FIELDS
            # (like fieldpic) but the pack layer interleaves them as MB
            # pairs of one frame picture
            if self.width % 16 or self.height % 32:
                raise AVError(EINVAL, "h264: mbaff needs width%16==0 "
                                      "and height%32==0")
            if self.fieldpic or self.b_frames or self.mmco or \
                    self.fgap or self.refs > 1 or self.parts != "off" or \
                    self.weightp or self.slices > 1 or self.i8x8 or \
                    self.dct8x8 or self.ipcm or self.deblock:
                raise AVError(EINVAL, "h264: mbaff combines only with "
                              "cavlc/cabac i4x4 + P frames here "
                              "(no deblock)")
            self._field_refs = [None, None]
            self._cur_parity = 0
        crop_r = (self.mb_w * 16 - self.width) // 2
        crop_b = (self.mb_h * 16 - self.height) // 2
        if self.fieldpic or self.mbaff:
            self.mb_h //= 2    # the MB pipeline codes one field
        if (self.mb_w * 16 - self.width) % 2 or \
                (self.mb_h * 16 - self.height) % 2:
            # crop units are 2 luma pixels in 4:2:0; require even sizes
            raise AVError(EINVAL, "h264: width/height must be even")
        if self.entropy not in ("cavlc", "cabac"):
            raise AVError(EINVAL, f"h264: unknown entropy {self.entropy}")
        self.cabac = self.entropy == "cabac"
        interlaced = self.fieldpic or self.mbaff
        self.sps = sets.SPS(mb_width=self.mb_w,
                            mb_height=(2 * self.mb_h if interlaced
                                       else self.mb_h),
                            frame_mbs_only=0 if interlaced else 1,
                            mb_aff=1 if self.mbaff else 0,
                            crop=(0, crop_r, 0, crop_b))
        if self.cabac:
            self.sps.profile_idc = 77          # main (CABAC needs >= main)
        self.pps = sets.PPS()
        self.pps.entropy_coding_mode = 1 if self.cabac else 0
        self.pps.pic_init_qp = self.qp
        if self.weightb not in ("off", "explicit", "implicit"):
            raise AVError(EINVAL, f"h264: bad weightb {self.weightb}")
        self.pps.weighted_pred = 1 if self.weightp else 0
        self.pps.weighted_bipred_idc = {"off": 0, "explicit": 1,
                                        "implicit": 2}[self.weightb]
        self.t8 = bool(self.dct8x8 or self.i8x8)
        if self.t8 and not self.cabac:
            raise AVError(EINVAL, "h264: 8x8 transform requires "
                                  "-entropy cabac here")
        if self.t8 and self.parts == "all":
            raise AVError(EINVAL, "h264: dct8x8 with parts=all not "
                                  "supported (sub-8x8 partitions forbid "
                                  "the 8x8 transform)")
        if self.direct not in ("spatial", "temporal"):
            raise AVError(EINVAL, f"h264: bad direct {self.direct}")
        if self.ipcm and (self.i4x4 or self.i8x8):
            raise AVError(EINVAL, "h264: ipcm stress requires the "
                                  "I_16x16 intra path (no -i4x4/-i8x8)")
        if self.scmatrix not in ("off", "default"):
            raise AVError(EINVAL, f"h264: bad scmatrix {self.scmatrix}")
        if self.t8 or self.scmatrix != "off":
            self.sps.profile_idc = 100           # High
        self.pps.transform_8x8_mode = 1 if self.t8 else 0
        if self.scmatrix == "default":
            self.sps.scaling_m4 = (
                [sets.DEFAULT_4x4[0].copy() for _ in range(3)] +
                [sets.DEFAULT_4x4[1].copy() for _ in range(3)])
            self.sps.scaling_m8 = [sets.DEFAULT_8x8[0].copy(),
                                   sets.DEFAULT_8x8[1].copy()]
        self.pps.chroma_qp_index_offset = self.cqpo
        if self.cqpo2 != -99:
            self.pps.second_chroma_qp_index_offset = self.cqpo2
        elif self.cqpo:
            self.pps.second_chroma_qp_index_offset = self.cqpo
        self._frame_idx = 0     # display index of next input frame
        self._fn = 0            # frame_num (increments on refs only)
        self._idr_disp = 0      # display idx of the last IDR (POC base)
        self._pending = []      # buffered display frames (B reordering)
        self._pts_seq = []      # display pts for delayed-dts mapping
        self._coded_idx = 0
        self._prev_anchor = None
        self._refs = None       # newest padded recon (DPB head)
        self._dpb = []          # padded recon refs, newest first
        self._idr_id = 0
        self._cur_cdy = 0
        self.sps.max_num_ref_frames = self.refs
        if self.fieldpic:
            # both fields of the previous frame must survive the sliding
            # window while the current frame's fields decode, or the
            # bottom field is left with only cross-parity references
            # (which is exactly what fieldref=pair stresses)
            self.sps.max_num_ref_frames = \
                1 if self.fieldref == "pair" else 2
        if self.refs > 1 and self.deblock:
            raise AVError(EINVAL, "h264: refs>1 with deblock not "
                                  "supported yet (round 2)")
        if self.fgap:
            if self.b_frames or self.refs > 1 or self.mmco:
                raise AVError(EINVAL, "h264: -fgap requires single-ref "
                                      "P-only coding without -mmco")
            self.sps.gaps_allowed = 1
        if self.mmco:
            if self.b_frames or self.deblock or self.refs > 1:
                raise AVError(EINVAL, "h264: -mmco stress requires no "
                                      "-bf/-deblock/-refs")
            # 2 short-term + 1 long-term resident (8.2.5.3 exempts
            # long-term pictures from the sliding window)
            self.sps.max_num_ref_frames = 3
            self._ltmodel = []
        if self.poc in (1, 2) and self.b_frames:
            raise AVError(EINVAL, "h264: poc_type 1/2 requires decode "
                                  "order == display order (no -bf)")
        if self.poc == 0:
            self.sps.poc_type = 0
            self.sps.log2_max_poc_lsb = 8
        elif self.poc == 1:
            # one-entry ref cycle of +2: expectedPicOrderCnt == 2*n for
            # the P-only chain, slice deltas emitted as 0 (8.2.1.2)
            self.sps.poc_type = 1
            self.sps.delta_pic_order_always_zero = 0
            self.sps.offset_for_ref_frame = (2,)
        elif self.poc == 2:
            self.sps.poc_type = 2
        if self.b_frames:
            if self.refs > 1:
                raise AVError(EINVAL, "h264: b_frames with refs>1 "
                                      "not supported yet")
            self.sps.poc_type = 0    # display order != decode order
            self.sps.log2_max_poc_lsb = 8
            # the decoder's sliding window must retain BOTH anchors so
            # the B lists are {past}, {future} (1 active ref per list)
            self.sps.max_num_ref_frames = 2

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        """Frame reordering driver (anchor-first coding of B runs,
        reference role: mpegvideo_enc.c select_input_picture; x264-style
        closed GOPs — a run never spans an IDR)."""
        disp = self._frame_idx
        self._frame_idx += 1
        self._pts_seq.append(frame.pts if frame.pts is not None else disp)
        if self.fieldpic:
            is_i = (disp % self.gop_size) == 0 or \
                self._field_refs[0] is None
            return self._code_fields(frame, disp, is_i)
        if self.mbaff:
            is_i = (disp % self.gop_size) == 0 or \
                self._field_refs[0] is None
            return self._code_mbaff(frame, disp, is_i)
        is_i = (disp % self.gop_size) == 0 or self._refs is None
        if not is_i and self.b_frames and \
                len(self._pending) < self.b_frames and \
                (disp + 1) % self.gop_size != 0:
            self._pending.append((frame, disp))
            return []
        pkts = [self._code_anchor(frame, disp, is_i)]
        l1 = self._refs
        for bf, bd in self._pending:
            pkts.append(self._code_b(bf, bd, self._b_l0, l1))
        self._pending = []
        return pkts

    def _drain(self) -> List[Packet]:
        if not self._pending:
            return []
        last_f, last_d = self._pending[-1]
        rest = self._pending[:-1]
        self._pending = []
        pkts = [self._code_anchor(last_f, last_d, False)]
        l1 = self._refs
        for bf, bd in rest:
            pkts.append(self._code_b(bf, bd, self._b_l0, l1))
        return pkts

    def _code_fields(self, frame: Frame, disp: int,
                     is_i: bool) -> List[Packet]:
        """PAFF: the frame codes as two field pictures (top first),
        each predicting from the previous same-parity field (default
        P-field list0[0], spec 8.2.4.2.5). frame_num advances once per
        frame; POC = 2*n (top) / 2*n+1 (bottom)."""
        from libav_tpu_torch.avutil.frame import Frame as AVFrame
        pkts = []
        planes = [self._plane(p) for p in frame.planes]
        pts = frame.pts if frame.pts is not None else disp
        if is_i:
            self._idr_disp = disp
        for par in (0, 1):
            ff = AVFrame(width=frame.width, height=frame.height // 2,
                         format="yuv420p")
            ff.planes = [p[par::2] for p in planes]
            y, u, v = self._padded_input(ff)
            self._cur_parity = par
            self._poc = 2 * (disp - self._idr_disp) + par
            cdy = 0
            if self.fieldref == "pair" and par == 1:
                # cross-parity: the bottom field predicts from the just
                # coded top field of the SAME frame (spec 8.4.1.4.1
                # chroma my += 2 for bottom-from-top)
                self._refs = self._field_refs[0]
                cdy = 2
            else:
                self._refs = self._field_refs[par]
            self._cur_cdy = cdy
            self._dpb = [self._refs] if self._refs is not None else []
            adv = par == 1           # frame_num advances per FRAME
            if is_i:
                if self.i8x8:
                    fn = encode_i8(self.mb_w, self.mb_h, self.qp,
                                   device=self.device)
                    outs, recon = fn(y, u, v)
                    data = self._pack_i8(outs, recon, idr=par == 0,
                                         advance=adv)
                elif self.i4x4:
                    fn = encode_i4(self.mb_w, self.mb_h, self.qp,
                                   device=self.device)
                    outs, recon = fn(y, u, v)
                    data = self._pack_i4(outs, recon, idr=par == 0,
                                         advance=adv)
                else:
                    fn = encode_i16(self.mb_w, self.mb_h, self.qp,
                                    device=self.device)
                    outs, recon = fn(y, u, v)
                    data = self._pack_i(outs, recon, idr=par == 0,
                                        advance=adv)
            else:
                fn = encode_p(self.mb_w, self.mb_h, self.qp, nrefs=1,
                              cdy=cdy, device=self.device)
                data = self._pack_p(*self._download(*fn(y, u, v,
                                                        *self._refs)),
                                    1, advance=adv)
            self._field_refs[par] = self._refs   # closed-loop recon
            pkts.append(Packet(
                data=data, pts=pts, dts=self._next_dts(pts), duration=1,
                flags=PKT_FLAG_KEY if is_i and par == 0 else 0,
                time_base=frame.time_base))
        return pkts

    def _stack_mbaff_fd(self, top: FrameData, bot: FrameData) -> FrameData:
        """Concatenate two per-field FrameDatas into the STACKED layout
        (virtual MB rows 0..H/2-1 = top field image, H/2.. = bottom):
        the MBAFF pair walk interleaves them while every neighbor
        derivation sees two independent field images — the uniform-
        field 6.4.4 topology."""
        mb_w, fh = self.mb_w, self.mb_h       # pipeline = field dims
        n2 = fh * mb_w
        full = FrameData(2 * n2, mb_w, 2 * fh)
        for name, v in list(vars(top).items()):
            w = getattr(bot, name, None)
            if (isinstance(v, np.ndarray) and isinstance(w, np.ndarray)
                    and v.shape == w.shape and v.ndim >= 1
                    and v.shape[0] in (n2, 4 * fh, 2 * fh)):
                setattr(full, name, np.concatenate([v, w], axis=0))
        full.mbaff_field = True
        return full

    def _code_mbaff(self, frame: Frame, disp: int,
                    is_i: bool) -> List[Packet]:
        """MBAFF all-field frame picture: both parities run the normal
        field pipeline (intra or P, each parity predicting from its own
        previous same-parity field — MbaffRefPicList index 0), the pack
        layer interleaves them as MB pairs of ONE frame-coded picture
        (mb_field_decoding_flag = 1 on every pair)."""
        from libav_tpu_torch.avutil.frame import Frame as AVFrame
        from libav_tpu_torch.codecs.h264.cavlc import ZZ_FROM_FIELD
        planes = [self._plane(p) for p in frame.planes]
        pts = frame.pts if frame.pts is not None else disp
        if is_i:
            self._idr_disp = disp
            self._poc = 0
        else:
            self._poc = 2 * (disp - self._idr_disp)
        fds = []
        for par in (0, 1):
            ff = AVFrame(width=frame.width, height=frame.height // 2,
                         format="yuv420p")
            ff.planes = [p[par::2] for p in planes]
            y, u, v = self._padded_input(ff)
            if is_i:
                if self.i4x4:
                    fn = encode_i4(self.mb_w, self.mb_h, self.qp,
                                   device=self.device)
                    outs, recon = fn(y, u, v)
                    fdp = self._pack_i4(outs, recon, build_only=True)
                else:
                    fn = encode_i16(self.mb_w, self.mb_h, self.qp,
                                    device=self.device)
                    outs, recon = fn(y, u, v)
                    fdp = self._pack_i(outs, recon, build_only=True)
            else:
                fn = encode_p(self.mb_w, self.mb_h, self.qp, nrefs=1,
                              device=self.device)
                fdp = self._pack_p(*self._download(*fn(
                    y, u, v, *self._field_refs[par])), 1, build_only=True)
            # closed-loop per-parity reference (decoder-replica recon;
            # _update_ref_from_levels expects zigzag coefficient order)
            import copy as _copy
            f2 = _copy.copy(fdp)
            f2.luma_dc = fdp.luma_dc[..., ZZ_FROM_FIELD]
            f2.luma_ac = fdp.luma_ac[..., ZZ_FROM_FIELD]
            f2.chroma_ac = fdp.chroma_ac[..., ZZ_FROM_FIELD]
            self._refs = self._field_refs[par]
            self._dpb = [self._refs] if self._refs is not None else []
            self._update_ref_from_levels(f2)
            self._field_refs[par] = self._refs
            fds.append(fdp)
        fd = self._stack_mbaff_fd(fds[0], fds[1])
        out = bytearray()
        if is_i:
            out += nal_mod.make_nal(nal_mod.NAL_SPS,
                                    sets.write_sps(self.sps))
            out += nal_mod.make_nal(nal_mod.NAL_PPS,
                                    sets.write_pps(self.pps))
        # emission runs on the stacked full-height geometry
        field_h = self.mb_h
        self.mb_h = 2 * field_h
        try:
            if is_i:
                out += self._emit_slices(fd, SLICE_I, True, 1,
                                         nal_mod.NAL_IDR)
            else:
                out += self._emit_slices(fd, SLICE_P, False, 1,
                                         nal_mod.NAL_SLICE)
        finally:
            self.mb_h = field_h
        if is_i:
            self._idr_id += 1
        self._dpb = []
        return [Packet(data=bytes(out), pts=pts,
                       dts=self._next_dts(pts), duration=1,
                       flags=PKT_FLAG_KEY if is_i else 0,
                       time_base=frame.time_base)]

    def _code_anchor(self, frame: Frame, disp: int, is_i: bool) -> Packet:
        self._b_l0 = self._refs          # forward ref for the B run
        y, u, v = self._padded_input(frame)
        if is_i:
            self._idr_disp = disp
            self._poc = 0
            if self.mmco:
                self._idr_lt_flag = True     # IDR becomes LT idx 0
                self._mmco_ops = None
                self._reorder_l0 = None
                self._mmco_nrefs = 0
            rt = None
            if self.cabac and self.slices > 1:
                # intra prediction must not cross slice boundaries
                rt = np.ones(self.mb_h, dtype=bool)
                rt[0] = False
                for k in range(1, self.slices):
                    rt[self.mb_h * k // self.slices] = False
                rt = torch.as_tensor(rt).to(self.device)
            if self.i8x8:
                fn = encode_i8(self.mb_w, self.mb_h, self.qp,
                               device=self.device)
                outs, recon = fn(y, u, v, row_top=rt)
                data = self._pack_i8(outs, recon)
            elif self.i4x4:
                fn = encode_i4(self.mb_w, self.mb_h, self.qp,
                               device=self.device)
                outs, recon = fn(y, u, v, row_top=rt)
                data = self._pack_i4(outs, recon)
            else:
                fn = encode_i16(self.mb_w, self.mb_h, self.qp,
                                device=self.device)
                outs, recon = fn(y, u, v, row_top=rt)
                data = self._pack_i(outs, recon)
        else:
            self._poc = 2 * (disp - self._idr_disp)
            mark_lt = None
            if self.mmco:
                mark_lt = self._mmco_schedule()
            nrefs = min(self.refs, len(self._dpb)) or 1
            if self.mmco:
                nrefs = self._mmco_nrefs
            fn = encode_p(self.mb_w, self.mb_h, self.qp, nrefs=nrefs,
                          dct8=bool(self.dct8x8), device=self.device)
            if nrefs > 1:
                refs = tuple(torch.stack([d[k] for d in self._dpb[:nrefs]])
                             for k in range(3))
            else:
                refs = self._refs
            if self.dct8x8:
                (mv, luma_lv, udc, uac, vdc, vac, ridx,
                 lv8) = self._download(*fn(y, u, v, *refs))
            else:
                mv, luma_lv, udc, uac, vdc, vac, ridx = self._download(
                    *fn(y, u, v, *refs))
                lv8 = None
            data = self._pack_p(mv, luma_lv, udc, uac, vdc, vac, ridx,
                                nrefs, lv8=lv8)
            if self.mmco:
                self._mmco_update_model(mark_lt)
        if is_i and self.mmco:
            # the freshly reconstructed IDR is the resident long-term
            self._ltmodel = [{"planes": self._refs, "fn": 0, "lt": 0}]
        pts = frame.pts if frame.pts is not None else disp
        pkt = Packet(data=data, pts=pts, dts=self._next_dts(pts),
                     duration=1,
                     flags=PKT_FLAG_KEY if is_i else 0,
                     time_base=frame.time_base)
        return pkt

    def _mmco_schedule(self):
        """Per-P marking/reorder schedule over the long-term model
        (cycles through MMCO 1/2/3/4/6 + long-term list reordering).
        Sets _mmco_ops/_reorder_l0/_dpb/_mmco_nrefs; returns the
        LongTermFrameIdx the CURRENT picture takes (MMCO 6) or None."""
        cur_fn = self._fn
        q = cur_fn if cur_fn <= 6 else (cur_fn - 1) % 6 + 1
        self._cur_fn = cur_fn
        shorts = [e for e in self._ltmodel if e["lt"] is None]
        longs = sorted((e for e in self._ltmodel if e["lt"] is not None),
                       key=lambda e: e["lt"])
        list0 = shorts + longs
        self._reorder_l0 = None
        if q == 4 and any(e["lt"] == 0 for e in longs):
            # ref_pic_list_modification idc 2: long-term pic to index 0
            self._reorder_l0 = [(2, 0)]
            tgt = next(e for e in longs if e["lt"] == 0)
            list0 = [tgt] + [e for e in list0 if e is not tgt]
        ops, mark_lt = [], None
        if q == 2 and shorts:
            ops = [(3, 0, 1)]            # newest short -> LT idx 1
            if len(shorts) >= 2:
                # keep the count within max_num_ref_frames: with
                # adaptive marking there is NO sliding window (8.2.5.3)
                d = cur_fn - shorts[-1]["fn"] - 1
                ops.insert(0, (1, d))
        elif q == 3:
            ops = [(2, 1), (4, 1)]       # unmark LT 1; max idx 0
        elif q == 4:
            ops = [(6, 1)]               # current picture -> LT idx 1
            mark_lt = 1
            if len(shorts) >= 2:
                # free a slot: unmark the oldest short-term
                d = cur_fn - shorts[-1]["fn"] - 1
                ops.insert(0, (1, d))
        elif q == 6:
            ops = [(2, 1)]
        self._mmco_ops = ops or None
        self._mmco_nrefs = min(2, len(list0)) or 1
        self._dpb = [e["planes"] for e in list0]
        self._mmco_list0 = list0
        return mark_lt

    def _mmco_update_model(self, mark_lt):
        """Mirror the decoder's marking for the frame just coded
        (8.2.5.3/8.2.5.4), then insert its reconstruction."""
        cur_fn = self._cur_fn
        m = self._ltmodel
        for op in (self._mmco_ops or ()):
            if op[0] == 1:
                fnx = cur_fn - op[1] - 1
                m = [e for e in m if e["lt"] is not None
                     or e["fn"] != fnx]
            elif op[0] == 2:
                m = [e for e in m if e["lt"] != op[1]]
            elif op[0] == 3:
                fnx = cur_fn - op[1] - 1
                for e in m:
                    if e["lt"] is None and e["fn"] == fnx:
                        m = [x for x in m if x["lt"] != op[2]]
                        e["lt"] = op[2]
                        break
            elif op[0] == 4:
                m = [e for e in m if e["lt"] is None
                     or e["lt"] <= op[1] - 1]
        ent = {"planes": self._refs, "fn": cur_fn, "lt": mark_lt}
        adaptive = bool(self._mmco_ops)
        shorts = [e for e in m if e["lt"] is None]
        longs = [e for e in m if e["lt"] is not None]
        if mark_lt is not None:
            longs = [ent] + [e for e in longs if e["lt"] != mark_lt]
            while len(shorts) + len(longs) - 1 > 3 and shorts:
                shorts.pop()
        else:
            lim = 3 + (1 if adaptive else 0)
            while len(shorts) + len(longs) + 1 > lim and shorts:
                shorts.pop()
            shorts = [ent] + shorts
        self._ltmodel = shorts + longs
        self._mmco_ops = None
        self._reorder_l0 = None

    def _next_dts(self, pts):
        """Coded packet k gets dts = display pts[k-1] (one-frame delay);
        without B frames dts == pts (no reordering)."""
        c = self._coded_idx
        self._coded_idx += 1
        if not self.b_frames:
            return pts
        if c == 0:
            return self._pts_seq[0] - 1
        return self._pts_seq[c - 1]

    def _code_b(self, frame: Frame, disp: int, l0, l1) -> Packet:
        self._poc = 2 * (disp - self._idr_disp)
        y, u, v = self._padded_input(frame)
        l0 = l0 or self._zero_refs()
        fn = encode_b(self.mb_w, self.mb_h, self.qp, device=self.device)
        data = self._pack_b(*self._download(*fn(y, u, v, *l0, *l1)))
        pts = frame.pts if frame.pts is not None else disp
        return Packet(data=data, pts=pts, dts=self._next_dts(pts),
                      duration=1, flags=0, time_base=frame.time_base)

    def _padded_input(self, frame: Frame):
        """The frame's planes as uint8 tensors on the encoder's device,
        edge-padded at the bottom and right to whole macroblocks (an
        index gather: replicate padding takes no uint8 on CUDA)."""
        H, W = self.mb_h * 16, self.mb_w * 16
        out = []
        for p, (h, w) in zip(frame.planes[:3], ((H, W), (H // 2, W // 2),
                                                (H // 2, W // 2))):
            p = self._plane(p)
            rows = torch.arange(h, device=self.device).clamp_(
                max=p.shape[0] - 1)
            cols = torch.arange(w, device=self.device).clamp_(
                max=p.shape[1] - 1)
            out.append(p[rows[:, None], cols[None, :]])
        return tuple(out)

    def _update_ref_from_levels(self, fd: FrameData):
        """Reconstruct the reference through the decoder's device program
        (closed loop by construction — including the loop filter when
        deblocking is enabled)."""
        any_i4 = bool(np.any(fd.i4))
        i4kw = {}
        if any_i4:
            i4kw = dict(i4=fd.i4.astype(bool),
                        i4_modes=fd.i4_modes.astype(np.int8))
        t8a = np.asarray(fd.transform8, bool)
        any_t8 = bool(np.any(t8a))
        any_i8 = bool(np.any(np.asarray(fd.i4, bool) & t8a))
        ipcm = getattr(fd, "ipcm", None)
        any_ipcm = bool(ipcm is not None and np.any(ipcm))
        t8kw = dict(any_t8=any_t8, any_i8=any_i8, any_ipcm=any_ipcm)
        if any_t8:
            i4kw["t8"] = t8a
        if any_ipcm:
            i4kw.update(ipcm=ipcm.astype(bool), ipcm_y=fd.ipcm_y,
                        ipcm_u=fd.ipcm_u, ipcm_v=fd.ipcm_v)
        multi = bool(np.any(fd.ref_idx > 0))
        if multi:
            nrefs = int(fd.ref_idx.max()) + 1
            dpb = list(self._dpb[:nrefs])
            while len(dpb) < nrefs:
                dpb.append(self._zero_refs())
            refs = tuple(torch.stack([d[k] for d in dpb]) for k in range(3))
            fn = self._recon(self.mb_w, self.mb_h,
                                bool(np.any(fd.intra)), nrefs, any_i4,
                                **t8kw)
            _, padded = fn(fd.intra.astype(bool), fd.luma_mode,
                           fd.chroma_mode, fd.mv, fd.qp, fd.luma_dc,
                           fd.luma_ac, fd.chroma_dc, fd.chroma_ac, *refs,
                           ref_idx=fd.ref_idx, **i4kw)
            self._refs = padded
            self._dpb = [padded] + self._dpb[:self.refs - 1]
            return
        refs = self._refs or self._zero_refs()
        if getattr(self, "_mmco_nrefs", 0) and self._dpb \
                and not np.any(fd.intra):
            refs = self._dpb[0]      # decoder's list0[0] (may be LT)
        if self.deblock:
            fn = self._recon_deblock(self.mb_w, self.mb_h,
                                     bool(np.any(fd.intra)), any_i4,
                                     field=bool(self.fieldpic),
                                     cdy=getattr(self, "_cur_cdy", 0),
                                     **t8kw)
            nnz = np.zeros((4 * self.mb_h, 4 * self.mb_w), np.int8)
            bx = _BLK_XY_DEV[:, 0]
            by = _BLK_XY_DEV[:, 1]
            any_ac = np.any(fd.luma_ac.reshape(-1, 16, 16) != 0, axis=2)
            if any_t8:
                # decoder sets the whole quadrant's cells when the 8x8
                # block is coded — replicate so deblock bS agrees
                q = any_ac.reshape(-1, 4, 4).any(axis=2)       # (nmb, 4)
                any_ac = np.where(t8a[:, None],
                                  np.repeat(q, 4, axis=1), any_ac)
            for b in range(16):
                g = any_ac[:, b].reshape(self.mb_h, self.mb_w)
                yy = 4 * np.arange(self.mb_h)[:, None] + int(by[b])
                xx = 4 * np.arange(self.mb_w)[None, :] + int(bx[b])
                nnz[yy, xx] = g
            _, padded = fn(fd.intra.astype(bool), fd.luma_mode,
                           fd.chroma_mode, fd.mv, fd.qp, fd.luma_dc,
                           fd.luma_ac, fd.chroma_dc, fd.chroma_ac,
                           nnz, *refs, **i4kw)
        else:
            cdy0 = getattr(self, "_cur_cdy", 0)
            fn = self._recon(self.mb_w, self.mb_h,
                             bool(np.any(fd.intra)), 1, any_i4,
                             any_cdy=bool(cdy0), **t8kw)
            if cdy0:
                i4kw["cdy"] = np.full(self.mb_w * self.mb_h, cdy0,
                                      np.int32)
            _, padded = fn(fd.intra.astype(bool), fd.luma_mode,
                           fd.chroma_mode, fd.mv, fd.qp, fd.luma_dc,
                           fd.luma_ac, fd.chroma_dc, fd.chroma_ac, *refs,
                           **i4kw)
        self._refs = padded
        self._dpb = [padded] + self._dpb[:self.refs - 1]

    # ------------------------------------------------------------------ #
    # Packing
    # ------------------------------------------------------------------ #

    def _slice_header(self, pb: PutBits, slice_type: int, idr: bool,
                      nrefs: int = 1, first_mb: int = 0,
                      advance: bool = True):
        is_ref = slice_type != SLICE_B           # B pictures are non-ref
        if idr:
            self._fn = 0                         # IDR: frame_num == 0
        pb.put_ue_golomb(first_mb)               # first_mb_in_slice
        pb.put_ue_golomb(slice_type)             # 0=P 1=B 2=I (+5 ok)
        pb.put_ue_golomb(0)                      # pps_id
        pb.put_bits(self.sps.log2_max_frame_num,
                    self._fn % (1 << self.sps.log2_max_frame_num))
        if self.fieldpic:
            pb.put_bits(1, 1)                    # field_pic_flag
            pb.put_bits(1, self._cur_parity)     # bottom_field_flag
        elif self.mbaff:
            pb.put_bits(1, 0)                    # field_pic_flag (frame)
        if idr:
            pb.put_ue_golomb(self._idr_id & 0xFFFF)
        if self.sps.poc_type == 0:
            pb.put_bits(self.sps.log2_max_poc_lsb,
                        self._poc % (1 << self.sps.log2_max_poc_lsb))
        elif self.sps.poc_type == 1 and \
                not self.sps.delta_pic_order_always_zero:
            pb.put_se_golomb(0)          # delta_pic_order_cnt[0]
        if slice_type == SLICE_B:
            # direct_spatial_mv_pred_flag (0 = temporal, 8.4.1.2.3)
            pb.put_bits(1, 0 if self.direct == "temporal" else 1)
        if slice_type in (SLICE_P, SLICE_B):
            if nrefs > 1:
                pb.put_bits(1, 1)                # num_ref_idx_override
                pb.put_ue_golomb(nrefs - 1)      # num_ref_idx_l0_active-1
                if slice_type == SLICE_B:
                    pb.put_ue_golomb(0)
            else:
                pb.put_bits(1, 0)                # num_ref_idx_override
            sw = getattr(self, "_reorder_l0", None)
            if sw and slice_type == SLICE_P:
                # ref_pic_list_modification (spec 7.3.3.1): stress hook
                # emitting explicit short-term reordering ops
                pb.put_bits(1, 1)
                for idc, val in sw:
                    pb.put_ue_golomb(idc)
                    pb.put_ue_golomb(val)
                pb.put_ue_golomb(3)
            else:
                pb.put_bits(1, 0)                # ref list modification l0
            if slice_type == SLICE_B:
                pb.put_bits(1, 0)                # ref list modification l1
        if (self.pps.weighted_pred and slice_type == SLICE_P) or \
                (self.pps.weighted_bipred_idc == 1 and
                 slice_type == SLICE_B):
            # pred_weight_table (7.3.3.2): near-identity weights with
            # per-ref variation, so weighting is exercised without
            # destabilizing the open-loop P chain
            pb.put_ue_golomb(6)                  # luma denom
            pb.put_ue_golomb(5)                  # chroma denom
            nlists = 2 if slice_type == SLICE_B else 1
            for lst in range(nlists):
                n = nrefs if lst == 0 else 1
                for r in range(n):
                    pb.put_bits(1, 1)
                    pb.put_se_golomb(64 - 4 * r - 2 * lst)  # luma w
                    pb.put_se_golomb(2 * r - lst)           # luma o
                    pb.put_bits(1, 1)
                    for c in range(2):
                        pb.put_se_golomb(30 + 3 * r + c)    # chroma w
                        pb.put_se_golomb(1 - c)             # chroma o
        if idr:
            pb.put_bits(1, 0)                    # no_output_of_prior_pics
            pb.put_bits(1, 1 if getattr(self, "_idr_lt_flag", False)
                        else 0)                  # long_term_reference
        elif is_ref:
            ops = getattr(self, "_mmco_ops", None)
            if ops:                              # adaptive marking (MMCO)
                pb.put_bits(1, 1)
                for op in ops:
                    for v in op:
                        pb.put_ue_golomb(v)
                pb.put_ue_golomb(0)              # end of op list
            else:
                pb.put_bits(1, 0)
        if is_ref and advance:
            self._fn += 1 + (self.fgap if not idr else 0)
        if self.cabac and slice_type != SLICE_I:
            pb.put_ue_golomb(0)                  # cabac_init_idc
        pb.put_se_golomb(self.qp - self.pps.pic_init_qp)
        if self.deblock:
            pb.put_ue_golomb(0)                  # deblocking enabled
            pb.put_se_golomb(0)                  # alpha offset / 2
            pb.put_se_golomb(0)                  # beta offset / 2
        else:
            pb.put_ue_golomb(1)                  # disable deblocking

    def _emit_slices(self, fd, slice_type, idr, nrefs, nal_type,
                     ref_idc=None, advance=True):
        """Emit the frame as self.slices NALs (CABAC slice threading;
        one slice otherwise)."""
        n = self.slices if self.cabac else 1
        bounds = [(self.mb_h * k // n) * self.mb_w for k in range(n + 1)]
        from libav_tpu_torch.codecs.h264 import cabac as cb
        mc = cb.MbCtx(self.mb_w, self.mb_h) if self.cabac else None
        i4_grid = np.full((4 * self.mb_h, 4 * self.mb_w), -1,
                          dtype=np.int8)
        out = b""
        for k in range(n):
            pb = PutBits()
            self._slice_header(pb, slice_type, idr, nrefs=nrefs,
                               first_mb=bounds[k],
                               advance=(k == n - 1) and advance)
            if self.cabac:
                self._pack_mbs_cabac(pb, fd, slice_type, nrefs,
                                     first_mb=bounds[k],
                                     end_mb=bounds[k + 1], cur_slice=k,
                                     mc=mc, i4_grid=i4_grid)
            else:
                self._pack_mbs(pb, fd, slice_type, nrefs=nrefs)
            if ref_idc is None:
                out += self._finish_nal(pb, nal_type)
            else:
                if not self.cabac:
                    pb.put_bits(1, 1)
                pb.align(0)
                out += nal_mod.make_nal(nal_type, pb.flush(),
                                        ref_idc=ref_idc)
        return out

    def _finish_nal(self, pb: PutBits, nal_type: int) -> bytes:
        if not self.cabac:
            pb.put_bits(1, 1)                    # rbsp stop bit
        # (CABAC: the arithmetic flush already ends with the stop bit,
        #  spec 9.3.4.1.2; only byte alignment remains)
        pb.align(0)
        return nal_mod.make_nal(nal_type, pb.flush())

    def _pack_i(self, outs, recon, idr=True, advance=True,
            build_only=False):
        nmb = self.mb_w * self.mb_h
        # the device program's outputs are in MB order already
        ydc, yac, udc, uac, vdc, vac = self._download(*outs)
        fd = FrameData(nmb, self.mb_w, self.mb_h)
        fd.intra[:] = True
        fd.luma_mode[:] = 2
        fd.chroma_mode[:] = 0
        fd.qp[:] = self.qp
        scan = cavlc.SCAN4x4

        # to scan-order level tensors for the recon program + packing
        dc_flat = ydc.reshape(nmb, 16)                     # raster (4x4)
        fd.luma_dc = dc_flat[:, scan]
        ac_flat = yac.reshape(nmb, 16, 16)
        fd.luma_ac = ac_flat[:, :, scan]
        fd.luma_ac[:, :, 0] = 0
        fd.chroma_dc[:, 0] = udc
        fd.chroma_dc[:, 1] = vdc
        cac = np.concatenate([uac, vac], axis=1).reshape(nmb, 8, 16)
        fd.chroma_ac = cac[:, :, scan]
        fd.chroma_ac[:, :, 0] = 0

        if self.ipcm:
            # every Nth MB becomes I_PCM carrying its OWN pre-deblock
            # reconstruction: the decoded pixels equal the coded ones,
            # so neighbor intra prediction stays closed-loop while the
            # raw-sample transport + engine re-init get exercised
            pmask = (np.arange(nmb) % self.ipcm) == (self.ipcm - 1)
            ry, ru, rv = self._download(*recon)
            fd.ipcm = pmask
            fd.ipcm_y = (ry.reshape(self.mb_h, 16, self.mb_w, 16)
                         .transpose(0, 2, 1, 3).reshape(nmb, 16, 16))
            fd.ipcm_u = (ru.reshape(self.mb_h, 8, self.mb_w, 8)
                         .transpose(0, 2, 1, 3).reshape(nmb, 8, 8))
            fd.ipcm_v = (rv.reshape(self.mb_h, 8, self.mb_w, 8)
                         .transpose(0, 2, 1, 3).reshape(nmb, 8, 8))
            fd.luma_dc[pmask] = 0
            fd.luma_ac[pmask] = 0
            fd.chroma_dc[pmask] = 0
            fd.chroma_ac[pmask] = 0
            fd.qp[pmask] = 0             # deblock quantiser (spec 8.7)

        if self.fieldpic or self.mbaff:
            # field MBs code coefficients in field-scan order (8.5.6)
            from libav_tpu_torch.codecs.h264.cavlc import FIELD_FROM_ZZ
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., FIELD_FROM_ZZ]
        if build_only:
            return fd
        out = bytearray()
        if idr:
            out += nal_mod.make_nal(nal_mod.NAL_SPS,
                                    sets.write_sps(self.sps))
            out += nal_mod.make_nal(nal_mod.NAL_PPS,
                                    sets.write_pps(self.pps))
            out += self._emit_slices(fd, SLICE_I, True, 1,
                                     nal_mod.NAL_IDR, advance=advance)
            self._idr_id += 1
            self._dpb = []      # IDR clears the DPB (decoder does too)
        else:
            # PAFF second field of an IDR frame: plain I slice
            out += self._emit_slices(fd, SLICE_I, False, 1,
                                     nal_mod.NAL_SLICE, advance=advance)
        if self.fieldpic:
            from libav_tpu_torch.codecs.h264.cavlc import ZZ_FROM_FIELD
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., ZZ_FROM_FIELD]
        self._update_ref_from_levels(fd)
        return bytes(out)

    def _pack_i4(self, outs, recon, idr=True, advance=True,
             build_only=False):
        nmb = self.mb_w * self.mb_h
        # the device program's outputs are in MB order already
        modes, lv, udc, uac, vdc, vac = self._download(*outs)
        fd = FrameData(nmb, self.mb_w, self.mb_h)
        fd.intra[:] = True
        fd.i4[:] = True
        fd.chroma_mode[:] = 0
        fd.qp[:] = self.qp
        scan = cavlc.SCAN4x4
        fd.i4_modes = modes.astype(np.int8)
        fd.luma_ac = lv.reshape(nmb, 16, 16)[:, :, scan]
        fd.chroma_dc[:, 0] = udc
        fd.chroma_dc[:, 1] = vdc
        cac = np.concatenate([uac, vac], axis=1).reshape(nmb, 8, 16)
        fd.chroma_ac = cac[:, :, scan]
        fd.chroma_ac[:, :, 0] = 0

        if self.fieldpic or self.mbaff:
            # field MBs code coefficients in field-scan order (8.5.6)
            from libav_tpu_torch.codecs.h264.cavlc import FIELD_FROM_ZZ
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., FIELD_FROM_ZZ]
        if build_only:
            return fd
        out = bytearray()
        if idr:
            out += nal_mod.make_nal(nal_mod.NAL_SPS,
                                    sets.write_sps(self.sps))
            out += nal_mod.make_nal(nal_mod.NAL_PPS,
                                    sets.write_pps(self.pps))
            out += self._emit_slices(fd, SLICE_I, True, 1,
                                     nal_mod.NAL_IDR, advance=advance)
            self._idr_id += 1
            self._dpb = []      
        else:
            # PAFF second field of an IDR frame: plain I slice
            out += self._emit_slices(fd, SLICE_I, False, 1,
                                     nal_mod.NAL_SLICE, advance=advance)
        if self.fieldpic:
            from libav_tpu_torch.codecs.h264.cavlc import ZZ_FROM_FIELD
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., ZZ_FROM_FIELD]
        self._update_ref_from_levels(fd)
        return bytes(out)

    def _pack_i8(self, outs, recon, idr=True, advance=True,
             build_only=False):
        """I_8x8 frame packing: modes per quadrant replicated over the
        quadrant's 4 Z-order 4x4 slots, levels as raster rows (the t8
        transport layout)."""
        nmb = self.mb_w * self.mb_h
        # the device program's outputs are in MB order already
        modes, lv, udc, uac, vdc, vac = self._download(*outs)
        fd = FrameData(nmb, self.mb_w, self.mb_h)
        fd.intra[:] = True
        fd.i4[:] = True
        fd.transform8[:] = True
        fd.chroma_mode[:] = 0
        fd.qp[:] = self.qp
        scan = cavlc.SCAN4x4
        fd.i4_modes = np.repeat(modes, 4, axis=1).astype(np.int8)
        fd.luma_ac = lv.reshape(nmb, 4, 64).reshape(nmb, 16, 16)
        fd.chroma_dc[:, 0] = udc
        fd.chroma_dc[:, 1] = vdc
        cac = np.concatenate([uac, vac], axis=1).reshape(nmb, 8, 16)
        fd.chroma_ac = cac[:, :, scan]
        fd.chroma_ac[:, :, 0] = 0

        if self.fieldpic or self.mbaff:
            # field MBs code coefficients in field-scan order (8.5.6)
            from libav_tpu_torch.codecs.h264.cavlc import FIELD_FROM_ZZ
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., FIELD_FROM_ZZ]
        if build_only:
            return fd
        out = bytearray()
        if idr:
            out += nal_mod.make_nal(nal_mod.NAL_SPS,
                                    sets.write_sps(self.sps))
            out += nal_mod.make_nal(nal_mod.NAL_PPS,
                                    sets.write_pps(self.pps))
            out += self._emit_slices(fd, SLICE_I, True, 1,
                                     nal_mod.NAL_IDR, advance=advance)
            self._idr_id += 1
            self._dpb = []      
        else:
            # PAFF second field of an IDR frame: plain I slice
            out += self._emit_slices(fd, SLICE_I, False, 1,
                                     nal_mod.NAL_SLICE, advance=advance)
        if self.fieldpic:
            from libav_tpu_torch.codecs.h264.cavlc import ZZ_FROM_FIELD
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., ZZ_FROM_FIELD]
        self._update_ref_from_levels(fd)
        return bytes(out)

    def _pack_p(self, mv, luma_lv, udc, uac, vdc, vac,
                ridx=None, nrefs: int = 1, lv8=None,
                advance=True, build_only=False):
        nmb = self.mb_w * self.mb_h
        scan = cavlc.SCAN4x4
        fd = FrameData(nmb, self.mb_w, self.mb_h)
        fd.mv = mv.astype(np.int32)
        if ridx is not None:
            fd.ref_idx = ridx.astype(np.int32)
        fd.qp[:] = self.qp
        fd.luma_ac = luma_lv.reshape(nmb, 16, 16)[:, :, scan]
        if lv8 is not None:
            # alternating per-MB 8x8 transform (checkerboard), only
            # where the 8x8 path has coefficients to signal
            mbx = np.arange(nmb) % self.mb_w
            mby = np.arange(nmb) // self.mb_w
            want8 = ((mbx + mby) % 2 == 0)
            has8 = lv8.reshape(nmb, -1).any(axis=1)
            t8 = want8 & has8
            fd.transform8[:] = t8
            fd.luma_ac[t8] = lv8.reshape(nmb, 4, 64)[t8].reshape(
                -1, 16, 16)
        fd.chroma_dc[:, 0] = udc
        fd.chroma_dc[:, 1] = vdc
        cac = np.concatenate([uac, vac], axis=1).reshape(nmb, 8, 16)
        fd.chroma_ac = cac[:, :, scan]
        fd.chroma_ac[:, :, 0] = 0

        if self.fieldpic or (self.mbaff and build_only):
            # field MBs code coefficients in field-scan order (8.5.6)
            from libav_tpu_torch.codecs.h264.cavlc import (FIELD_FROM_ZZ,
                                                     ZZ_FROM_FIELD)
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., FIELD_FROM_ZZ]
        if build_only:
            return fd
        data = self._emit_slices(fd, SLICE_P, False, nrefs,
                                 nal_mod.NAL_SLICE, advance=advance)
        if self.fieldpic:
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., ZZ_FROM_FIELD]
        self._update_ref_from_levels(fd)
        return data

    def _pack_b(self, sel, mv0, mv1, luma_lv, udc, uac, vdc, vac) -> bytes:
        nmb = self.mb_w * self.mb_h
        scan = cavlc.SCAN4x4
        fd = FrameData(nmb, self.mb_w, self.mb_h)
        fd.sel = sel.astype(np.int8)
        fd.mv = mv0.astype(np.int32)
        fd.mv1 = mv1.astype(np.int32)
        fd.qp[:] = self.qp
        fd.luma_ac = luma_lv.reshape(nmb, 16, 16)[:, :, scan]
        fd.chroma_dc[:, 0] = udc
        fd.chroma_dc[:, 1] = vdc
        cac = np.concatenate([uac, vac], axis=1).reshape(nmb, 8, 16)
        fd.chroma_ac = cac[:, :, scan]
        fd.chroma_ac[:, :, 0] = 0

        # B pictures are non-reference: nal_ref_idc = 0, no DPB update
        return self._emit_slices(fd, SLICE_B, False, 1,
                                 nal_mod.NAL_SLICE, ref_idc=0)

    # ------------------------------------------------------------------ #

    def _ipcm_payload(self, fd, i) -> bytes:
        return (bytes(fd.ipcm_y[i].astype(np.uint8).ravel()) +
                bytes(fd.ipcm_u[i].astype(np.uint8).ravel()) +
                bytes(fd.ipcm_v[i].astype(np.uint8).ravel()))

    def _pack_mbs_cabac(self, pb: PutBits, fd: FrameData, slice_type: int,
                        nrefs: int = 1, first_mb: int = 0, end_mb=None,
                        cur_slice: int = 0, mc=None, i4_grid=None):
        """CABAC slice data (reference h264_cabac.c encode direction does
        not exist in libav either — this mirrors its decode semantics via
        the symmetric layer in cabac.py). With multiple slices per frame
        the MbCtx/i4 grids are shared across the slice calls and every
        neighbor derivation is slice-checked."""
        from libav_tpu_torch.codecs.h264 import cabac as cb
        mb_w, mb_h = self.mb_w, self.mb_h
        nmb = mb_w * mb_h
        if end_mb is None:
            end_mb = nmb
        mbaff = bool(getattr(fd, "mbaff_field", False))
        pb.align(1)                       # cabac_alignment_one_bit
        states = cb.init_states(slice_type == SLICE_I, 0, self.qp)
        eng = cb.CabacEncoder(pb, states)
        if mc is None:
            mc = cb.MbCtx(mb_w, mb_h)
        layer = cb.CabacMbLayer(eng, mc,
                                {SLICE_I: 2, SLICE_B: 1}.get(slice_type, 0),
                                cur_slice, grids=fd.grids,
                                field=bool(self.fieldpic) or mbaff)
        blkx = [b[0] for b in _BLK_XY]
        blky = [b[1] for b in _BLK_XY]
        if i4_grid is None:
            i4_grid = np.full((4 * mb_h, 4 * mb_w), -1, dtype=np.int8)

        from libav_tpu_torch.codecs.h264.sets import SCAN8 as _SCAN8
        pps_t8 = bool(self.pps.transform_8x8_mode)

        def luma_resid(i, mb_x, mb_y, cbp_luma, cat):
            for b in range(16):
                gx, gy = 4 * mb_x + blkx[b], 4 * mb_y + blky[b]
                if cbp_luma & (1 << (b >> 2)):
                    if cat == 1:
                        lv = fd.luma_ac[i, b, 1:16]
                        mx = 15
                    else:
                        lv = fd.luma_ac[i, b, :]
                        mx = 16
                    nnz = layer.residual(i, cat, b, lv, mx,
                                         coded=bool(np.any(lv)))
                else:
                    nnz = 0
                mc.nnz_y[gy, gx] = nnz

        def luma8_resid(i, mb_x, mb_y, cbp_luma):
            for b in range(4):
                if cbp_luma & (1 << b):
                    raster = fd.luma_ac[i, 4 * b:4 * b + 4, :].reshape(64)
                    nnz = layer.residual8(raster[_SCAN8])
                else:
                    nnz = 0
                gx = 4 * mb_x + 2 * (b & 1)
                gy = 4 * mb_y + 2 * (b >> 1)
                mc.nnz_y[gy:gy + 2, gx:gx + 2] = nnz

        def chroma_resid(i, mb_x, mb_y, cbp_chroma):
            if cbp_chroma:
                for c in range(2):
                    lv = fd.chroma_dc[i, c]
                    layer.residual(i, 3, c, lv, 4, coded=bool(np.any(lv)))
            for c, grid in ((0, mc.nnz_u), (1, mc.nnz_v)):
                for b in range(4):
                    gx = 2 * mb_x + (b & 1)
                    gy = 2 * mb_y + (b >> 1)
                    if cbp_chroma == 2:
                        lv = fd.chroma_ac[i, 4 * c + b, 1:16]
                        nnz = layer.residual(i, 4, 4 * c + b, lv, 15,
                                             coded=bool(np.any(lv)))
                    else:
                        nnz = 0
                    grid[gy, gx] = nnz

        if mbaff:
            # all-field MB pairs over the STACKED field layout: virtual
            # rows 0..H/2-1 = top field image, H/2.. = bottom; the walk
            # interleaves pairs (top then bottom MB) while every
            # neighbor/ctx derivation runs on the stacked geometry —
            # exactly the reference's uniform-field 6.4.4 topology
            # (fill_decode_neighbors: top_xy = mb_xy - 2*stride, left =
            # mb_xy - 1 when flags match)
            nmb2 = nmb // 2
            walk = []
            for py in range(mb_h // 2):
                for x_ in range(mb_w):
                    walk.append(py * mb_w + x_)
                    walk.append(nmb2 + py * mb_w + x_)
        else:
            walk = list(range(first_mb, end_mb))

        def _eos(step):
            # MBAFF: end_of_slice only after the pair's BOTTOM MB
            # (spec 7.3.4 CurrMbAddr % 2 == 1)
            if mbaff and step % 2 == 0:
                return
            layer.end_of_slice(0 if step < len(walk) - 1 else 1)

        def _fflag(step):
            # mb_field_decoding_flag: ctx 70 + left-pair + above-pair
            # field condition terms in PAIR coordinates
            # (h264_cabac.c decode_cabac_field_decoding_flag)
            pidx = step // 2
            inc = (1 if pidx % mb_w > 0 else 0) + \
                  (1 if pidx // mb_w > 0 else 0)
            layer.mb_field_flag(inc, 1)

        pair_flag_pending = False
        for _step, i in enumerate(walk):
            mb_x, mb_y = i % mb_w, i // mb_w
            if mbaff and _step % 2 == 0:
                if slice_type == SLICE_I:
                    # no skip flags in I slices: the field flag leads
                    # the pair unconditionally (spec 7.3.4)
                    _fflag(_step)
                else:
                    # P/B: mb_skip_flag comes FIRST; the field flag is
                    # transmitted with the pair's first NON-skipped MB
                    pair_flag_pending = True
            if slice_type == SLICE_B:
                cbp_luma = 0
                for b in range(16):
                    if np.any(fd.luma_ac[i, b]):
                        cbp_luma |= 1 << (b >> 2)
                has_cdc = np.any(fd.chroma_dc[i])
                has_cac = np.any(fd.chroma_ac[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                sel = int(fd.sel[i])
                if self.parts == "all":
                    btype, plan = _stress_b(i, fd)
                else:
                    btype, plan = 1 + sel, _UniformPlan(fd.mv[i],
                                                        fd.mv1[i])
                layer.mb_skip(i, 0)
                if pair_flag_pending:
                    _fflag(_step)
                    pair_flag_pending = False
                layer.mb_type_b(i, btype)
                mc.slice_id[i] = cur_slice
                mc.direct[i] = btype == 0
                fd.grids.slice_id[i] = cur_slice
                subs = part.code_inter_mb(
                    _CabacWriter(layer, plan),
                    fd, i, mb_x, mb_y, True, btype, 1, 1, cur_slice, None)
                cbp = cbp_luma | (cbp_chroma << 4)
                layer.cbp(i, cbp)
                mc.cbp[i] = cbp
                if pps_t8 and cbp_luma and part.t8_inter_allowed(
                        True, btype, subs,
                        bool(self.sps.direct_8x8_inference)):
                    # B residuals stay 4x4 in this encoder: flag = 0
                    layer.transform_size_8x8(i, 0)
                    mc.transform8[i] = False
                if cbp:
                    layer.mb_qp_delta(0)
                else:
                    layer.last_dqp = 0
                fd.coded[i] = True
                luma_resid(i, mb_x, mb_y, cbp_luma, cat=2)
                chroma_resid(i, mb_x, mb_y, cbp_chroma)
                _eos(_step)
                continue
            if slice_type == SLICE_P:
                cbp_luma = 0
                for b in range(16):
                    if np.any(fd.luma_ac[i, b]):
                        cbp_luma |= 1 << (b >> 2)
                has_cdc = np.any(fd.chroma_dc[i])
                has_cac = np.any(fd.chroma_ac[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                skip_mv = part.pred_pskip(fd.grids, mb_x, mb_y, cur_slice)
                is_skip = (cbp_luma == 0 and cbp_chroma == 0 and
                           int(fd.ref_idx[i]) == 0 and
                           tuple(fd.mv[i]) == skip_mv)
                if mbaff and _step % 2 == 1 and pair_flag_pending:
                    # never skip BOTH MBs of a pair: an all-skipped pair
                    # carries no mb_field_decoding_flag and the decoder
                    # would infer it (7.4.4) — force the bottom coded
                    is_skip = False
                layer.mb_skip(i, 1 if is_skip else 0)
                if not is_skip and pair_flag_pending:
                    _fflag(_step)
                    pair_flag_pending = False
                if is_skip:
                    mc.slice_id[i] = cur_slice
                    fd.grids.slice_id[i] = cur_slice
                    part.pskip_mb_motion(fd, i, mb_x, mb_y, cur_slice)
                    mc.skip[i] = True
                    layer.last_dqp = 0
                    fd.coded[i] = True
                    _eos(_step)
                    continue
                layer.mb_type_p_is_intra(0)
                if self.parts == "all":
                    ptype, plan = _stress_p(i, fd, nrefs)
                else:
                    ptype, plan = 0, _UniformPlan(fd.mv[i],
                                                  ref0=int(fd.ref_idx[i]))
                layer.mb_type_p_inter(ptype)
                mc.slice_id[i] = cur_slice
                fd.grids.slice_id[i] = cur_slice
                # field MBs address the doubled MbaffRefPicList (8.2.4.2.5
                # via 7.4.5.1): ref_idx is coded even with one frame ref
                eff_nrefs = 2 * nrefs if mbaff else nrefs
                subs = part.code_inter_mb(
                    _CabacWriter(layer, plan),
                    fd, i, mb_x, mb_y, False, ptype, eff_nrefs, 0,
                    cur_slice, None)
                cbp = cbp_luma | (cbp_chroma << 4)
                layer.cbp(i, cbp)
                mc.cbp[i] = cbp
                t8 = bool(fd.transform8[i])
                if pps_t8 and cbp_luma and part.t8_inter_allowed(
                        False, ptype, subs, True):
                    layer.transform_size_8x8(i, 1 if t8 else 0)
                    mc.transform8[i] = t8
                else:
                    t8 = False
                if cbp:
                    layer.mb_qp_delta(0)
                else:
                    layer.last_dqp = 0
                fd.coded[i] = True
                if t8:
                    luma8_resid(i, mb_x, mb_y, cbp_luma)
                else:
                    luma_resid(i, mb_x, mb_y, cbp_luma, cat=2)
                chroma_resid(i, mb_x, mb_y, cbp_chroma)
            elif fd.i4[i]:
                t8 = bool(fd.transform8[i])
                cbp_luma = 0
                for b in range(16):
                    if np.any(fd.luma_ac[i, b]):
                        cbp_luma |= 1 << (b >> 2)
                has_cac = np.any(fd.chroma_ac[i])
                has_cdc = np.any(fd.chroma_dc[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                mc.slice_id[i] = cur_slice
                mc.intra[i] = True
                fd.grids.slice_id[i] = cur_slice
                fd.grids.set_intra(mb_x, mb_y)
                layer.mb_type_intra(i, (0, 0, 0, 0))
                if pps_t8:
                    layer.transform_size_8x8(i, 1 if t8 else 0)
                    mc.transform8[i] = t8
                def cell(gx_, gy_):
                    if gx_ < 0 or gy_ < 0:
                        return -1
                    mbn = (gy_ >> 2) * mb_w + (gx_ >> 2)
                    if mc.slice_id[mbn] != cur_slice:
                        return -1
                    return int(i4_grid[gy_, gx_])

                if t8:
                    for b in range(4):
                        gx = 4 * mb_x + 2 * (b & 1)
                        gy = 4 * mb_y + 2 * (b >> 1)
                        m_ = min(cell(gx - 1, gy), cell(gx, gy - 1))
                        pred = 2 if m_ < 0 else m_
                        mode = int(fd.i4_modes[i, 4 * b])
                        layer.intra4x4_pred_mode(pred, mode)
                        i4_grid[gy:gy + 2, gx:gx + 2] = mode
                else:
                    for b in range(16):
                        gx, gy = 4 * mb_x + blkx[b], 4 * mb_y + blky[b]
                        m_ = min(cell(gx - 1, gy), cell(gx, gy - 1))
                        pred = 2 if m_ < 0 else m_
                        mode = int(fd.i4_modes[i, b])
                        layer.intra4x4_pred_mode(pred, mode)
                        i4_grid[gy, gx] = mode
                layer.intra_chroma_pred_mode(i, int(fd.chroma_mode[i]))
                mc.chroma_mode[i] = int(fd.chroma_mode[i])
                cbp = cbp_luma | (cbp_chroma << 4)
                layer.cbp(i, cbp)
                mc.cbp[i] = cbp
                if cbp:
                    layer.mb_qp_delta(0)
                else:
                    layer.last_dqp = 0
                fd.coded[i] = True
                if t8:
                    luma8_resid(i, mb_x, mb_y, cbp_luma)
                else:
                    luma_resid(i, mb_x, mb_y, cbp_luma, cat=2)
                chroma_resid(i, mb_x, mb_y, cbp_chroma)
            else:
                if getattr(fd, "ipcm", None) is not None and fd.ipcm[i]:
                    mc.slice_id[i] = cur_slice
                    fd.grids.slice_id[i] = cur_slice
                    fd.grids.set_intra(mb_x, mb_y)
                    i4_grid[4 * mb_y:4 * mb_y + 4,
                            4 * mb_x:4 * mb_x + 4] = 2
                    layer.mb_type_intra(i, (2, 0, 0, 0))
                    layer.pcm_samples(i, self._ipcm_payload(fd, i))
                    fd.coded[i] = True
                    _eos(_step)
                    continue
                cbp_luma15 = 15 if np.any(fd.luma_ac[i]) else 0
                has_cac = np.any(fd.chroma_ac[i])
                has_cdc = np.any(fd.chroma_dc[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                mc.slice_id[i] = cur_slice
                mc.intra[i] = True
                fd.grids.slice_id[i] = cur_slice
                fd.grids.set_intra(mb_x, mb_y)
                layer.mb_type_intra(i, (1, cbp_luma15, cbp_chroma,
                                        int(fd.luma_mode[i])))
                mc.intra16[i] = True
                i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
                mc.cbp[i] = cbp_luma15 | (cbp_chroma << 4)
                layer.intra_chroma_pred_mode(i, int(fd.chroma_mode[i]))
                mc.chroma_mode[i] = int(fd.chroma_mode[i])
                layer.mb_qp_delta(0)
                dc = fd.luma_dc[i]
                layer.residual(i, 0, 0, dc, 16, coded=bool(np.any(dc)))
                fd.coded[i] = True
                luma_resid(i, mb_x, mb_y, cbp_luma15, cat=1)
                chroma_resid(i, mb_x, mb_y, cbp_chroma)
            _eos(_step)

    def _pack_mbs(self, pb: PutBits, fd: FrameData, slice_type: int,
                  nrefs: int = 1):
        if self.cabac:
            return self._pack_mbs_cabac(pb, fd, slice_type, nrefs)
        mb_w, mb_h = self.mb_w, self.mb_h
        nmb = mb_w * mb_h
        nnz_y = np.zeros((4 * mb_h, 4 * mb_w), dtype=np.int32)
        nnz_u = np.zeros((2 * mb_h, 2 * mb_w), dtype=np.int32)
        nnz_v = np.zeros_like(nnz_u)
        i4_grid = np.full((4 * mb_h, 4 * mb_w), -1, dtype=np.int8)
        skip_run = 0
        blk = _BLK_XY

        mbaff = bool(getattr(fd, "mbaff_field", False))
        if mbaff:
            if slice_type == SLICE_B:
                raise AVError(EINVAL, "mbaff CAVLC B not supported here")
            nmb2 = nmb // 2
            walk = []
            for py_ in range(mb_h // 2):
                for x_ in range(mb_w):
                    walk.append(py_ * mb_w + x_)
                    walk.append(nmb2 + py_ * mb_w + x_)
            self._nc_split = True
        else:
            walk = list(range(nmb))
        # mbaff: mb_field_decoding_flag rides the pair's first
        # NON-skipped MB (7.3.4: CurrMbAddr%2==0 || prevMbSkipped);
        # P_Skip keeps it pending across the skip run
        pair_flag_pending = False
        for _step, i in enumerate(walk):
            mb_x, mb_y = i % mb_w, i // mb_w
            if mbaff and _step % 2 == 0:
                pair_flag_pending = True
            if mbaff and slice_type == SLICE_I and pair_flag_pending:
                pb.put_bits(1, 1)          # mb_field_decoding_flag
                pair_flag_pending = False
            if slice_type == SLICE_I and fd.i4[i]:
                self._pack_i4x4_mb(pb, fd, i, mb_x, mb_y, i4_grid,
                                   nnz_y, nnz_u, nnz_v)
                continue
            i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
            if slice_type == SLICE_B:
                cbp_luma = 0
                for b in range(16):
                    if np.any(fd.luma_ac[i, b]):
                        cbp_luma |= 1 << (b >> 2)
                has_cdc = np.any(fd.chroma_dc[i])
                has_cac = np.any(fd.chroma_ac[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                sel = int(fd.sel[i])
                if self.parts == "all":
                    btype, plan = _stress_b(i, fd)
                else:
                    btype, plan = 1 + sel, _UniformPlan(fd.mv[i],
                                                        fd.mv1[i])
                pb.put_ue_golomb(0)              # mb_skip_run (no B_Skip)
                pb.put_ue_golomb(btype)
                fd.grids.slice_id[i] = 0
                part.code_inter_mb(
                    _CavlcWriter(pb, plan),
                    fd, i, mb_x, mb_y, True, btype, 1, 1, 0, None)
                cbp = cbp_luma | (cbp_chroma << 4)
                pb.put_ue_golomb(_INTER_CBP_TO_GOLOMB[cbp])
                if cbp:
                    pb.put_se_golomb(0)          # mb_qp_delta
                fd.coded[i] = True
                self._pack_residual_inter(pb, fd, i, mb_x, mb_y, cbp_luma,
                                          cbp_chroma, nnz_y, nnz_u, nnz_v)
                continue
            if slice_type == SLICE_P:
                # compute cbp to decide skip
                cbp_luma = 0
                for b in range(16):
                    if np.any(fd.luma_ac[i, b]):
                        cbp_luma |= 1 << (b >> 2)
                has_cdc = np.any(fd.chroma_dc[i])
                has_cac = np.any(fd.chroma_ac[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                skip_mv = part.pred_pskip(fd.grids, mb_x, mb_y, 0)
                if cbp_luma == 0 and cbp_chroma == 0 and \
                        int(fd.ref_idx[i]) == 0 and \
                        tuple(fd.mv[i]) == skip_mv and \
                        not (mbaff and _step % 2 == 1 and
                             pair_flag_pending):
                    # (an all-skipped mbaff pair would leave the field
                    # flag to 7.4.4 inference — force the bottom coded)
                    skip_run += 1
                    fd.grids.slice_id[i] = 0
                    part.pskip_mb_motion(fd, i, mb_x, mb_y, 0)
                    fd.coded[i] = True
                    self._zero_nnz(nnz_y, nnz_u, nnz_v, mb_x, mb_y)
                    continue
                pb.put_ue_golomb(skip_run)
                skip_run = 0
                if mbaff and pair_flag_pending:
                    pb.put_bits(1, 1)      # mb_field_decoding_flag
                    pair_flag_pending = False
                if self.parts == "all":
                    ptype, plan = _stress_p(i, fd, nrefs)
                else:
                    ptype, plan = 0, _UniformPlan(fd.mv[i],
                                                  ref0=int(fd.ref_idx[i]))
                pb.put_ue_golomb(ptype)
                fd.grids.slice_id[i] = 0
                part.code_inter_mb(
                    _CavlcWriter(pb, plan),
                    fd, i, mb_x, mb_y, False, ptype,
                    2 * nrefs if mbaff else nrefs, 0, 0, None)
                cbp = cbp_luma | (cbp_chroma << 4)
                pb.put_ue_golomb(_INTER_CBP_TO_GOLOMB[cbp])
                if cbp:
                    pb.put_se_golomb(0)          # mb_qp_delta
                fd.coded[i] = True
                self._pack_residual_inter(pb, fd, i, mb_x, mb_y, cbp_luma,
                                          cbp_chroma, nnz_y, nnz_u, nnz_v)
            else:
                if getattr(fd, "ipcm", None) is not None and fd.ipcm[i]:
                    pb.put_ue_golomb(25)         # I_PCM (Table 7-11)
                    pb.align(0)                  # pcm_alignment_zero_bit
                    for byt in self._ipcm_payload(fd, i):
                        pb.put_bits(8, byt)
                    nnz_y[4 * mb_y:4 * mb_y + 4,
                          4 * mb_x:4 * mb_x + 4] = 16
                    nnz_u[2 * mb_y:2 * mb_y + 2,
                          2 * mb_x:2 * mb_x + 2] = 16
                    nnz_v[2 * mb_y:2 * mb_y + 2,
                          2 * mb_x:2 * mb_x + 2] = 16
                    fd.coded[i] = True
                    continue
                # I_16x16: mb_type from pred mode/cbp
                cbp_luma15 = 15 if np.any(fd.luma_ac[i]) else 0
                has_cac = np.any(fd.chroma_ac[i])
                has_cdc = np.any(fd.chroma_dc[i])
                cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
                m = (int(fd.luma_mode[i]) + 4 * cbp_chroma +
                     12 * (1 if cbp_luma15 else 0))
                pb.put_ue_golomb(1 + m)
                pb.put_ue_golomb(int(fd.chroma_mode[i]))
                pb.put_se_golomb(0)              # mb_qp_delta
                fd.coded[i] = True
                self._pack_residual_i16(pb, fd, i, mb_x, mb_y,
                                        15 if cbp_luma15 else 0, cbp_chroma,
                                        nnz_y, nnz_u, nnz_v)
        if slice_type == SLICE_P and skip_run:
            pb.put_ue_golomb(skip_run)
        self._nc_split = False

    def _pack_i4x4_mb(self, pb, fd, i, mb_x, mb_y, i4_grid,
                      nnz_y, nnz_u, nnz_v):
        """I_NxN macroblock, CAVLC (spec 7.3.5.1)."""
        cbp_luma = 0
        for b in range(16):
            if np.any(fd.luma_ac[i, b]):
                cbp_luma |= 1 << (b >> 2)
        has_cac = np.any(fd.chroma_ac[i])
        has_cdc = np.any(fd.chroma_dc[i])
        cbp_chroma = 2 if has_cac else (1 if has_cdc else 0)
        pb.put_ue_golomb(0)                  # mb_type I_NxN
        for b in range(16):
            dx, dy = _BLK_XY[b]
            gx, gy = 4 * mb_x + dx, 4 * mb_y + dy
            pred = pred_i4_mode(i4_grid, gx, gy)
            mode = int(fd.i4_modes[i, b])
            if mode == pred:
                pb.put_bits(1, 1)
            else:
                pb.put_bits(1, 0)
                pb.put_bits(3, mode - (1 if mode > pred else 0))
            i4_grid[gy, gx] = mode
        pb.put_ue_golomb(int(fd.chroma_mode[i]))
        cbp = cbp_luma | (cbp_chroma << 4)
        pb.put_ue_golomb(_INTRA_CBP_TO_GOLOMB[cbp])
        if cbp:
            pb.put_se_golomb(0)              # mb_qp_delta
        fd.coded[i] = True
        self._pack_residual_inter(pb, fd, i, mb_x, mb_y, cbp_luma,
                                  cbp_chroma, nnz_y, nnz_u, nnz_v)

    def _zero_nnz(self, nnz_y, nnz_u, nnz_v, mb_x, mb_y):
        nnz_y[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 0
        nnz_u[2 * mb_y:2 * mb_y + 2, 2 * mb_x:2 * mb_x + 2] = 0
        nnz_v[2 * mb_y:2 * mb_y + 2, 2 * mb_x:2 * mb_x + 2] = 0

    def _nc(self, grid, bx, by):
        # MBAFF stacked layout: the bottom field image's first block row
        # has no 'above' (the adjacent grid row belongs to the top field
        # image — a different MBAFF neighbor pair)
        cut = getattr(self, "_nc_split", False) and by == grid.shape[0] // 2
        a = grid[by, bx - 1] if bx > 0 else None
        b = grid[by - 1, bx] if by > 0 and not cut else None
        if a is not None and b is not None:
            return (int(a) + int(b) + 1) >> 1
        if a is not None:
            return int(a)
        if b is not None:
            return int(b)
        return 0

    def _pack_residual_i16(self, pb, fd, i, mb_x, mb_y, cbp_luma,
                           cbp_chroma, nnz_y, nnz_u, nnz_v):
        bx0, by0 = 4 * mb_x, 4 * mb_y
        nc = self._nc(nnz_y, bx0, by0)
        cavlc.encode_residual(pb, fd.luma_dc[i], nc, 16)
        for b in range(16):
            dx, dy = _BLK_XY[b]
            if cbp_luma:
                nc = self._nc(nnz_y, bx0 + dx, by0 + dy)
                tc = cavlc.encode_residual(pb, fd.luma_ac[i, b, 1:16], nc, 15)
                nnz_y[by0 + dy, bx0 + dx] = tc
            else:
                nnz_y[by0 + dy, bx0 + dx] = 0
        self._pack_residual_chroma(pb, fd, i, mb_x, mb_y, cbp_chroma,
                                   nnz_u, nnz_v)

    def _pack_residual_inter(self, pb, fd, i, mb_x, mb_y, cbp_luma,
                             cbp_chroma, nnz_y, nnz_u, nnz_v):
        bx0, by0 = 4 * mb_x, 4 * mb_y
        for b in range(16):
            dx, dy = _BLK_XY[b]
            if cbp_luma & (1 << (b >> 2)):
                nc = self._nc(nnz_y, bx0 + dx, by0 + dy)
                tc = cavlc.encode_residual(pb, fd.luma_ac[i, b], nc, 16)
                nnz_y[by0 + dy, bx0 + dx] = tc
            else:
                nnz_y[by0 + dy, bx0 + dx] = 0
        self._pack_residual_chroma(pb, fd, i, mb_x, mb_y, cbp_chroma,
                                   nnz_u, nnz_v)

    def _pack_residual_chroma(self, pb, fd, i, mb_x, mb_y, cbp_chroma,
                              nnz_u, nnz_v):
        if cbp_chroma:
            cavlc.encode_residual(pb, fd.chroma_dc[i, 0], -1, 4)
            cavlc.encode_residual(pb, fd.chroma_dc[i, 1], -1, 4)
        for c, grid in ((0, nnz_u), (1, nnz_v)):
            bx0, by0 = 2 * mb_x, 2 * mb_y
            for b in range(4):
                dx, dy = b & 1, b >> 1
                if cbp_chroma == 2:
                    nc = self._nc(grid, bx0 + dx, by0 + dy)
                    tc = cavlc.encode_residual(
                        pb, fd.chroma_ac[i, 4 * c + b, 1:16], nc, 15)
                    grid[by0 + dy, bx0 + dx] = tc
                else:
                    grid[by0 + dy, bx0 + dx] = 0
