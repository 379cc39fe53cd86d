"""MPEG-4 part 2 encoder (counterpart of `libav_tpu/codecs/mpeg4/enc.py`;
reference: libavcodec/mpeg4videoenc.c: header writer
ff_mpeg4_encode_picture_header, MB layer mpeg4_encode_mb; encode loop shared
with mpegvideo_enc.c).

Device, on the encoder's torch device (`MPEG4Encoder(params,
device="cuda")` by default; "cpu" runs the same programs on the CPU):
motion search, prediction, FDCT and the H.263 or MPEG matrix (`mpegq`)
quantiser, with the SAD or SATD (`mbcmp`) intra decision, through the
port's `codecs/mpegvideo.py` programs `encode` (I/P/S VOPs) and
`encode_b_h263` (B-VOPs); the GMC warp of the references (ops/gmc.py)
and the GMC macroblocks' residual (`gmc_residual`) for S-VOPs; and the
anchors' reconstruction through `recon` (quarter-sample with `qpel`),
whose IDCT is kernel K2: one launch per I/P/S VOP. The input planes are
padded to whole macroblocks on the device, and the reference planes stay
there from one VOP to the next. The levels (cast to int16 on the
device), vectors and intra flags come to the host once per VOP for the
packer.

Host, the JAX package's code, copied: VOS/VOL/VOP headers, MCBPC/CBPY,
gradient DC prediction, median MV prediction, intra AC prediction, 3D
run-level VLC with ESC3 fallback, B-VOP modes with direct and
colocated-skip inheritance, video packets (`ps`), data partitioning,
trellis quantisation (codecs/trellis.py), adaptive quantisation
(codecs/ratecontrol.py), the advanced-simple VOL fields, S(GMC)-VOPs
with their sprite trajectories and mcsel macroblocks, and quant_type 1
with the default matrices. As in the JAX encoder, qpel takes no
B-frames, gmc neither qpel nor mpegq (EINVAL at open), and quarter-sample
vectors are the half-pel search's doubled.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpeg4 import tables as T
from libav_tpu_torch.codecs.mpegvideo import (encode, encode_b_h263,
                                              gmc_residual, recon,
                                              zero_pad_refs)
from libav_tpu_torch.ops.gmc import (GMCParams, compute_warp_params,
                                     get_amv, warp_refs)
from libav_tpu_torch.ops.mc import EDGE
from libav_tpu_torch.ops.quant import (alternate_horizontal_scan,
                                       alternate_scan, mpeg4_dc_scaler,
                                       zigzag_scan)
from libav_tpu_torch.codecs.mpeg4.dec import _ac_cell, _rdiv, _store_ac


VOS_STARTCODE = b"\x00\x00\x01\xB0"
VISOBJ_STARTCODE = b"\x00\x00\x01\xB5"
VO_STARTCODE = b"\x00\x00\x01\x00"
VOL_STARTCODE = b"\x00\x00\x01\x20"
VOP_STARTCODE = b"\x00\x00\x01\xB6"

PICT_I, PICT_P, PICT_B, PICT_S = 0, 1, 2, 3


def encode_mv_component(pb: PutBits, delta: int, fcode: int = 1):
    """ISO 14496-2 §7.6.3 MV coding; fcode=1 => no residual bits."""
    rng = 32 << (fcode - 1)
    if delta < -rng:
        delta += 2 * rng
    elif delta >= rng:
        delta -= 2 * rng
    if fcode == 1:
        a = abs(delta)
        code, bits = T.MVTAB[a]
        pb.put_bits(bits, code)
        if a:
            pb.put_bits(1, 1 if delta < 0 else 0)
        return
    if delta == 0:
        code, bits = T.MVTAB[0]
        pb.put_bits(bits, code)
        return
    shift = fcode - 1
    a = abs(delta)
    mc = ((a - 1) >> shift) + 1
    residual = a - 1 - ((mc - 1) << shift)
    code, bits = T.MVTAB[mc]
    pb.put_bits(bits, code)
    pb.put_bits(1, 1 if delta < 0 else 0)
    pb.put_bits(shift, residual)


def encode_dc(pb: PutBits, diff: int, luma: bool):
    """Intra DC differential (14496-2 §7.4.1 tables B-13/14)."""
    size = abs(diff).bit_length()
    code, bits = (T.DC_LUM if luma else T.DC_CHROM)[size]
    pb.put_bits(bits, code)
    if size:
        v = diff if diff > 0 else diff + (1 << size) - 1
        pb.put_bits(size, v)
        if size > 8:
            pb.put_bits(1, 1)   # marker bit


def encode_block_rl(pb: PutBits, levels: np.ndarray, start: int,
                    intra: bool):
    """3D (last, run, level) coding with ESC type-3 fallback."""
    m = T.rl_encode_map(intra)
    nz = [(k, int(levels[k])) for k in range(start, 64) if levels[k]]
    for i, (k, lvl) in enumerate(nz):
        prev_k = nz[i - 1][0] if i else start - 1
        run = k - prev_k - 1
        last = 1 if i == len(nz) - 1 else 0
        a = abs(lvl)
        key = (last, run, a)
        if key in m:
            code, bits = m[key]
            pb.put_bits(bits, code)
            pb.put_bits(1, 1 if lvl < 0 else 0)
        else:
            # ESC3: escape + '11' + last(1) run(6) marker level(12s) marker
            ec, eb = (T.INTRA_VLC if intra else T.INTER_VLC)[T.ESC_INDEX]
            pb.put_bits(eb, ec)
            pb.put_bits(2, 0b11)
            pb.put_bits(1, last)
            pb.put_bits(6, run)
            pb.put_bits(1, 1)
            pb.put_sbits(12, lvl)
            pb.put_bits(1, 1)


@register_codec
class MPEG4Encoder(Encoder):
    NAME = "mpeg4"
    TYPE = MediaType.VIDEO
    LONG_NAME = "MPEG-4 part 2 (PyTorch ME/DCT/quant)"

    OPTIONS = Encoder.OPTIONS + [
        Option("qscale", "fixed quantizer 1-31", "int", 6, 1, 31),
        Option("gop_size", "GOP length", "int", 12, 1, 600),
        Option("acpred", "intra AC prediction (ac_pred_flag=1: "
               "left/top AC predictors + alternate scans)", "int",
               0, 0, 1),
        Option("mpegq", "MPEG quant (VOL quant_type=1: default "
               "matrix-weighted quantisation)", "int", 0, 0, 1),
        Option("b_frames", "max B-VOPs between anchors", "int", 0, 0, 2),
        Option("bdirect", "emit direct mode (modb=1, zero delta-MV) on "
               "every Nth coded B MB (0 = off)", "int", 7, 0, 64),
        Option("qpel", "quarter-sample mode (VOL quarter_sample=1, "
               "8-tap MC; P-VOPs)", "int", 0, 0, 1),
        Option("gmc", "global motion compensation: S(GMC)-VOPs with N "
               "sprite warping points (0 = off)", "int", 0, 0, 3),
        Option("gmc_acc", "sprite_warping_accuracy (0=1/2 .. 3=1/16 "
               "pel)", "int", 3, 0, 3),
        Option("gmc_sel", "mcsel choice: 0=checkerboard of inter MBs, "
               "1=all inter MBs", "int", 0, 0, 1),
        Option("trellis", "rate-distortion optimal quantization of "
               "inter blocks (codecs/trellis.py)", "int", 0, 0, 1),
        Option("trellis_lambda", "trellis RD lambda scale x100", "int",
               25, 1, 400),
        Option("mbcmp", "macroblock decision metric: sad or satd "
               "(Hadamard einsum, ops/mecmp.py)", "string", "sad"),
        Option("ps", "video packet size in bytes: resync markers + "
               "slice-aware prediction resets (0 = off)", "int",
               0, 0, 1 << 20),
        Option("data_partitioning", "partition I/P VOPs into "
               "mcbpc+DC/MV, ac_pred+cbpy, texture with DC/motion "
               "markers", "int", 0, 0, 1),
        # adaptive quantization (reference: ratecontrol.c:703
        # adaptive_quantization; mpegvideo_enc.c:341 adaptive_quant =
        # lumi_masking || ...).  Any nonzero masking enables per-MB
        # qscale with INTER_Q/INTRA_Q dquant coding on I/P VOPs.
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
    CAPABILITIES = ("delay",)
    DEVICE_PART = True

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MPEG4Encoder(params, options, device=...): the device programs
        run on `device`; frames may hold numpy arrays or tensors."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        if self.width <= 0 or self.height <= 0:
            raise AVError(EINVAL, "mpeg4: width/height required")
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        if self.qpel and self.b_frames:
            raise AVError(EINVAL, "mpeg4: qpel B-VOPs not supported")
        if self.gmc and (self.qpel or self.mpegq):
            raise AVError(EINVAL, "mpeg4: gmc with qpel/mpegq not "
                          "supported by this encoder")
        self._fcode = 2 if self.qpel else 1
        self._gmc_n = 0
        self._frame_idx = 0
        self._refs = None
        self._refs_prev = None
        self._pending = []           # buffered display frames (B runs)
        self._enc_time_base = 0      # decoder's time_base mirror (secs)
        self._prev_anchor_secs = 0
        self._col_skip = None
        self._col_mv = None
        fr = self.params.framerate
        self._fr = fr if fr else Rational(25, 1)
        self._time_res = max(self._fr.num, 1)
        self._time_inc_bits = max(1, (self._time_res - 1).bit_length())
        if self.mpegq:
            zz = np.asarray(zigzag_scan())
            self._qi, self._qp = (
                torch.as_tensor(np.array(m, np.int32)[zz]).to(self.device)
                for m in (T.DEFAULT_INTRA_MATRIX, T.DEFAULT_INTER_MATRIX))
        else:
            # the h263 quantiser reads no matrix
            self._qi = self._qp = None

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        disp = self._frame_idx
        self._frame_idx += 1
        is_i = (disp % self.gop_size) == 0 or self._refs is None
        if not is_i and self.b_frames and \
                len(self._pending) < self.b_frames and \
                (disp + 1) % self.gop_size != 0:
            self._pending.append((frame, disp))
            return []
        pkts = [self._code_anchor(frame, disp, is_i)]
        for bf, bd in self._pending:
            pkts.append(self._code_b(bf, bd))
        self._pending = []
        return pkts

    def _drain(self) -> List[Packet]:
        if not self._pending:
            return []
        last_f, last_d = self._pending[-1]
        rest = self._pending[:-1]
        self._pending = []
        pkts = [self._code_anchor(last_f, last_d, False)]
        for bf, bd in rest:
            pkts.append(self._code_b(bf, bd))
        return pkts

    @property
    def _adaptive_quant(self) -> bool:
        return bool((self.lumi_masking or self.dark_masking or
                     self.tcplx_masking or self.scplx_masking or
                     self.p_masking or self.border_masking)
                    and not self.gmc)

    def _frame_qscale(self, y: np.ndarray, is_i: bool) -> np.ndarray:
        """Per-MB qscale field.  With any masking option set, runs the
        reference's adaptive_quantization model (ratecontrol.c:703) on
        per-MB luma stats, then walks the raster clamping each step to
        +-2 so every transition is expressible as a single MPEG-4
        dquant (quant_tab {-1,-2,1,2}).  Temporal complexity is the
        zero-MV residual variance vs the reconstructed reference (a
        pre-ME proxy for the reference's post-ME mc_mb_var)."""
        nmb = self.mb_w * self.mb_h
        if not self._adaptive_quant:
            return np.full(nmb, self.qscale, dtype=np.int32)
        from libav_tpu_torch.codecs.ratecontrol import adaptive_qscale_field
        ref_y = None
        if not is_i and self._refs is not None:
            ref_y = self._refs[0][EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
        qs = adaptive_qscale_field(
            self.qscale, y.cpu().numpy(), ref_y, self.mb_w, self.mb_h,
            force_intra=is_i,
            lumi_masking=self.lumi_masking,
            dark_masking=self.dark_masking,
            temporal_cplx_masking=self.tcplx_masking,
            spatial_cplx_masking=self.scplx_masking,
            p_masking=self.p_masking,
            border_masking=self.border_masking,
            qmin=self.mb_qmin, qmax=self.mb_qmax)
        cur = int(qs[0])
        for i in range(nmb):
            cur = int(min(max(int(qs[i]), cur - 2), cur + 2))
            qs[i] = cur
        return qs

    def _code_anchor(self, frame: Frame, disp: int, is_i: bool) -> Packet:
        nmb = self.mb_w * self.mb_h
        y, u, v = self._padded_input(frame)
        qscale = self._frame_qscale(y, is_i)
        qs = torch.as_tensor(qscale).to(self.device)
        kind = "mpeg4mq" if self.mpegq else "h263"
        want_tr = bool(self.trellis and not is_i and not self.mpegq)
        enc = encode(self.mb_w, self.mb_h, not is_i, kind,
                     want_coeffs=want_tr, mbcmp=self.mbcmp,
                     device=self.device)
        refs = self._refs if not is_i else \
            zero_pad_refs(self.mb_w, self.mb_h, device=self.device)
        outs = enc(y, u, v, qs, self._qi, self._qp, *refs)
        lv, mv, intra_d = outs[:3]
        levels, mvs, intra = self._download(lv.to(torch.int16), mv, intra_d)
        if want_tr and np.any(~intra):
            from libav_tpu_torch.codecs.trellis import trellis_inter
            czz, = self._download(outs[3])
            sel = np.repeat(~intra, 6)
            flat = levels.reshape(-1, 64).copy()
            flat[sel] = trellis_inter(
                czz.reshape(-1, 64)[sel], flat[sel],
                np.repeat(qscale, 6)[sel],
                lam_scale=self.trellis_lambda / 100.0)
            levels = flat.reshape(nmb, 6, 64)
            lv = torch.as_tensor(levels).to(self.device)
        if self.qpel and not is_i:
            # half-pel ME doubled to quarter-pel units; the closed loop
            # reconstructs through the SAME 8-tap qpel MC the decoder
            # uses, so prediction drift cannot accumulate
            mvs = mvs * 2
            mv = mv * 2

        gmc_mask = np.zeros(nmb, dtype=bool)
        traj = None
        r1 = zero_pad_refs(self.mb_w, self.mb_h, device=self.device)
        if self.gmc and not is_i:
            n = self._gmc_n
            self._gmc_n += 1
            traj = [((2 * n) % 17 - 8, (3 * n) % 13 - 6),
                    (1 + n % 2, n % 3 - 1), (n % 3 - 1, 1)][:self.gmc]
            off, dlt, shf, rp = compute_warp_params(
                traj, self.gmc, self.gmc_acc, self.width, self.height)
            params = GMCParams(off, dlt, shf, rp, self.gmc_acc, 0)
            r1 = warp_refs(refs, params, self.mb_w, self.mb_h)
            # mcsel on a checkerboard of non-intra MBs
            gx = np.arange(nmb) % self.mb_w
            gy = np.arange(nmb) // self.mb_w
            if self.gmc_sel == 1:
                gmc_mask = (~intra)
            else:
                gmc_mask = (~intra) & (((gx + gy) & 1) == 0)
            mvs = mvs.copy()
            glevels, = self._download(gmc_residual(
                self.mb_w, self.mb_h, device=self.device)(
                y, u, v, r1[0], r1[1], r1[2], qs).to(torch.int16))
            levels = levels.copy()
            levels[gmc_mask] = glevels[gmc_mask]
            # amv into the MV array (neighbors predict from it and the
            # decoder stores it for B direct)
            amv_c = {}
            for idx in np.nonzero(gmc_mask)[0]:
                key = (0, 0) if rp == 1 else (int(gx[idx]), int(gy[idx]))
                if key not in amv_c:
                    amv_c[key] = (
                        get_amv(params, 0, self._fcode, key[0], key[1], 0),
                        get_amv(params, 0, self._fcode, key[0], key[1], 1))
                mvs[idx] = amv_c[key]
            lv = torch.as_tensor(levels).to(self.device)
            mv = torch.as_tensor(mvs).to(self.device)

        rec = recon(self.mb_w, self.mb_h, kind, False, not is_i,
                    qpel=bool(self.qpel and not is_i), device=self.device)
        no = torch.zeros(nmb, dtype=torch.bool, device=self.device)
        gmc_d = torch.as_tensor(gmc_mask).to(self.device)
        use_fwd = no if is_i else ~intra_d & ~gmc_d
        _, padded = rec(lv, qs, intra_d, use_fwd, gmc_d, mv,
                        torch.zeros_like(mv), self._qi, self._qp,
                        *refs, *r1)
        self._refs_prev = self._refs
        self._refs = padded

        # colocated data the decoder will use for B direct/skip
        # (decoder mirror: skip inheritance + TRB/TRD direct scaling)
        if is_i:
            self._col_skip = np.zeros(nmb, bool)
            self._col_mv = np.zeros((nmb, 2), np.int32)
        else:
            cbp_any = np.any(
                levels.reshape(nmb, 6, 64) != 0, axis=(1, 2))
            self._col_skip = (~intra) & ~cbp_any & ~gmc_mask & \
                (mvs[:, 0] == 0) & (mvs[:, 1] == 0)
            self._col_mv = np.where(intra[:, None], 0, mvs)
        self._anchor_disps = (getattr(self, "_cur_anchor_disp", disp),
                              disp)
        self._cur_anchor_disp = disp

        data = self._pack(levels, mvs, intra, qscale,
                          PICT_I if is_i else
                          (PICT_S if self.gmc else PICT_P), disp,
                          traj=traj, gmc_mask=gmc_mask)
        pkt = Packet(data=data, pts=frame.pts, dts=frame.pts, duration=1,
                     flags=PKT_FLAG_KEY if is_i else 0,
                     time_base=frame.time_base)
        return pkt

    def _code_b(self, frame: Frame, disp: int) -> Packet:
        nmb = self.mb_w * self.mb_h
        qscale = torch.full((nmb,), self.qscale, dtype=torch.int32,
                            device=self.device)
        y, u, v = self._padded_input(frame)
        kind = "mpeg4mq" if self.mpegq else "h263"
        fn = encode_b_h263(self.mb_w, self.mb_h, kind, device=self.device)
        zero = zero_pad_refs(self.mb_w, self.mb_h, device=self.device)
        r0 = self._refs_prev or zero
        r1 = self._refs or zero
        levels, mv_f, mv_b, sel, _ = fn(y, u, v, qscale, self._qi,
                                        self._qp, *r0, *r1)
        levels, mv_f, mv_b, sel = self._download(levels.to(torch.int16),
                                                 mv_f, mv_b, sel)

        pb = PutBits()
        self._vop_header(pb, PICT_B, disp)
        self._b_layer(pb, levels, mv_f, mv_b, sel)
        self._stuff(pb)
        data = VOP_STARTCODE + pb.flush()
        return Packet(data=data, pts=frame.pts, dts=frame.pts,
                      duration=1, flags=0, time_base=frame.time_base)

    def _b_layer(self, pb, levels, mv_f, mv_b, sel):
        """B-VOP macroblock layer (decoder mirror: dec._decode_mbs_b;
        reference mpeg4videoenc.c mpeg4_encode_mb B branch)."""
        mw, mh = self.mb_w, self.mb_h
        col_skip = self._col_skip if self._col_skip is not None else \
            np.zeros(mw * mh, bool)
        ndirect = self.bdirect
        for mb_y in range(mh):
            last_mv = [[0, 0], [0, 0]]
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                if col_skip[idx]:
                    continue             # decoder inherits the skip
                if ndirect and idx % ndirect == ndirect // 2:
                    pb.put_bits(1, 1)    # modb=1: direct, no dMV/cbp
                    continue
                mode = int(sel[idx])     # 0=fwd 1=bwd 2=bi
                lv = levels[idx]
                cbp = 0
                for b in range(6):
                    if np.any(lv[b]):
                        cbp |= 0x20 >> b
                pb.put_bits(1, 0)        # modb1
                pb.put_bits(1, 0 if cbp else 1)   # modb2
                mbt = {0: 3, 1: 2, 2: 1}[mode]
                for _ in range(mbt):
                    pb.put_bits(1, 0)
                pb.put_bits(1, 1)        # mb_type unary terminator
                if cbp:
                    pb.put_bits(6, cbp)
                    pb.put_bits(1, 0)    # dbquant: 0
                if mode in (0, 2):       # forward MV
                    mv = (int(mv_f[idx][0]), int(mv_f[idx][1]))
                    encode_mv_component(pb, mv[0] - last_mv[0][0], 1)
                    encode_mv_component(pb, mv[1] - last_mv[0][1], 1)
                    last_mv[0] = [mv[0], mv[1]]
                if mode in (1, 2):       # backward MV
                    mv = (int(mv_b[idx][0]), int(mv_b[idx][1]))
                    encode_mv_component(pb, mv[0] - last_mv[1][0], 1)
                    encode_mv_component(pb, mv[1] - last_mv[1][1], 1)
                    last_mv[1] = [mv[0], mv[1]]
                for b in range(6):
                    if cbp & (0x20 >> b):
                        encode_block_rl(pb, lv[b], 0, False)

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
    # Headers (reference: mpeg4videoenc.c mpeg4_encode_vol_header /
    # ff_mpeg4_encode_picture_header)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _stuff(pb: PutBits):
        """next_start_code() stuffing (ISO 14496-2 §5.2.3): one 0 bit then
        1s to the byte boundary; a full '01111111' byte if aligned."""
        pb.put_bits(1, 0)
        pb.align(pad_bit=1)

    def _vol_headers(self) -> bytes:
        out = bytearray()
        out += VOS_STARTCODE + bytes([0x01])      # profile: simple@L1
        # visual_object: is_identifier(1)=0, type(4)=1 video, signal(1)=0
        pb2 = PutBits()
        pb2.put_bits(1, 0)
        pb2.put_bits(4, 1)      # video object type
        pb2.put_bits(1, 0)      # video_signal_type absent
        self._stuff(pb2)
        out += VISOBJ_STARTCODE + pb2.flush()
        out += VO_STARTCODE     # video_object 0
        pb = PutBits()
        pb.put_bits(1, 0)       # random_accessible_vol
        # video_object_type_indication: simple (1) / adv. simple (17)
        asp = bool(self.qpel or self.gmc)
        pb.put_bits(8, 0x11 if asp else 0x01)
        if asp:
            pb.put_bits(1, 1)   # is_object_layer_identifier
            pb.put_bits(4, 5)   # vol_ver_id
            pb.put_bits(3, 1)   # vol_priority
        else:
            pb.put_bits(1, 0)   # is_object_layer_identifier
        pb.put_bits(4, 1)       # aspect_ratio_info: 1:1
        pb.put_bits(1, 0)       # vol_control_parameters
        pb.put_bits(2, 0)       # shape: rectangular
        pb.put_bits(1, 1)       # marker
        pb.put_bits(16, self._time_res)
        pb.put_bits(1, 1)       # marker
        pb.put_bits(1, 0)       # fixed_vop_rate = 0
        pb.put_bits(1, 1)       # marker
        pb.put_bits(13, self.width)
        pb.put_bits(1, 1)       # marker
        pb.put_bits(13, self.height)
        pb.put_bits(1, 1)       # marker
        pb.put_bits(1, 0)       # interlaced
        pb.put_bits(1, 1)       # obmc_disable
        # sprite_enable: 1 bit at ver_id 1, 2 bits otherwise
        if asp:
            pb.put_bits(2, 2 if self.gmc else 0)
            if self.gmc:        # reference :1790-1813
                pb.put_bits(6, self.gmc)            # warping points
                pb.put_bits(2, self.gmc_acc)
                pb.put_bits(1, 0)                   # brightness_change
        else:
            pb.put_bits(1, 0)
        pb.put_bits(1, 0)       # not_8_bit
        pb.put_bits(1, 1 if self.mpegq else 0)   # quant_type
        if self.mpegq:
            pb.put_bits(1, 0)   # load_intra_quant_mat: defaults
            pb.put_bits(1, 0)   # load_nonintra_quant_mat: defaults
        if asp:
            pb.put_bits(1, 1 if self.qpel else 0)   # quarter_sample
        pb.put_bits(1, 1)       # complexity_estimation_disable
        pb.put_bits(1, 0 if self.ps else 1)   # resync_marker_disable
        pb.put_bits(1, 1 if self.data_partitioning else 0)
        if self.data_partitioning:
            pb.put_bits(1, 0)   # reversible_vlc
        if asp:                 # ver_id != 1 extras
            pb.put_bits(1, 0)   # newpred_enable
            pb.put_bits(1, 0)   # reduced_res_vop_enable
        pb.put_bits(1, 0)       # scalability
        self._stuff(pb)
        out += VOL_STARTCODE + pb.flush()
        return bytes(out)

    @staticmethod
    def _write_traj(pb: PutBits, traj):
        """Sprite trajectory dmv writer (inverse of get_xbits + Table
        B-30 length codes)."""
        for (x, y) in traj:
            for v in (x, y):
                ln = abs(v).bit_length()
                code, bits = T.SPRITE_TRAJ[ln]
                pb.put_bits(bits, code)
                if ln:
                    raw = v if v > 0 else v + (1 << ln) - 1
                    pb.put_bits(ln, raw)
                pb.put_bits(1, 1)   # marker

    def _vop_header(self, pb: PutBits, pict_type: int, disp: int,
                    traj=None, q0=None):
        """VOP header with the decoder's exact time bookkeeping
        (ISO 14496-2 §6.2.5: modulo_time_base counts whole seconds —
        non-B relative to time_base, B relative to last_time_base)."""
        pb.put_bits(2, pict_type)
        t_total = disp * self._fr.den
        secs = t_total // self._time_res
        tinc = t_total % self._time_res
        base = self._prev_anchor_secs if pict_type == PICT_B \
            else self._enc_time_base
        for _ in range(max(0, secs - base)):
            pb.put_bits(1, 1)
        pb.put_bits(1, 0)
        if pict_type != PICT_B:
            self._prev_anchor_secs = self._enc_time_base
            self._enc_time_base = secs
        pb.put_bits(1, 1)       # marker
        pb.put_bits(self._time_inc_bits, tinc)
        pb.put_bits(1, 1)       # marker
        pb.put_bits(1, 1)       # vop_coded
        if pict_type in (PICT_P, PICT_S):
            pb.put_bits(1, 0)   # vop_rounding_type
        pb.put_bits(3, 0)       # intra_dc_vlc_thr: always intra DC VLC
        if pict_type == PICT_S:
            self._write_traj(pb, traj)
        pb.put_bits(5, self.qscale if q0 is None else int(q0))
        if pict_type in (PICT_P, PICT_B, PICT_S):
            pb.put_bits(3, self._fcode)
        if pict_type == PICT_B:
            pb.put_bits(3, 1)   # vop_bcode

    # ------------------------------------------------------------------ #

    def _pack(self, levels, mvs, intra, qscale, pict_type,
              disp=0, traj=None, gmc_mask=None) -> bytes:
        out = bytearray()
        if pict_type == PICT_I:
            out += self._vol_headers()
        pb = PutBits()
        self._vop_header(pb, pict_type, disp, traj=traj,
                         q0=int(qscale[0]))
        self._mb_layer(pb, levels, mvs, intra, qscale, pict_type,
                       gmc_mask=gmc_mask)
        self._stuff(pb)
        return bytes(out) + VOP_STARTCODE + pb.flush()

    def _mb_layer(self, pb, levels, mvs, intra, qscale, pict_type,
                  gmc_mask=None):
        """MB layer with optional video packets (`ps`, reference:
        mpegvideo_enc.c:2762 is_gob_start + write_slice_end +
        ff_mpeg4_encode_video_packet_header) and data partitioning
        (`data_partitioning`, mpeg4videoenc.c:479 pb/pb2/tex_pb routing
        + ff_mpeg4_merge_partitions)."""
        from libav_tpu_torch.codecs.mpeg4.dec import (DC_MARKER, MOTION_MARKER,
                                                _VopPred,
                                                _vpp_prefix_len)
        mw, mh = self.mb_w, self.mb_h
        nmb = mw * mh
        pred = _VopPred(mw, mh)
        use_acp = bool(self.acpred)
        zz = np.asarray(zigzag_scan())
        dp = bool(self.data_partitioning) and pict_type != PICT_B
        ps = int(self.ps)
        pb2 = PutBits() if dp else pb
        tex = PutBits() if dp else pb
        dc_pb = pb2 if (dp and pict_type != PICT_I) else pb
        last_gob = 0
        cur_q = int(qscale[0])      # decoder mirror of its running qs
        DQUANT_CODE = {-1: 0, -2: 1, 1: 2, 2: 3}    # dec quant_tab order

        def merge_partitions():
            nonlocal pb2, tex, dc_pb
            if not dp:
                return
            if pict_type == PICT_I:
                pb.put_bits(19, DC_MARKER)
            else:
                pb.put_bits(17, MOTION_MARKER)
            pb.copy_bits(pb2)
            pb.copy_bits(tex)
            pb2 = PutBits()
            tex = PutBits()
            dc_pb = pb2 if pict_type != PICT_I else pb

        for mb_y in range(mh):
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                lv = levels[idx]
                is_intra = bool(intra[idx]) or pict_type == PICT_I
                mv = mvs[idx]
                q = int(qscale[idx])

                if ps and idx > 0 and \
                        ((pb.bits_written() + 7) >> 3) - last_gob >= ps:
                    # end the packet, byte-align, write the video
                    # packet header, reset predictors
                    merge_partitions()
                    self._stuff(pb)
                    last_gob = pb.bits_written() >> 3
                    pb.put_bits(_vpp_prefix_len(pict_type, self._fcode,
                                                1), 0)
                    pb.put_bits(1, 1)
                    pb.put_bits(max(1, (nmb - 1).bit_length()), idx)
                    pb.put_bits(5, q)
                    pb.put_bits(1, 0)            # no HEC
                    pred.resync(mb_x, mb_y)
                    cur_q = q       # decoder resets qs from the VP header

                acp_blocks = None
                if use_acp and is_intra:
                    # subtract the AC predictors per block and pick the
                    # per-block alternate scan (mirrors dec._pred_ac);
                    # cbp is computed from the RESIDUAL coefficients
                    acp_blocks = self._acpred_blocks(
                        lv, mb_x, mb_y, q, qscale, pred, zz)

                cbp = 0
                for b in range(6):
                    start = 1 if is_intra else 0
                    coeffs = acp_blocks[b][0][start:] \
                        if acp_blocks is not None else lv[b][start:]
                    if np.any(coeffs):
                        cbp |= 0x20 >> b
                cbpc = cbp & 3
                cbpy = cbp >> 2

                dq = q - cur_q      # +-2 by the _frame_qscale walk
                if pict_type in (PICT_P, PICT_S):
                    is_gmc = gmc_mask is not None and bool(gmc_mask[idx])
                    if pict_type == PICT_S:
                        # not_coded in an S-VOP decodes as a GMC skip,
                        # so only GMC MBs without residual may use it
                        not_coded = is_gmc and cbp == 0
                    else:
                        # a q transition needs a coded MB to carry the
                        # dquant, so those MBs are never skipped
                        not_coded = (not is_intra and cbp == 0
                                     and mv[0] == 0 and mv[1] == 0
                                     and dq == 0)
                    if not_coded:
                        pb.put_bits(1, 1)   # not_coded = skip
                        for k in range(4):
                            pred.grid_put(mb_x, mb_y, k, int(mv[0]),
                                          int(mv[1]))
                        continue
                    pb.put_bits(1, 0)
                    if is_intra:
                        group = T.MBT_INTRAQ if dq else T.MBT_INTRA
                    else:
                        group = T.MBT_INTERQ if dq else T.MBT_INTER
                    i = group * 4 + cbpc
                    pb.put_bits(T.INTER_MCBPC_BITS[i], T.INTER_MCBPC_CODE[i])
                else:
                    i = cbpc + (4 if dq else 0)     # intra(+q) group
                    pb.put_bits(T.INTRA_MCBPC[1][i], T.INTRA_MCBPC[0][i])
                    if dq and dp:
                        # DP I-VOP partition A: dquant follows mcbpc
                        # (dec._decode_partitions I branch)
                        pb.put_bits(2, DQUANT_CODE[dq])

                if is_intra:
                    pb2.put_bits(1, 1 if acp_blocks is not None else 0)
                    code, bits = T.CBPY[cbpy]
                    pb2.put_bits(bits, code)
                    if dq and not (dp and pict_type == PICT_I):
                        pb2.put_bits(2, DQUANT_CODE[dq])
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, 0, 0)
                else:
                    if pict_type == PICT_S:
                        pb.put_bits(1, 1 if is_gmc else 0)   # mcsel
                    code, bits = T.CBPY[15 - cbpy]
                    pb2.put_bits(bits, code)
                    if dq:
                        pb2.put_bits(2, DQUANT_CODE[dq])
                    if not (pict_type == PICT_S and is_gmc):
                        # motion vector, median predicted
                        px, py = pred.grid_pred(mb_x, mb_y, 0)
                        encode_mv_component(pb, int(mv[0]) - px,
                                            self._fcode)
                        encode_mv_component(pb, int(mv[1]) - py,
                                            self._fcode)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, int(mv[0]),
                                      int(mv[1]))

                cur_q = q

                for b in range(6):
                    coded = bool(cbp & (0x20 >> b))
                    if is_intra:
                        luma = b < 4
                        dcs = mpeg4_dc_scaler(q, luma)
                        lvl_dc = int(lv[b][0])
                        if acp_blocks is not None:
                            # DC ctx consumed + stored by _acpred_blocks
                            pred_lvl = acp_blocks[b][1]
                            encode_dc(dc_pb, lvl_dc - int(pred_lvl),
                                      luma)
                        else:
                            p, store, _dir = pred.dc_ctx(b, mb_x, mb_y)
                            pred_lvl = (p + dcs // 2) // dcs
                            encode_dc(dc_pb, lvl_dc - int(pred_lvl),
                                      luma)
                            store(lvl_dc * dcs)
                        if coded:
                            encode_block_rl(
                                tex, acp_blocks[b][0] if acp_blocks
                                is not None else lv[b], 1, True)
                    elif coded:
                        encode_block_rl(tex, lv[b], 0, False)
        merge_partitions()

    def _acpred_blocks(self, lv, mb_x, mb_y, q, qscale, pred_st, zz):
        """Per-block (scanned residual levels, (dc_pred_lvl, dc_store)):
        the encode mirror of dec._pred_ac — subtract the stored
        neighbor column/row, rescan with the direction's alternate
        scan, store this block's own final values.  Uses the shared
        slice-aware _VopPred state (video packet boundaries mask the
        out-of-slice DC candidates and zero the cleaned AC cells)."""
        out = []
        qs_tab = qscale
        acv = pred_st.acv
        for b in range(6):
            luma = b < 4
            dcs = mpeg4_dc_scaler(q, luma)
            # DC direction decides predictor source and scan
            p, store, dc_dir = pred_st.dc_ctx(b, mb_x, mb_y)
            pred_lvl = (p + dcs // 2) // dcs
            # store NOW: blocks later in this MB predict from it
            store(int(lv[b][0]) * dcs)

            raster = np.zeros(64, np.int64)
            raster[zz] = lv[b]
            resid = raster.copy()
            g_, bx_, by_ = _ac_cell(b, mb_x, mb_y)
            if dc_dir == 0:
                vals = acv[g_][by_, bx_ - 1, 0:7]
                nq_i = mb_y * self.mb_w + mb_x - 1
                same = (mb_x == 0 or b in (1, 3) or
                        int(qs_tab[nq_i]) == q)
                if same:
                    resid[8::8] -= vals
                else:
                    nq = int(qs_tab[nq_i])
                    for i in range(7):
                        resid[8 * (i + 1)] -= _rdiv(int(vals[i]) * nq, q)
                scan = np.asarray(alternate_scan())
            else:
                vals = acv[g_][by_ - 1, bx_, 7:14]
                nq_i = (mb_y - 1) * self.mb_w + mb_x
                same = (mb_y == 0 or b in (2, 3) or
                        int(qs_tab[nq_i]) == q)
                if same:
                    resid[1:8] -= vals
                else:
                    nq = int(qs_tab[nq_i])
                    for i in range(7):
                        resid[i + 1] -= _rdiv(int(vals[i]) * nq, q)
                scan = np.asarray(alternate_horizontal_scan())
            # this block's own (unsubtracted) column/row, for later
            # neighbors — stored after the prediction read above
            _store_ac(raster, b, mb_x, mb_y, acv)
            scanned = resid[scan]
            out.append((scanned, pred_lvl))
        return out
