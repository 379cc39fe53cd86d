"""mpegvideo device programs: MPEG-1/2, H.263 and MPEG-4 reconstruction,
and the MPEG-1/2 and MPEG-4 encoders' picture programs (counterpart of
`libav_tpu/codecs/mpegvideo.py` recon_jit, recon_field_jit,
fields_of_frame_jit, weave_fields_jit, zero_pad_refs, encode_jit,
encode_b_jit, encode_field_stress_jit and encode_b_h263_jit, and of
`libav_tpu/codecs/mpeg4/enc.py` _gmc_resid_jit; reference: mpegvideo.c
ff_mpv_decode_mb, mpegvideo_motion.c and the device half of
mpegvideo_enc.c).

One program per coded picture, the JAX package's stages:
  1. residual: dequant (MPEG-1, MPEG-2, H.263 with the MPEG-4 DC scaler,
     H.263 with the short header's fixed DC scaler 8 ('h263sh') or
     WMV1's DC scale tables ('wmv1'), or the MPEG-4 matrix quantiser with
     its parity fix; intra/inter per MB), the inverse scan, MPEG-2
     mismatch control, and the 8x8 IDCT of every block of the picture in
     one launch of kernel K2 (ops/idct.py);
  2. prediction: half-pel or MPEG-4 quarter-sample MC of luma and chroma
     from one or two references, 8x8 vectors where a macroblock has four
     (4MV, B direct), combined per MB (forward, backward or averaged);
     frame pictures add field MC, field DCT and dual prime, field
     pictures pick a reference field per 16x8 half;
  3. assembly: prediction + residual, clamped, laid out as planes, and
     the edge-padded planes the next picture predicts from.
The decoder's programs (`Recon`, `ReconField`) split at K2: stage A is
stage 1 up to the IDCT, stage B the rest after it. The
MPEG-1/2 decoder runs them through `recon_graphed` and
`recon_field_graphed`, which replay both stages from CUDA graphs on the
card with K2 launched eagerly between them (codecs/cudagraph.py).

The encoder's programs (`Encode`, `EncodeB`, `EncodeBMpeg`,
`EncodeFieldStress`, `GMCResidual`) run motion search (ops/me.py; bounded
to the picture for MPEG-1/2), prediction, the residual, the forward DCT
(ops/fdct.py) and the H.263, MPEG-4 matrix or MPEG-1/2 quantiser for
every macroblock at once, with the SAD or the Hadamard (SATD,
ops/mecmp.py) intra/inter decision; the encoders then reconstruct their
anchors through `Recon` or `ReconField`, the decoder's programs, so the
prediction loop is closed through K2.

Each program is an nn.Module whose per-geometry constants (inverse scan,
macroblock origins) are registered buffers, built by an lru_cached
factory with the JAX factory's key plus the device. Where the JAX
program picks between two reference fields with `where` over two MCs,
this one gathers from the stacked pair with a per-block index: the same
pixels, half the work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.avutil import timer
from libav_tpu_torch.codecs import cudagraph, msmpeg4_tables
from libav_tpu_torch.ops.quant import alternate_scan, zigzag_scan
from libav_tpu_torch.ops import quant as quant_ops
from libav_tpu_torch.ops.fdct import fdct8x8_int
from libav_tpu_torch.ops.idct import idct8x8_int
from libav_tpu_torch.ops.mc import (EDGE, avg_pred, chroma_mv_4mv_hpel,
                                    chroma_mv_4mv_qpel, chroma_mv_div2,
                                    chroma_mv_h263, chroma_mv_qpel,
                                    mc_hpel, mc_hpel_tiled8, mc_qpel_mpeg4,
                                    mc_qpel_mpeg4_tiled8, pad_plane,
                                    pad_rows)
from libav_tpu_torch.ops.me import FullPelSearch, HpelRefine
from libav_tpu_torch.ops.mecmp import satd16_of

# the H.263/MPEG-4 family's quantiser kinds; they derive chroma vectors
# with the rounding rule (motion_est.h:96), not MPEG-1/2 truncation
H263_KINDS = ("h263", "h263sh", "wmv1", "mpeg4", "mpeg4mq")
MPEG12_KINDS = ("mpeg1", "mpeg2")
RECON_KINDS = MPEG12_KINDS + H263_KINDS


def _combine(pf, pb, use_fwd, use_bwd):
    """Per-MB forward, backward or averaged prediction (0 if neither)."""
    both = (use_fwd & use_bwd)[:, None, None]
    f_only = (use_fwd & ~use_bwd)[:, None, None]
    b_only = (~use_fwd & use_bwd)[:, None, None]
    return torch.where(both, avg_pred(pf, pb),
                       torch.where(f_only, pf, torch.where(b_only, pb, 0)))


def _interleave_rows(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(..., h, w) x 2 -> (..., 2h, w) with even rows first."""
    out = even.new_empty((*even.shape[:-2], 2 * even.shape[-2],
                          even.shape[-1]))
    out[..., 0::2, :] = even
    out[..., 1::2, :] = odd
    return out


class _Picture(nn.Module):
    """Shared per-geometry constants and the residual / assembly stages
    of a picture of mb_w x mb_h macroblocks."""

    def __init__(self, mb_w: int, mb_h: int, alt_scan: bool,
                 quant_kind: str):
        super().__init__()
        self.mb_w, self.mb_h, self.nmb = mb_w, mb_h, mb_w * mb_h
        self.quant_kind = quant_kind
        self.chroma_mv = chroma_mv_h263 if quant_kind in H263_KINDS \
            else chroma_mv_div2
        self.register_buffer("pos", quant_ops.raster_positions(
            alternate_scan() if alt_scan else zigzag_scan()))
        self.register_buffer("luma_blk", torch.as_tensor(
            np.tile([True] * 4 + [False] * 2, self.nmb)))
        mbx = np.arange(self.nmb) % mb_w
        mby = np.arange(self.nmb) // mb_w
        for name, a in (("x16", mbx * 16), ("y16", mby * 16),
                        ("x8", mbx * 8), ("y8", mby * 8), ("y4", mby * 4)):
            self.register_buffer(name, torch.as_tensor(a.astype(np.int32)))
        if quant_kind == "wmv1":
            # WMV1 / msmpeg4 v4 DC scale tables (msmpeg4data.c), by qscale
            for name in ("WMV1_Y_DC_SCALE", "WMV1_C_DC_SCALE"):
                self.register_buffer(name.lower(), torch.as_tensor(
                    np.array(getattr(msmpeg4_tables, name), np.int32)))

    def dc_scale(self, qs: torch.Tensor) -> torch.Tensor:
        """Per-block intra DC scaler of the H.263 family's kinds: the
        MPEG-4 table, 8 for the H.263 short header (INTRADC is an 8-bit
        FLC), or WMV1's tables indexed by clip(qscale, 0, 31)."""
        if self.quant_kind == "h263sh":
            return torch.full_like(qs, 8)
        if self.quant_kind == "wmv1":
            q = qs.clamp(0, 31).long()
            return torch.where(self.luma_blk, self.wmv1_y_dc_scale[q],
                               self.wmv1_c_dc_scale[q])
        return quant_ops.dc_scaler(qs, self.luma_blk)

    def dequant(self, coeffs, qscale, intra, intra_q, inter_q):
        """(nmb, 6, 64) scan-order levels -> the (6 nmb, 8, 8) int32
        blocks K2 transforms: dequant, inverse scan, mismatch control."""
        n6 = self.nmb * 6
        c = coeffs.reshape(n6, 64).to(torch.int32)
        qs = qscale.to(torch.int32).repeat_interleave(6)
        intra_b = intra.repeat_interleave(6)[:, None]
        if self.quant_kind == "mpeg1":
            deq_i = quant_ops.mpeg1_dequant_intra(c, qs, intra_q)
            deq_p = quant_ops.mpeg1_dequant_inter(c, qs, inter_q)
        elif self.quant_kind == "mpeg4mq":
            # MPEG-4 quant_type 1: matrix quant, bitexact mismatch
            dcs = quant_ops.dc_scaler(qs, self.luma_blk)
            deq_i = quant_ops.mpeg4_mq_dequant_intra(c, qs, intra_q, dcs)
            deq_p = quant_ops.mpeg4_mq_dequant_inter(c, qs, inter_q)
        elif self.quant_kind in ("h263", "h263sh", "wmv1", "mpeg4"):
            dcs = self.dc_scale(qs)
            deq_i = quant_ops.h263_dequant(c, qs, dcs, True)
            deq_p = quant_ops.h263_dequant(c, qs, dcs, False)
        else:
            deq_i = quant_ops.mpeg2_dequant_intra(c, qs, intra_q)
            deq_p = quant_ops.mpeg2_dequant_inter(c, qs, inter_q)
        blocks = quant_ops.dezigzag(torch.where(intra_b, deq_i, deq_p),
                                    self.pos)
        if self.quant_kind == "mpeg2":
            blocks = quant_ops.mpeg2_mismatch_control(blocks)
        return blocks.contiguous()

    def mc6(self, refs, mv, rnd: int, ridx=None, chroma_mv=None):
        """Luma 16x16 and chroma 8x8 half-pel MC of every MB from the
        (y, u, v) padded references (or stacks of them, with ridx); the
        chroma vectors by chroma_mv (default: the quantiser kind's)."""
        cmv = (chroma_mv or self.chroma_mv)(mv)
        return (mc_hpel(refs[0], self.x16, self.y16, mv[:, 0], mv[:, 1], 16,
                        rnd, ridx),
                mc_hpel(refs[1], self.x8, self.y8, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx),
                mc_hpel(refs[2], self.x8, self.y8, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx))

    def assemble(self, pred, luma_res, resid):
        """Prediction + residual -> (planes, edge-padded planes), uint8."""
        mb_h, mb_w = self.mb_h, self.mb_w
        res = (luma_res, resid[:, 4], resid[:, 5])
        planes = []
        for p, r, s in zip(pred, res, (16, 8, 8)):
            blk = (p + r).clamp(0, 255).to(torch.uint8)
            planes.append(blk.reshape(mb_h, mb_w, s, s).permute(0, 2, 1, 3)
                          .reshape(mb_h * s, mb_w * s))
        return tuple(planes), tuple(pad_plane(p) for p in planes)

    def luma_residual(self, resid):
        """Blocks 0-3 of each MB in raster order -> (nmb, 16, 16)."""
        return (resid[:, :4].reshape(self.nmb, 2, 2, 8, 8)
                .permute(0, 1, 3, 2, 4).reshape(self.nmb, 16, 16))

    def zero_pred(self, device):
        return (torch.zeros((self.nmb, 16, 16), dtype=torch.int32,
                            device=device),
                torch.zeros((self.nmb, 8, 8), dtype=torch.int32,
                            device=device),
                torch.zeros((self.nmb, 8, 8), dtype=torch.int32,
                            device=device))


class _Recon(_Picture):
    """A decoder's recon program, split at K2: `stage_a` of forward's
    arguments -> the (6 nmb, 8, 8) int32 blocks K2 transforms, `kernel`
    (K2), `stage_b` of K2's output and the same arguments -> (planes,
    edge-padded planes), uint8. forward runs stage A, K2, stage B;
    codecs/cudagraph.py replays the two stages from CUDA graphs around
    the same `kernel`."""

    def forward(self, *args, **kw):
        return self.stage_b(self.kernel(self.stage_a(*args, **kw)),
                            *args, **kw)

    @staticmethod
    def kernel(blocks):
        # the module's name, looked up at each call on either path, so a
        # stand-in set over it (avbench/control.py) reaches both
        return idct8x8_int(blocks)


class Recon(_Recon):
    """Frame-picture recon; the JAX recon_jit program. interlaced=True
    adds the frame-picture interlace tools: 16x8 field MC (two field
    vectors and field selects per direction), field DCT, and with
    dual=True dual prime. qpel=True takes quarter-sample vectors (MPEG-4
    8-tap luma MC, chroma by qpel_motion's rule); any_4mv=True adds the
    per-MB use4 flag and the 8x8 vectors mv4f/mv4b (B, 4, 2), whose luma
    is four 8x8 blocks and whose chroma vector comes from their sum."""

    def __init__(self, mb_w: int, mb_h: int, quant_kind: str,
                 alt_scan: bool, inter_frame: bool, rounding: int = 0,
                 interlaced: bool = False, qpel: bool = False,
                 dual: bool = False, any_4mv: bool = False):
        if quant_kind not in RECON_KINDS:
            raise ValueError(f"no recon quantiser {quant_kind!r}")
        super().__init__(mb_w, mb_h, alt_scan, quant_kind)
        self.inter_frame, self.rounding = inter_frame, rounding
        self.interlaced, self.dual = interlaced, dual
        self.qpel, self.any_4mv = qpel, any_4mv

    def pred_dir(self, refs, mv, mv4, use4, rnd):
        """One direction's (luma, U, V) prediction of every MB: half- or
        quarter-sample, from four 8x8 vectors where use4."""
        if self.qpel:
            y = mc_qpel_mpeg4(refs[0], self.x16, self.y16, mv[:, 0],
                              mv[:, 1], no_rnd=self.rounding)
            cmv = chroma_mv_qpel(mv)
        else:
            y = mc_hpel(refs[0], self.x16, self.y16, mv[:, 0], mv[:, 1], 16,
                        rnd)
            cmv = self.chroma_mv(mv)
        if self.any_4mv:
            # MV_TYPE_8X8: the 8-wide qpel reflection changes the samples
            # against one 16x16 block
            if self.qpel:
                y4 = mc_qpel_mpeg4_tiled8(refs[0], self.x16, self.y16, mv4,
                                          no_rnd=self.rounding)
                c4 = chroma_mv_4mv_qpel(mv4)
            else:
                y4 = mc_hpel_tiled8(refs[0], self.x16, self.y16, mv4, rnd)
                c4 = chroma_mv_4mv_hpel(mv4)
            y = torch.where(use4[:, None, None], y4, y)
            cmv = torch.where(use4[:, None], c4, cmv)
        return (y,
                mc_hpel(refs[1], self.x8, self.y8, cmv[:, 0], cmv[:, 1], 8,
                        rnd),
                mc_hpel(refs[2], self.x8, self.y8, cmv[:, 0], cmv[:, 1], 8,
                        rnd))

    def field_pred(self, ry, ru, rv, mv2, sel, rnd):
        """16x8-per-field MC from the padded frame references: mv2
        (nmb, 2, 2) field vectors, sel (nmb, 2) source field per
        destination field -> interleaved (nmb, 16, 16) luma and
        (nmb, 8, 8) chroma predictions."""
        # field planes: only the rows are stripped and re-padded; the
        # columns keep the frame's padding
        refs = []
        for p in (ry, ru, rv):
            core = p[EDGE:p.shape[0] - EDGE]
            refs.append(torch.stack((pad_rows(core[0::2]),
                                     pad_rows(core[1::2]))))
        halves = []
        for f in range(2):              # destination field
            mv = mv2[:, f]
            cmv = self.chroma_mv(mv)
            ridx = sel[:, f] != 0
            halves.append((
                mc_hpel(refs[0], self.x16, self.y8, mv[:, 0], mv[:, 1], 16,
                        rnd, ridx)[:, :8],
                mc_hpel(refs[1], self.x8, self.y4, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx)[:, :4],
                mc_hpel(refs[2], self.x8, self.y4, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx)[:, :4]))
        return tuple(_interleave_rows(t, b) for t, b in zip(*halves))

    def stage_a(self, coeffs, qscale, intra, use_fwd, use_bwd, mv_fwd,
                mv_bwd, intra_q, inter_q, *refs, **tools):
        return self.dequant(coeffs, qscale, intra, intra_q, inter_q)

    def stage_b(self, idct, coeffs, qscale, intra, use_fwd, use_bwd, mv_fwd,
                mv_bwd, intra_q, inter_q, r0y, r0u, r0v, r1y, r1u, r1v,
                field_mc=None, dct_field=None, mvf2=None, mvb2=None,
                sel_f=None, sel_b=None, dp=None, mv_dp2=None, sel_dp=None,
                use4=None, mv4f=None, mv4b=None):
        resid = idct.reshape(self.nmb, 6, 8, 8)
        if self.inter_frame:
            rnd = 1 - self.rounding
            fwd = self.pred_dir((r0y, r0u, r0v), mv_fwd, mv4f, use4, rnd)
            bwd = self.pred_dir((r1y, r1u, r1v), mv_bwd, mv4b, use4, rnd)
            if self.interlaced:
                fm = field_mc[:, None, None]
                ffld = self.field_pred(r0y, r0u, r0v, mvf2, sel_f, rnd)
                bfld = self.field_pred(r1y, r1u, r1v, mvb2, sel_b, rnd)
                fwd = [torch.where(fm, a, b) for a, b in zip(ffld, fwd)]
                bwd = [torch.where(fm, a, b) for a, b in zip(bfld, bwd)]
                if self.dual:
                    # frame-picture dual prime: the same-parity field
                    # prediction averaged with the cross-parity one from
                    # the derived vectors (13818-2 7.6.3.6)
                    opp = self.field_pred(r0y, r0u, r0v, mv_dp2, sel_dp, rnd)
                    dpm = dp[:, None, None]
                    fwd = [torch.where(dpm, avg_pred(a, o), a)
                           for a, o in zip(fwd, opp)]
            im = intra[:, None, None]
            pred = [torch.where(im, 0, _combine(f, b, use_fwd, use_bwd))
                    for f, b in zip(fwd, bwd)]
        else:
            pred = self.zero_pred(resid.device)

        luma_res = self.luma_residual(resid)
        if self.interlaced:
            # field DCT: blocks 0/1 hold the top-field lines, 2/3 the
            # bottom-field lines (ISO 13818-2 figure 6-13)
            fr = _interleave_rows(torch.cat([resid[:, 0], resid[:, 1]], 2),
                                  torch.cat([resid[:, 2], resid[:, 3]], 2))
            luma_res = torch.where(dct_field[:, None, None], fr, luma_res)
        return self.assemble(pred, luma_res, resid)


class ReconField(_Recon):
    """Field-picture recon (ISO 13818-2 7.6.2); the JAX recon_field_jit
    program. The picture is one field of mb_w x mb_h_f MBs; references
    arrive as padded field planes per parity, (f0t, f0b) forward or most
    recent and (f1t, f1b) backward. Per MB two (vector, field select)
    rows cover the upper and lower 16x8 halves; dual=True adds dual
    prime, the average of two whole-field predictions."""

    def __init__(self, mb_w: int, mb_h_f: int, alt_scan: bool,
                 inter_frame: bool, dual: bool = False):
        super().__init__(mb_w, mb_h_f, alt_scan, "mpeg2")
        self.inter_frame, self.dual = inter_frame, dual

    def stage_a(self, coeffs, qscale, intra, use_fwd, use_bwd, mvf2, sel_f,
                mvb2, sel_b, intra_q, inter_q, *refs, **dual):
        return self.dequant(coeffs, qscale, intra, intra_q, inter_q)

    def stage_b(self, idct, coeffs, qscale, intra, use_fwd, use_bwd,
                mvf2, sel_f, mvb2, sel_b, intra_q, inter_q,
                f0ty, f0tu, f0tv, f0by, f0bu, f0bv,
                f1ty, f1tu, f1tv, f1by, f1bu, f1bv,
                dp=None, mv_dp2=None, sel_dp=None):
        resid = idct.reshape(self.nmb, 6, 8, 8)
        if self.inter_frame:
            fref = [torch.stack(tb) for tb in
                    ((f0ty, f0by), (f0tu, f0bu), (f0tv, f0bv))]
            bref = [torch.stack(tb) for tb in
                    ((f1ty, f1by), (f1tu, f1bu), (f1tv, f1bv))]

            def whole(refs, mv, sel):
                """16-row field MC from the top/bottom reference pair."""
                return self.mc6(refs, mv, 1, sel != 0)

            def halves(refs, mv2, sel):
                """upper/lower 16x8 halves from the two vector rows."""
                upper = whole(refs, mv2[:, 0], sel[:, 0])
                lower = whole(refs, mv2[:, 1], sel[:, 1])
                return [torch.cat([a[:, :a.shape[1] // 2],
                                   b[:, b.shape[1] // 2:]], 1)
                        for a, b in zip(upper, lower)]

            fwd = halves(fref, mvf2, sel_f)
            bwd = halves(bref, mvb2, sel_b)
            if self.dual:
                same = whole(fref, mvf2[:, 0], sel_f[:, 0])
                opp = whole(fref, mv_dp2[:, 0], sel_dp[:, 0])
                dpm = dp[:, None, None]
                fwd = [torch.where(dpm, avg_pred(a, o), f)
                       for a, o, f in zip(same, opp, fwd)]
            im = intra[:, None, None]
            pred = [torch.where(im, 0, _combine(f, b, use_fwd, use_bwd))
                    for f, b in zip(fwd, bwd)]
        else:
            pred = self.zero_pred(resid.device)
        return self.assemble(pred, self.luma_residual(resid), resid)


class _EncodePicture(_Picture):
    """Shared stages of the encoder's picture programs over mb_w x mb_h
    macroblocks: the source and prediction as (nmb, 6, 8, 8) blocks,
    the motion search against one reference (bounded to the picture for
    the MPEG-1/2 kinds), FDCT, and the quantisers of MPEG-4 quant_type 0
    ('h263') and 1 ('mpeg4mq') and of MPEG-1 and MPEG-2."""

    def __init__(self, mb_w: int, mb_h: int, search_range: int,
                 quant_kind: str = "h263"):
        if quant_kind not in ("h263", "mpeg4mq") + MPEG12_KINDS:
            raise ValueError(f"no encoder quantiser {quant_kind!r}")
        super().__init__(mb_w, mb_h, False, quant_kind)
        self.register_buffer("zz", torch.as_tensor(
            zigzag_scan().astype(np.int64)))
        bounded = quant_kind in MPEG12_KINDS
        self.fullpel = FullPelSearch(mb_w, mb_h, search_range, bounded)
        self.refine = HpelRefine(mb_w, mb_h, bounded)

    def mbs(self, plane: torch.Tensor, s: int) -> torch.Tensor:
        """(mb_h * s, mb_w * s) plane -> (nmb, s, s) int32."""
        return (plane.reshape(self.mb_h, s, self.mb_w, s).permute(0, 2, 1, 3)
                .reshape(self.nmb, s, s).to(torch.int32))

    def blocks(self, y, u, v) -> torch.Tensor:
        """Per-MB (nmb, 16, 16) luma, (nmb, 8, 8) chroma -> (nmb, 6, 8, 8):
        the four luma blocks in raster order, then U and V."""
        yb = (y.reshape(self.nmb, 2, 8, 2, 8).permute(0, 1, 3, 2, 4)
              .reshape(self.nmb, 4, 8, 8))
        return torch.cat([yb, u[:, None], v[:, None]], 1)

    def source(self, cur_y, cur_u, cur_v):
        """-> (luma MBs (nmb, 16, 16), blocks (nmb, 6, 8, 8)), int32."""
        y = self.mbs(cur_y, 16)
        return y, self.blocks(y, self.mbs(cur_u, 8), self.mbs(cur_v, 8))

    def motion(self, cur_mbs, ref_y):
        """Full-pel diamond search, then the half-pel refine: -> (half-pel
        vectors (nmb, 2), SAD (nmb,)), int32."""
        fmv, _ = self.fullpel(cur_mbs, ref_y)
        return self.refine(cur_mbs, ref_y, fmv)

    def quantize(self, src, qscale, intra=None, intra_qmat_zz=None,
                 inter_qmat_zz=None):
        """(nmb, 6, 8, 8) int32 -> (FDCT coefficients (n6, 64) raster,
        the same in zigzag order, levels (n6, 64) zigzag). 'h263':
        sign(c) (|c| // 16 q), clipped to +-255. The matrix kinds: the
        steps q M in zigzag order ('mpeg2': max(q M // 2, 1), its dequant
        carrying one more fractional bit), rounded for intra blocks (the
        (nmb,) flags intra; None: all inter) and truncated for inter
        ones, clipped to +-255 ('mpeg1') or +-2047 ('mpeg4mq', 'mpeg2').
        (The JAX MPEG-4 B program floors its steps at 1, which never
        binds: q >= 1 and every matrix entry is >= 1, a 0 ending the
        VOL's list.)"""
        coeffs8 = fdct8x8_int(src.reshape(self.nmb * 6, 8, 8)) \
            .reshape(self.nmb * 6, 64)
        czz = coeffs8[:, self.zz]
        qs6 = qscale.to(torch.int32).repeat_interleave(6)[:, None]
        if self.quant_kind == "h263":
            levels = (torch.sign(czz) * (czz.abs() // (16 * qs6))) \
                .clamp(-255, 255)
            return coeffs8, czz, levels
        # MPEG-4 quant_type 1 and MPEG-1: the >>3 / >>4 scale of their
        # dequant pairs, which these steps invert
        def steps(qmat_zz):
            q = qs6 * qmat_zz.to(torch.int32)[None, :]
            return (q // 2).clamp(min=1) if self.quant_kind == "mpeg2" else q
        qp = steps(inter_qmat_zz)
        lv = torch.sign(czz) * (czz.abs() // qp)
        if intra is not None:
            qi = steps(intra_qmat_zz)
            lv_i = torch.sign(czz) * ((czz.abs() + qi // 2) // qi)
            lv = torch.where(intra.repeat_interleave(6)[:, None], lv_i, lv)
        lim = 255 if self.quant_kind == "mpeg1" else 2047
        return coeffs8, czz, lv.clamp(-lim, lim)


class Encode(_EncodePicture):
    """I or P picture encode, the JAX encode_jit program for the MPEG-4
    kinds 'h263' (quant_type 0) and 'mpeg4mq' (quant_type 1) and the
    MPEG-1/2 kinds 'mpeg1' and 'mpeg2' (the matrices in zigzag order):
    pixels (+ reference) -> levels (nmb, 6, 64) in zigzag order, half-pel
    vectors and intra decisions. The MPEG-1/2 kinds search inside the
    picture only. With
    mbcmp 'sad' a P macroblock goes intra when its SAD about its mean,
    plus 256, is below its best inter SAD; with 'satd' the same test on
    16x16 Hadamard costs (the mean difference truncated to integers, as
    the JAX program's float32 mean and int32 cast do). The residual's
    chroma prediction uses MPEG-1/2 chroma vectors, as the JAX program's
    does. Intra DC levels: the MPEG-4 kinds round by the DC scaler; the
    MPEG-1/2 kinds carry the DC in pixels, clip((dc8 + 32) >> 6, 0,
    255), times 8 for 'mpeg2' (IDCT units at intra_dc_precision 0)."""

    def __init__(self, mb_w: int, mb_h: int, inter: bool,
                 search_range: int = 15, want_coeffs: bool = False,
                 quant_kind: str = "h263", mbcmp: str = "sad"):
        if mbcmp not in ("sad", "satd"):
            raise ValueError(f"no mbcmp {mbcmp!r}")
        super().__init__(mb_w, mb_h, search_range, quant_kind)
        self.inter, self.want_coeffs = inter, want_coeffs
        self.mbcmp = mbcmp

    def forward(self, cur_y, cur_u, cur_v, qscale, intra_qmat_zz,
                inter_qmat_zz, r0y, r0u, r0v):
        cur_mbs, blocks = self.source(cur_y, cur_u, cur_v)
        dev = blocks.device
        if self.inter:
            mv, sad = self.motion(cur_mbs, r0y)
            s = cur_mbs.sum(dim=(1, 2), dtype=torch.int32)[:, None, None]
            if self.mbcmp == "satd":
                # trunc(x - S/256): the JAX program's float32 difference
                # is exact (multiples of 1/256 below 2^8) and its int32
                # cast truncates toward zero
                dmean = torch.div(256 * cur_mbs - s, 256,
                                  rounding_mode="trunc")
                pred16 = mc_hpel(r0y, self.x16, self.y16, mv[:, 0],
                                 mv[:, 1], 16)
                use_intra = satd16_of(dmean) + 256 < \
                    satd16_of(cur_mbs - pred16)
            else:
                # floor(sum |x - S/256|) in integers: the JAX program's
                # float32 sum is exact (multiples of 1/256 below 2^16)
                intra_cost = (256 * cur_mbs - s).abs().sum(
                    dim=(1, 2), dtype=torch.int32) >> 8
                use_intra = intra_cost + 256 < sad
            pred = self.mc6((r0y, r0u, r0v), mv, 1, chroma_mv=chroma_mv_div2)
            src = torch.where(use_intra[:, None, None, None], blocks,
                              blocks - self.blocks(*pred))
        else:
            mv = torch.zeros((self.nmb, 2), dtype=torch.int32, device=dev)
            use_intra = torch.ones((self.nmb,), dtype=torch.bool, device=dev)
            src = blocks
        coeffs8, czz, levels = self.quantize(src, qscale, use_intra,
                                             intra_qmat_zz, inter_qmat_zz)
        dc8 = coeffs8[:, 0]
        if self.quant_kind in MPEG12_KINDS:
            # an arithmetic shift of the int32 DC
            dc_lvl = ((dc8 + 32) >> 6).clamp(0, 255)
            if self.quant_kind == "mpeg2":
                dc_lvl = dc_lvl * 8
        else:
            # intra DC by the DC scaler (true DCT scale = coeffs8 / 8)
            qs6 = qscale.to(torch.int32).repeat_interleave(6)
            qdc = 8 * quant_ops.dc_scaler(qs6, self.luma_blk)
            dc_lvl = torch.sign(dc8) * ((dc8.abs() + qdc // 2) // qdc)
        levels[:, 0] = torch.where(use_intra.repeat_interleave(6), dc_lvl,
                                   levels[:, 0])
        out = (levels.reshape(self.nmb, 6, 64), mv, use_intra)
        if self.want_coeffs:
            return out + (czz.reshape(self.nmb, 6, 64),)
        return out


class EncodeB(_EncodePicture):
    """B picture encode, the JAX encode_b_h263_jit program: forward and
    backward half-pel search, a per-MB choice of forward, backward or bi
    prediction by luma SAD (bi, (a + b + 1) >> 1, wins only by more than
    128), the residual's FDCT and the inter quantiser ('h263' or
    'mpeg4mq'). -> (levels (nmb, 6, 64)
    zigzag, forward and backward vectors, sel 0 forward, 1 backward, 2
    bi, the chosen mode's SAD)."""

    def __init__(self, mb_w: int, mb_h: int, search_range: int = 12,
                 quant_kind: str = "h263"):
        super().__init__(mb_w, mb_h, search_range, quant_kind)

    def forward(self, cur_y, cur_u, cur_v, qscale, intra_qmat_zz,
                inter_qmat_zz, r0y, r0u, r0v, r1y, r1u, r1v):
        cur_mbs, blocks = self.source(cur_y, cur_u, cur_v)
        mv_f, sad_f = self.motion(cur_mbs, r0y)
        mv_b, sad_b = self.motion(cur_mbs, r1y)
        pf = self.mc6((r0y, r0u, r0v), mv_f, 1)
        pb = self.mc6((r1y, r1u, r1v), mv_b, 1)
        sad_bi = (cur_mbs - ((pf[0] + pb[0] + 1) >> 1)).abs().sum(
            dim=(1, 2), dtype=torch.int32)
        sel = torch.where(sad_bi + 128 < torch.minimum(sad_f, sad_b), 2,
                          torch.where(sad_b < sad_f, 1, 0)).to(torch.int32)
        sad = torch.where(sel == 2, sad_bi, torch.where(sel == 1, sad_b,
                                                        sad_f))
        m = sel[:, None, None]
        pred = [torch.where(m == 2, (a + b + 1) >> 1,
                            torch.where(m == 1, b, a)) for a, b in zip(pf, pb)]
        _, _, levels = self.quantize(blocks - self.blocks(*pred), qscale,
                                     None, intra_qmat_zz, inter_qmat_zz)
        return levels.reshape(self.nmb, 6, 64), mv_f, mv_b, sel, sad


class EncodeBMpeg(_EncodePicture):
    """B picture encode of the MPEG-1/2 encoders, the JAX encode_b_jit
    program: forward and backward half-pel search inside the picture,
    MPEG-1/2 chroma vectors, a per-MB mode, the first minimum of (forward
    SAD, backward SAD, bi SAD + 64), the residual's FDCT and the inter
    quantiser. -> (levels (nmb, 6, 64) zigzag, forward and backward
    vectors, use_fwd, use_bwd; bi sets both)."""

    def __init__(self, mb_w: int, mb_h: int, quant_kind: str = "mpeg1",
                 search_range: int = 15):
        if quant_kind not in MPEG12_KINDS:
            raise ValueError(f"no MPEG-1/2 quantiser {quant_kind!r}")
        super().__init__(mb_w, mb_h, search_range, quant_kind)

    def forward(self, cur_y, cur_u, cur_v, qscale, inter_qmat_zz,
                r0y, r0u, r0v, r1y, r1u, r1v):
        cur_mbs, blocks = self.source(cur_y, cur_u, cur_v)
        mvf, sadf = self.motion(cur_mbs, r0y)
        mvb, sadb = self.motion(cur_mbs, r1y)
        pf = self.mc6((r0y, r0u, r0v), mvf, 1)
        pb = self.mc6((r1y, r1u, r1v), mvb, 1)
        sadbi = (cur_mbs - avg_pred(pf[0], pb[0])).abs().sum(
            dim=(1, 2), dtype=torch.int32)
        # argmin over (sadf, sadb, sadbi + 64), a tie to the first, by
        # explicit comparisons
        sadbi = sadbi + 64
        fwd = (sadf <= sadb) & (sadf <= sadbi)
        bwd = ~fwd & (sadb <= sadbi)
        use_fwd, use_bwd = ~bwd, ~fwd
        m = (fwd.to(torch.int32) + 2 * bwd.to(torch.int32))[:, None, None]
        pred = [torch.where(m == 1, a, torch.where(m == 2, b,
                                                   avg_pred(a, b)))
                for a, b in zip(pf, pb)]
        _, _, levels = self.quantize(blocks - self.blocks(*pred), qscale,
                                     None, None, inter_qmat_zz)
        return levels.reshape(self.nmb, 6, 64), mvf, mvb, use_fwd, use_bwd


def field_mode_pattern(mb_w: int, mb_h_f: int, pattern: str) -> np.ndarray:
    """The field_motion_type of each MB of a P field picture of the
    field-stress generator: 0 whole-field same parity, 1 whole-field
    opposite parity, 2 16x8 (upper same, lower opposite), 3 dual prime,
    by pattern 'same', 'opp', 'whole', 'h16', 'dponly' or 'full' (all
    four in turn). Dual prime only on interior MBs: the reference
    decoder skips any motion compensation whose window leaves the
    picture, so a conforming stream keeps the derived cross-parity
    vector in bounds with a whole MB of margin."""
    nmb = mb_w * mb_h_f
    diag = np.arange(nmb) + np.arange(nmb) // mb_w
    mode_pat = {"same": np.zeros(nmb, dtype=np.int64),
                "opp": np.ones(nmb, dtype=np.int64),
                "whole": diag % 2, "h16": (diag % 2) * 2,
                "dponly": (diag % 2) * 3}.get(pattern, diag % 4)
    bx = np.arange(nmb) % mb_w
    by = np.arange(nmb) // mb_w
    interior = (bx > 0) & (bx < mb_w - 1) & (by > 0) & (by < mb_h_f - 1)
    return np.where((mode_pat == 3) & ~interior, 0, mode_pat)


class EncodeFieldStress(_EncodePicture):
    """P field picture encode of the MPEG-2 field-stress generator, the
    JAX encode_field_stress_jit program: one bounded field search against
    the same-parity reference field supplies the vector of every MB,
    whose field_motion_type is `mode_pat` (field_mode_pattern): the
    same-parity or opposite-parity whole-field prediction, the 16x8 pair
    (upper same, lower opposite), or dual prime with dmv = 0 (the average
    of the same-parity prediction and the opposite one from the derived
    vector ((v + (v > 0)) >> 1), y -1 for a top field, +1 for a bottom
    one). -> (levels (nmb, 6, 64) zigzag, vectors) in field geometry."""

    def __init__(self, mb_w: int, mb_h_f: int, parity: int,
                 search_range: int = 15, pattern: str = "full"):
        super().__init__(mb_w, mb_h_f, search_range, "mpeg2")
        self.parity = parity
        self.mode_pat = field_mode_pattern(mb_w, mb_h_f, pattern)
        self.register_buffer("pat", torch.as_tensor(self.mode_pat)[:, None,
                                                                   None])

    def forward(self, src_y, src_u, src_v, qscale, inter_qmat_zz,
                sty, stu, stv, sby, sbu, sbv):
        cur_mbs, blocks = self.source(src_y, src_u, src_v)
        same, opp = (sty, stu, stv), (sby, sbu, sbv)
        if self.parity:
            same, opp = opp, same
        mv, _ = self.motion(cur_mbs, same[0])
        ps = self.mc6(same, mv, 1)
        po = self.mc6(opp, mv, 1)
        dx = (mv[:, 0] + (mv[:, 0] > 0).to(torch.int32)) >> 1
        dy = ((mv[:, 1] + (mv[:, 1] > 0).to(torch.int32)) >> 1) + \
            (1 if self.parity else -1)
        pdp = self.mc6(opp, torch.stack([dx, dy], 1), 1)
        pat = self.pat
        pred = []
        for a, b, d in zip(ps, po, pdp):
            half = a.shape[1] // 2
            h16 = torch.cat([a[:, :half], b[:, half:]], 1)
            pred.append(torch.where(pat == 0, a, torch.where(
                pat == 1, b, torch.where(pat == 2, h16, avg_pred(a, d)))))
        _, _, levels = self.quantize(blocks - self.blocks(*pred), qscale,
                                     None, None, inter_qmat_zz)
        return levels.reshape(self.nmb, 6, 64), mv


class GMCResidual(_EncodePicture):
    """The levels of GMC macroblocks: source minus the zero-motion
    prediction from the warped reference planes, FDCT, H.263 inter quant
    (the JAX encoder's _gmc_resid_jit; GMC is coded with quant_type 0
    only)."""

    def __init__(self, mb_w: int, mb_h: int):
        super().__init__(mb_w, mb_h, 1)

    def forward(self, cur_y, cur_u, cur_v, wy, wu, wv, qscale):
        _, cur = self.source(cur_y, cur_u, cur_v)
        H, W = self.mb_h * 16, self.mb_w * 16
        _, pred = self.source(wy[EDGE:EDGE + H, EDGE:EDGE + W],
                              wu[EDGE:EDGE + H // 2, EDGE:EDGE + W // 2],
                              wv[EDGE:EDGE + H // 2, EDGE:EDGE + W // 2])
        _, _, levels = self.quantize(cur - pred, qscale)
        return levels.reshape(self.nmb, 6, 64)


class FieldsOfFrame(nn.Module):
    """Padded frame planes -> ((top y, u, v), (bottom y, u, v)) padded
    field planes: both dimensions stripped and re-padded."""

    def forward(self, y, u, v):
        tops, bots = [], []
        for p in (y, u, v):
            core = p[EDGE:p.shape[0] - EDGE, EDGE:p.shape[1] - EDGE]
            tops.append(pad_plane(core[0::2]))
            bots.append(pad_plane(core[1::2]))
        return tuple(tops), tuple(bots)


class WeaveFields(nn.Module):
    """(top, bottom) unpadded field planes -> frame planes and padded
    frame planes (for the reference DPB)."""

    def forward(self, ty, tu, tv, by, bu, bv):
        planes = tuple(_interleave_rows(t, b)
                       for t, b in ((ty, by), (tu, bu), (tv, bv)))
        return planes, tuple(pad_plane(p) for p in planes)


@functools.lru_cache(maxsize=64)
def recon(mb_w: int, mb_h: int, quant_kind: str, alt_scan: bool,
          inter_frame: bool, rounding: int = 0, interlaced: bool = False,
          qpel: bool = False, dual: bool = False, any_4mv: bool = False, *,
          device: torch.device) -> Recon:
    timer.count("programs.built", program="recon")
    return Recon(mb_w, mb_h, quant_kind, alt_scan, inter_frame, rounding,
                 interlaced, qpel, dual, any_4mv).to(device)


@functools.lru_cache(maxsize=32)
def recon_field(mb_w: int, mb_h_f: int, alt_scan: bool, inter_frame: bool,
                dual: bool = False, *, device: torch.device) -> ReconField:
    timer.count("programs.built", program="recon_field")
    return ReconField(mb_w, mb_h_f, alt_scan, inter_frame, dual).to(device)


def recon_graphed(*key, device: torch.device, **flags):
    """`recon`'s program run through its CUDA graphs
    (`cudagraph.graphed`, counters `mpeg2.recon.*`): the MPEG-1/2
    decoder's frame pictures."""
    return cudagraph.graphed(recon(*key, device=device, **flags),
                             "mpeg2.recon")


def recon_field_graphed(*key, device: torch.device, **flags):
    """`recon_field`'s program run through its CUDA graphs: the MPEG-2
    decoder's field pictures."""
    return cudagraph.graphed(recon_field(*key, device=device, **flags),
                             "mpeg2.recon")


@functools.lru_cache(maxsize=8)
def fields_of_frame(mb_w: int, mb_h: int, *,
                    device: torch.device) -> FieldsOfFrame:
    timer.count("programs.built", program="fields_of_frame")
    return FieldsOfFrame().to(device)


@functools.lru_cache(maxsize=8)
def weave_fields(mb_w: int, mb_h: int, *,
                 device: torch.device) -> WeaveFields:
    timer.count("programs.built", program="weave_fields")
    return WeaveFields().to(device)


@functools.lru_cache(maxsize=32)
def encode(mb_w: int, mb_h: int, inter: bool, quant_kind: str = "h263",
           search_range: int = 15, want_coeffs: bool = False,
           mbcmp: str = "sad", *, device: torch.device) -> Encode:
    timer.count("programs.built", program="encode")
    return Encode(mb_w, mb_h, inter, search_range, want_coeffs, quant_kind,
                  mbcmp).to(device)


@functools.lru_cache(maxsize=16)
def encode_b_h263(mb_w: int, mb_h: int, quant_kind: str = "h263",
                  search_range: int = 12, *,
                  device: torch.device) -> EncodeB:
    timer.count("programs.built", program="encode_b_h263")
    return EncodeB(mb_w, mb_h, search_range, quant_kind).to(device)


@functools.lru_cache(maxsize=16)
def encode_b(mb_w: int, mb_h: int, quant_kind: str = "mpeg1",
             search_range: int = 15, *, device: torch.device) -> EncodeBMpeg:
    timer.count("programs.built", program="encode_b")
    return EncodeBMpeg(mb_w, mb_h, quant_kind, search_range).to(device)


@functools.lru_cache(maxsize=16)
def encode_field_stress(mb_w: int, mb_h_f: int, parity: int,
                        search_range: int = 15, pattern: str = "full", *,
                        device: torch.device) -> EncodeFieldStress:
    """The field-stress P program; its `mode_pat` is the JAX factory's
    second result."""
    timer.count("programs.built", program="encode_field_stress")
    return EncodeFieldStress(mb_w, mb_h_f, parity, search_range,
                             pattern).to(device)


@functools.lru_cache(maxsize=8)
def gmc_residual(mb_w: int, mb_h: int, *,
                 device: torch.device) -> GMCResidual:
    timer.count("programs.built", program="gmc_residual")
    return GMCResidual(mb_w, mb_h).to(device)


@functools.lru_cache(maxsize=8)
def zero_pad_refs(mb_w: int, mb_h: int, *, device: torch.device):
    """Mid-grey padded (y, u, v) references for a picture with none."""
    H, W = mb_h * 16, mb_w * 16
    y = torch.full((H + 2 * EDGE, W + 2 * EDGE), 128, dtype=torch.uint8,
                   device=device)
    c = torch.full((H // 2 + 2 * EDGE, W // 2 + 2 * EDGE), 128,
                   dtype=torch.uint8, device=device)
    return (y, c, c)
