"""MPEG-1/2 device reconstruction (counterpart of
`libav_tpu/codecs/mpegvideo.py` recon_jit, recon_field_jit,
fields_of_frame_jit, weave_fields_jit and zero_pad_refs; reference:
mpegvideo.c ff_mpv_decode_mb and mpegvideo_motion.c).

One program per coded picture, the JAX package's stages:
  1. residual: dequant (MPEG-1 or MPEG-2, intra/inter per MB), the
     inverse scan, MPEG-2 mismatch control, and the 8x8 IDCT of every
     block of the picture in one launch of kernel K2 (ops/idct.py);
  2. prediction: half-pel MC of luma and chroma from one or two
     references, combined per MB (forward, backward or averaged); frame
     pictures add field MC, field DCT and dual prime, field pictures
     pick a reference field per 16x8 half;
  3. assembly: prediction + residual, clamped, laid out as planes, and
     the edge-padded planes the next picture predicts from.

Each program is an nn.Module whose per-geometry constants (inverse scan,
macroblock origins) are registered buffers, built by an lru_cached
factory with the JAX factory's key plus the device. Where the JAX
program picks between two reference fields with `where` over two MCs,
this one gathers from the stacked pair with a per-block index: the same
pixels, half the work.

Not ported (they raise NotImplementedError, see ROADMAP.md): the H.263
and MPEG-4 quantisers, quarter-sample MC and 4MV of the MPEG-4 family.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from libav_tpu.ops.quant import alternate_scan, zigzag_scan
from libav_tpu_torch.ops import quant as quant_ops
from libav_tpu_torch.ops.idct import idct8x8_int
from libav_tpu_torch.ops.mc import (EDGE, avg_pred, chroma_mv_div2, mc_hpel,
                                    pad_plane, pad_rows)


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to libav_tpu_torch yet (ROADMAP.md: module "
        f"queue, step 8b)")


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
        self.register_buffer("pos", quant_ops.raster_positions(
            alternate_scan() if alt_scan else zigzag_scan()))
        mbx = np.arange(self.nmb) % mb_w
        mby = np.arange(self.nmb) // mb_w
        for name, a in (("x16", mbx * 16), ("y16", mby * 16),
                        ("x8", mbx * 8), ("y8", mby * 8), ("y4", mby * 4)):
            self.register_buffer(name, torch.as_tensor(a.astype(np.int32)))

    def residual(self, coeffs, qscale, intra, intra_q, inter_q):
        """(nmb, 6, 64) scan-order levels -> (nmb, 6, 8, 8) int32."""
        n6 = self.nmb * 6
        c = coeffs.reshape(n6, 64).to(torch.int32)
        qs = qscale.to(torch.int32).repeat_interleave(6)
        intra_b = intra.repeat_interleave(6)[:, None]
        if self.quant_kind == "mpeg1":
            deq_i = quant_ops.mpeg1_dequant_intra(c, qs, intra_q)
            deq_p = quant_ops.mpeg1_dequant_inter(c, qs, inter_q)
        else:
            deq_i = quant_ops.mpeg2_dequant_intra(c, qs, intra_q)
            deq_p = quant_ops.mpeg2_dequant_inter(c, qs, inter_q)
        blocks = quant_ops.dezigzag(torch.where(intra_b, deq_i, deq_p),
                                    self.pos)
        if self.quant_kind == "mpeg2":
            blocks = quant_ops.mpeg2_mismatch_control(blocks)
        return idct8x8_int(blocks.contiguous()).reshape(self.nmb, 6, 8, 8)

    def mc6(self, refs, mv, rnd: int, ridx=None):
        """Luma 16x16 and chroma 8x8 half-pel MC of every MB from the
        (y, u, v) padded references (or stacks of them, with ridx)."""
        cmv = chroma_mv_div2(mv)
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


class Recon(_Picture):
    """Frame-picture recon; the JAX recon_jit program. interlaced=True
    adds the frame-picture interlace tools: 16x8 field MC (two field
    vectors and field selects per direction), field DCT, and with
    dual=True dual prime."""

    def __init__(self, mb_w: int, mb_h: int, quant_kind: str,
                 alt_scan: bool, inter_frame: bool, rounding: int = 0,
                 interlaced: bool = False, qpel: bool = False,
                 dual: bool = False, any_4mv: bool = False):
        if quant_kind not in ("mpeg1", "mpeg2"):
            raise _unported(f"the {quant_kind!r} quantiser")
        if qpel:
            raise _unported("quarter-sample MC (qpel)")
        if any_4mv:
            raise _unported("4MV prediction")
        super().__init__(mb_w, mb_h, alt_scan, quant_kind)
        self.inter_frame, self.rounding = inter_frame, rounding
        self.interlaced, self.dual = interlaced, dual

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
            cmv = chroma_mv_div2(mv)
            ridx = sel[:, f] != 0
            halves.append((
                mc_hpel(refs[0], self.x16, self.y8, mv[:, 0], mv[:, 1], 16,
                        rnd, ridx)[:, :8],
                mc_hpel(refs[1], self.x8, self.y4, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx)[:, :4],
                mc_hpel(refs[2], self.x8, self.y4, cmv[:, 0], cmv[:, 1], 8,
                        rnd, ridx)[:, :4]))
        return tuple(_interleave_rows(t, b) for t, b in zip(*halves))

    def forward(self, coeffs, qscale, intra, use_fwd, use_bwd, mv_fwd,
                mv_bwd, intra_q, inter_q, r0y, r0u, r0v, r1y, r1u, r1v,
                field_mc=None, dct_field=None, mvf2=None, mvb2=None,
                sel_f=None, sel_b=None, dp=None, mv_dp2=None, sel_dp=None):
        resid = self.residual(coeffs, qscale, intra, intra_q, inter_q)
        if self.inter_frame:
            rnd = 1 - self.rounding
            fwd = self.mc6((r0y, r0u, r0v), mv_fwd, rnd)
            bwd = self.mc6((r1y, r1u, r1v), mv_bwd, rnd)
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


class ReconField(_Picture):
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

    def forward(self, coeffs, qscale, intra, use_fwd, use_bwd,
                mvf2, sel_f, mvb2, sel_b, intra_q, inter_q,
                f0ty, f0tu, f0tv, f0by, f0bu, f0bv,
                f1ty, f1tu, f1tv, f1by, f1bu, f1bv,
                dp=None, mv_dp2=None, sel_dp=None):
        resid = self.residual(coeffs, qscale, intra, intra_q, inter_q)
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
    return Recon(mb_w, mb_h, quant_kind, alt_scan, inter_frame, rounding,
                 interlaced, qpel, dual, any_4mv).to(device)


@functools.lru_cache(maxsize=32)
def recon_field(mb_w: int, mb_h_f: int, alt_scan: bool, inter_frame: bool,
                dual: bool = False, *, device: torch.device) -> ReconField:
    return ReconField(mb_w, mb_h_f, alt_scan, inter_frame, dual).to(device)


@functools.lru_cache(maxsize=8)
def fields_of_frame(mb_w: int, mb_h: int, *,
                    device: torch.device) -> FieldsOfFrame:
    return FieldsOfFrame().to(device)


@functools.lru_cache(maxsize=8)
def weave_fields(mb_w: int, mb_h: int, *,
                 device: torch.device) -> WeaveFields:
    return WeaveFields().to(device)


@functools.lru_cache(maxsize=8)
def zero_pad_refs(mb_w: int, mb_h: int, *, device: torch.device):
    """Mid-grey padded (y, u, v) references for a picture with none."""
    H, W = mb_h * 16, mb_w * 16
    y = torch.full((H + 2 * EDGE, W + 2 * EDGE), 128, dtype=torch.uint8,
                   device=device)
    c = torch.full((H // 2 + 2 * EDGE, W // 2 + 2 * EDGE), 128,
                   dtype=torch.uint8, device=device)
    return (y, c, c)
