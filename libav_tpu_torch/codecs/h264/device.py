"""H.264 device reconstruction program (counterpart of
`libav_tpu/codecs/h264/device.py` recon_h264_jit, recon_h264_sparse_jit,
recon_h264_deblock_jit and zero_refs_h264).

The stages per frame are the JAX package's:
  1. residual: sparse coefficient scatter, dequant, luma/chroma DC
     transforms, 4x4 and 8x8 inverse transforms, all MBs at once;
  2. inter prediction: quarter-pel luma and eighth-pel chroma MC, per MB
     or per 4x4 block (part=True), one or two lists, 1..n references;
  3. assembly: all-inter frames add prediction and residual in one pass;
     frames with intra MBs go through the intra wavefront: on the card
     one launch of the hand-written CUDA kernel h264_intra_frame
     (ops/h264intra.py), on the CPU its plain twin, which walks the
     macroblock waves (x+y, or x+2y with I_4x4/I_8x8) in a Python loop,
     one batched step per wave;
  4. deblock: the frame deblock of ops/h264deblock.py: the bS/qp grids
     in torch ops (field pictures under the field rules), then every edge
     of the picture in one launch of the hand-written CUDA kernel K1
     (h264_deblock_frame) on the card.

Explicit and implicit weighted prediction (block-granular path only, as
in the JAX program), I_PCM (inside the intra wavefront, so later intra
neighbours read the raw samples) and the PAFF cross-parity chroma offset
(16x16 path only, as in the JAX program) are part of stages 2 and 3.

PyTorch runs eagerly, so the plain wave loop is a host loop over small
kernels; its wave steps only ever touch a wave's real macroblocks (the
JAX program pads every wave to a fixed width and parks the padding in a
scratch margin, which changes nothing in the picture).

Per-geometry constants (wave tables, LevelScale tables) are registered
buffers of an nn.Module, built by an lru_cached factory with the key of
the JAX package's factory plus the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.avutil import timer
from libav_tpu_torch.codecs.h264 import sets
from libav_tpu_torch.codecs.h264.cavlc import SCAN4x4
from libav_tpu_torch.ops import h264mc, h264pred
from libav_tpu_torch.ops.h264deblock import (chroma_qp_table,
                                             deblock_frame_exact,
                                             h264_deblock_frame)
from libav_tpu_torch.ops.h264intra import h264_intra_frame
from libav_tpu_torch.ops.h264transform import (chroma_dc_2x2, hadamard4x4,
                                               idct4x4, idct8x8_h264)
from libav_tpu_torch.ops.mc import EDGE, pad_plane

# LevelScale V matrix (14496-10 table 8-15): rows qp%6, columns the three
# position classes (0: (0,0),(0,2),(2,0),(2,2); 1: (1,1),(1,3),(3,1),(3,3);
# 2: others)
_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# normAdjust8x8 class values (spec Table in 8.5.13), class index per
# (i%4, j%4) position
_V8_CLS = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                   dtype=np.int32).reshape(4, 4)
_V8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)


def _pos_class() -> np.ndarray:
    """(4,4) LevelScale position class."""
    cls = np.full((4, 4), 2, dtype=np.int32)
    for (i, j) in [(0, 0), (0, 2), (2, 0), (2, 2)]:
        cls[i, j] = 0
    for (i, j) in [(1, 1), (1, 3), (3, 1), (3, 3)]:
        cls[i, j] = 1
    return cls


def _pos_class8() -> np.ndarray:
    """(8,8) normAdjust8x8 class per position."""
    ii, jj = np.mgrid[0:8, 0:8]
    return _V8_CLS[ii % 4, jj % 4]


# 4x4 luma block index -> (blkX, blkY) in 4x4 units (spec 6.4.3)
_BLK_XY = np.array([(2 * ((i >> 2) & 1) + (i & 1),
                     2 * (i >> 3) + ((i >> 1) & 1)) for i in range(16)],
                   dtype=np.int32)


def _unpack_wmat(wmat):
    """wmat: None (flat) or hashable ((6 x 16-tuple), (2 x 64-tuple)) ->
    (W4 (6,4,4), W8 (2,8,8)) raster numpy arrays."""
    if wmat is None:
        return (np.broadcast_to(sets.FLAT_4x4.reshape(4, 4),
                                (6, 4, 4)).copy(),
                np.broadcast_to(sets.FLAT_8x8.reshape(8, 8),
                                (2, 8, 8)).copy())
    m4, m8 = wmat
    return (np.array([np.array(m, np.int32).reshape(4, 4) for m in m4]),
            np.array([np.array(m, np.int32).reshape(8, 8) for m in m8]))


def _place(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n*n, s, s) raster-ordered blocks -> (B, n*s, n*s) tiles."""
    B, _, s, _ = blocks.shape
    return (blocks.reshape(B, n, n, s, s).permute(0, 1, 3, 2, 4)
            .reshape(B, n * s, n * s))


def _deq_ac4(c, ls, q6):
    """General 4x4 AC dequant (spec 8.5.12.1)."""
    up = (c * ls) << (q6 - 4).clamp(min=0)
    dn = (c * ls + (1 << (3 - q6).clamp(0, 3))) >> (4 - q6).clamp(0, 4)
    return torch.where(q6 >= 4, up, dn)


class ReconH264(nn.Module):
    """Dense-input recon of one frame; the JAX recon_h264_jit program."""

    def __init__(self, mb_w: int, mb_h: int, any_intra: bool = True,
                 nrefs: int = 1, any_i4: bool = False, bpred: bool = False,
                 part: bool = False, nrefs1: int = 1, weighted=None,
                 wmat=None, cqpo=(0, 0), any_t8: bool = False,
                 any_i8: bool = False, any_ipcm: bool = False,
                 any_cdy: bool = False):
        super().__init__()
        self.mb_w, self.mb_h = mb_w, mb_h
        self.any_intra, self.any_i4, self.any_t8 = any_intra, any_i4, any_t8
        self.any_i8, self.bpred, self.part = any_i8, bpred, part
        self.nrefs, self.nrefs1, self.cqpo = nrefs, nrefs1, cqpo
        # None, "i" (implicit) or ("e", luma logWD, chroma logWD)
        self.weighted = weighted
        self.any_ipcm, self.any_cdy = any_ipcm, any_cdy
        nmb = mb_w * mb_h

        def buf(name, a, dtype):
            self.register_buffer(name, torch.as_tensor(np.asarray(a),
                                                       dtype=dtype))

        pos4 = np.empty(16, np.int64)            # scan -> raster
        pos4[np.asarray(SCAN4x4)] = np.arange(16)
        buf("pos4", pos4, torch.long)
        # raster 4x4 position -> Z-order block index (spec 6.4.3)
        blk_of_raster = np.empty(16, np.int64)
        blk_of_raster[_BLK_XY[:, 1] * 4 + _BLK_XY[:, 0]] = np.arange(16)
        buf("blk_of_raster", blk_of_raster, torch.long)
        buf("blk_x", _BLK_XY[:, 0], torch.long)
        buf("blk_y", _BLK_XY[:, 1], torch.long)

        W4, W8 = _unpack_wmat(wmat)
        v4 = _V[:, _pos_class()]                 # (6,4,4)
        v8 = _V8[:, _pos_class8()]               # (6,8,8)
        buf("ls4_tab", W4[:, None] * v4[None], torch.int32)   # (6,6,4,4)
        buf("ls8_tab", W8[:, None] * v8[None], torch.int32)   # (2,6,8,8)

        mbx = np.arange(nmb) % mb_w
        mby = np.arange(nmb) // mb_w
        buf("mb_x", mbx, torch.int32)
        buf("mb_y", mby, torch.int32)
        bw4, bh4 = 4 * mb_w, 4 * mb_h
        buf("blk_bx", np.arange(bw4 * bh4) % bw4, torch.int32)
        buf("blk_by", np.arange(bw4 * bh4) // bw4, torch.int32)

        # intra wavefront tables: per wave its MBs' (index, x, y)
        wave_of = (lambda x, y: x + 2 * y) if any_i4 else \
            (lambda x, y: x + y)
        waves = [[] for _ in range(wave_of(mb_w - 1, mb_h - 1) + 1)]
        for i in range(nmb):
            waves[wave_of(mbx[i], mby[i])].append(i)
        self.wave_counts = [len(w) for w in waves]
        tab = np.zeros((len(waves), max(self.wave_counts), 3), np.int64)
        for w, members in enumerate(waves):
            for slot, i in enumerate(members):
                tab[w, slot] = (i, mbx[i], mby[i])
        buf("wave_tab", tab, torch.long)

        # in-MB top-right availability of each Z-order 4x4 block (spec
        # 6.4.9: the block above-right must precede in decoding order)
        zidx = {tuple(_BLK_XY[b]): b for b in range(16)}
        self.tr_in_mb = [bool(_BLK_XY[b, 1] > 0 and _BLK_XY[b, 0] < 3 and
                              zidx[(_BLK_XY[b, 0] + 1, _BLK_XY[b, 1] - 1)]
                              < b) for b in range(16)]

    # ------------------------------------------------------------------ #

    def residual(self, intra, intra16, qp, luma_dc, luma_ac, chroma_dc,
                 chroma_ac, t8=None):
        """-> resid_y (nmb,16,16), resid_u/v (nmb,8,8) int32."""
        nmb = self.mb_w * self.mb_h
        qp = qp.to(torch.int32).clamp(0, 51)
        m6 = (qp % 6).long()
        q6 = qp // 6
        it = intra.bool()
        ls4 = self.ls4_tab

        ac = luma_ac[:, :, self.pos4].reshape(nmb, 16, 4, 4).to(torch.int32)
        ls_y = ls4[torch.where(it, 0, 3), m6]
        ac = _deq_ac4(ac, ls_y[:, None], q6[:, None, None, None])
        # I_16x16 DC: Hadamard over the (4,4) DC grid (spec 8.5.10)
        dcs = luma_dc[:, self.pos4].reshape(nmb, 4, 4)
        f = hadamard4x4(dcs)
        ls0 = ls4[0, m6, 0, 0][:, None, None]
        sh = (q6 - 6)[:, None, None]
        dc_deq = torch.where(sh >= 0, (f * ls0) << sh.clamp(min=0),
                             (f * ls0 + (1 << (-sh - 1).clamp(0, 5)))
                             >> (-sh).clamp(0, 6))
        dc_per_block = dc_deq[:, self.blk_y, self.blk_x]   # (nmb, 16)
        ac = ac.reshape(nmb, 16, 16)
        ac[:, :, 0] = torch.where(intra16[:, None], dc_per_block,
                                  ac[:, :, 0])
        r = idct4x4(ac.reshape(nmb * 16, 4, 4)).reshape(nmb, 16, 4, 4)
        resid_y = _place(r[:, self.blk_of_raster], 4)

        if self.any_t8:
            # 8x8 transform MBs: each quadrant's 64 raster coefficients
            # travel in the 4 rows of its Z-order 4x4 slots; dequant
            # 8.5.13 + exact idct8 8.5.12.2
            c8 = luma_ac.reshape(nmb, 4, 8, 8).to(torch.int32)
            ls8 = self.ls8_tab[torch.where(it, 0, 1), m6]
            q6b = q6[:, None, None, None]
            up = (c8 * ls8[:, None]) << (q6b - 6).clamp(min=0)
            dn = (c8 * ls8[:, None] + (1 << (5 - q6b).clamp(0, 5))) >> \
                (6 - q6b).clamp(0, 6)
            d8 = torch.where(q6b >= 6, up, dn)
            r8 = idct8x8_h264(d8.reshape(nmb * 4, 8, 8)).reshape(
                nmb, 4, 8, 8)
            resid_y = torch.where(t8.bool()[:, None, None], _place(r8, 2),
                                  resid_y)

        cqp = chroma_qp_table(qp.device)
        dc_c = chroma_dc_2x2(chroma_dc.to(torch.int32))      # (nmb,2,4)
        cac = chroma_ac[:, :, self.pos4].reshape(nmb, 8, 4, 4) \
            .to(torch.int32)
        outs = []
        for comp in (0, 1):
            qpc = cqp[(qp + self.cqpo[comp]).clamp(0, 51).long()]
            mc6 = (qpc % 6).long()
            qc6 = qpc // 6
            lsl = torch.where(it, 1 + comp, 4 + comp)
            cc = _deq_ac4(cac[:, 4 * comp:4 * comp + 4],
                          ls4[lsl, mc6][:, None],
                          qc6[:, None, None, None]).reshape(nmb, 4, 16)
            ls0c = ls4[lsl, mc6, 0, 0]
            cc[:, :, 0] = ((dc_c[:, comp] * ls0c[:, None])
                           << qc6[:, None]) >> 5                # 8.5.11
            rc = idct4x4(cc.reshape(nmb * 4, 4, 4)).reshape(nmb, 4, 4, 4)
            outs.append(_place(rc, 2))
        return resid_y, outs[0], outs[1]

    def _part_mc_list(self, ry, ru, rv, bmv, bref, n):
        mvf = bmv.reshape(-1, 2).to(torch.int32)
        rix = bref.reshape(-1).long() if n > 1 else None
        bx, by = self.blk_bx, self.blk_by
        return (h264mc.qpel_mc(ry, bx * 4, by * 4, mvf[:, 0], mvf[:, 1], 4,
                               rix),
                h264mc.chroma_mc(ru, bx * 2, by * 2, mvf[:, 0], mvf[:, 1],
                                 2, rix),
                h264mc.chroma_mc(rv, bx * 2, by * 2, mvf[:, 0], mvf[:, 1],
                                 2, rix))

    def _mb_tiles(self, p, s):
        """(bh4*bw4, s, s) block predictions -> (nmb, 4s, 4s) MB tiles."""
        mb_w, mb_h = self.mb_w, self.mb_h
        plane = (p.reshape(4 * mb_h, 4 * mb_w, s, s).permute(0, 2, 1, 3)
                 .reshape(4 * mb_h * s, 4 * mb_w * s))
        t = 4 * s
        return (plane.reshape(mb_h, t, mb_w, t).permute(0, 2, 1, 3)
                .reshape(mb_w * mb_h, t, t))

    def _planes(self, tiles, s):
        """(nmb, s, s) MB tiles -> (mb_h*s, mb_w*s) plane."""
        mb_w, mb_h = self.mb_w, self.mb_h
        return (tiles.reshape(mb_h, mb_w, s, s).permute(0, 2, 1, 3)
                .reshape(mb_h * s, mb_w * s))

    @staticmethod
    def _bi(s, p0, p1):
        return torch.where(s == 0, p0,
                           torch.where(s == 1, p1, (p0 + p1 + 1) >> 1))

    def _explicit(self, p0, r0, wtab0, p1=None, r1=None, wtab1=None,
                  s=None):
        """Explicit weighted prediction (spec 8.4.2.3.3) of the three
        planes' block predictions; wtab (nrefs, 3 planes, [w, o]) int32,
        r0/r1 each block's reference index. `>>` floors negative int32
        as jnp's does."""
        _, dy, dc = self.weighted

        def uni(p, w, o, d):
            w, o = w[:, None, None], o[:, None, None]
            v = ((p * w + (1 << (d - 1))) >> d) + o if d else p * w + o
            return v.clamp(0, 255)

        out = []
        for pl in range(3):
            d = dy if pl == 0 else dc
            w0, o0 = wtab0[r0, pl, 0], wtab0[r0, pl, 1]
            u0 = uni(p0[pl], w0, o0, d)
            if p1 is None:
                out.append(u0)
                continue
            w1, o1 = wtab1[r1, pl, 0], wtab1[r1, pl, 1]
            u1 = uni(p1[pl], w1, o1, d)
            bi = (((p0[pl] * w0[:, None, None] + p1[pl] * w1[:, None, None]
                    + (1 << d)) >> (d + 1))
                  + ((o0 + o1 + 1) >> 1)[:, None, None]).clamp(0, 255)
            out.append(torch.where(s == 0, u0, torch.where(s == 1, u1, bi)))
        return out

    @staticmethod
    def _implicit(p0, r0, w0tab, p1, r1, s):
        """Implicit bi-pred weights (spec 8.4.2.3.2, logWD 5) of the three
        planes' block predictions: w0 = w0tab[r0, r1], w1 = 64 - w0;
        uni-predicted blocks stay unweighted."""
        w0 = w0tab[r0, r1][:, None, None]
        out = []
        for a, b in zip(p0, p1):
            bi = ((a * w0 + b * (64 - w0) + 32) >> 6).clamp(0, 255)
            out.append(torch.where(s == 0, a, torch.where(s == 1, b, bi)))
        return out

    def inter(self, mv, ry, ru, rv, ref_idx=None, mv1=None, sel=None,
              ry1=None, ru1=None, rv1=None, bmv0=None, bref0=None,
              bsel=None, bmv1=None, bref1=None, wtab0=None, wtab1=None,
              w0tab=None, cdy=None):
        """Inter prediction of every MB -> (nmb,16,16), 2 x (nmb,8,8)."""
        wt = self.weighted
        if self.part:
            p0 = self._part_mc_list(ry, ru, rv, bmv0, bref0, self.nrefs)
            r0 = bref0.reshape(-1).long()
            p1 = r1 = s = None
            if self.bpred:
                p1 = self._part_mc_list(ry1, ru1, rv1, bmv1, bref1,
                                        self.nrefs1)
                r1 = bref1.reshape(-1).long()
                s = bsel.reshape(-1).long()[:, None, None]
            if wt is not None and wt[0] == "e":
                p0 = self._explicit(p0, r0, wtab0, p1, r1, wtab1, s)
            elif wt == "i" and self.bpred:
                p0 = self._implicit(p0, r0, w0tab, p1, r1, s)
            elif self.bpred:
                p0 = [self._bi(s, a, b) for a, b in zip(p0, p1)]
            return (self._mb_tiles(p0[0], 4), self._mb_tiles(p0[1], 2),
                    self._mb_tiles(p0[2], 2))
        xs, ys = self.mb_x * 16, self.mb_y * 16
        cxs, cys = self.mb_x * 8, self.mb_y * 8
        mv32 = mv.to(torch.int32)
        ridx = ref_idx.long() if self.nrefs > 1 else None
        # PAFF cross-parity chroma offset (spec 8.4.1.4.1; reference
        # h264_mb.c mc_dir_part my += 2*(parity diff))
        cmvy = mv32[:, 1] + cdy.to(torch.int32) if self.any_cdy \
            else mv32[:, 1]
        pred = [h264mc.qpel_mc(ry, xs, ys, mv32[:, 0], mv32[:, 1], 16, ridx),
                h264mc.chroma_mc(ru, cxs, cys, mv32[:, 0], cmvy, 8, ridx),
                h264mc.chroma_mc(rv, cxs, cys, mv32[:, 0], cmvy, 8, ridx)]
        if self.bpred:
            # B slice: list-1 prediction + per-MB selection 0=L0 1=L1 2=Bi
            m1 = mv1.to(torch.int32)
            p1 = [h264mc.qpel_mc(ry1, xs, ys, m1[:, 0], m1[:, 1], 16),
                  h264mc.chroma_mc(ru1, cxs, cys, m1[:, 0], m1[:, 1], 8),
                  h264mc.chroma_mc(rv1, cxs, cys, m1[:, 0], m1[:, 1], 8)]
            s = sel.long()[:, None, None]
            pred = [self._bi(s, a, b) for a, b in zip(pred, p1)]
        return tuple(pred)

    def forward(self, intra, luma_mode, chroma_mode, mv, qp, luma_dc,
                luma_ac, chroma_dc, chroma_ac, ry, ru, rv, ref_idx=None,
                i4=None, i4_modes=None, mv1=None, sel=None, ry1=None,
                ru1=None, rv1=None, bmv0=None, bref0=None, bsel=None,
                bmv1=None, bref1=None, wtab0=None, wtab1=None, w0tab=None,
                row_top=None, t8=None, ipcm=None, ipcm_y=None, ipcm_u=None,
                ipcm_v=None, cdy=None):
        """-> (y, u, v) uint8 planes, and the same edge-padded by EDGE."""
        if isinstance(ry, (tuple, list)):
            ry, ru, rv = torch.stack(ry), torch.stack(ru), torch.stack(rv)
        if isinstance(ry1, (tuple, list)):
            ry1, ru1, rv1 = (torch.stack(ry1), torch.stack(ru1),
                             torch.stack(rv1))
        intra = intra.bool()
        intra16 = intra & ~i4.bool() if self.any_i4 else intra
        if self.any_t8:
            intra16 = intra16 & ~t8.bool()
        resid_y, resid_u, resid_v = self.residual(
            intra, intra16, qp, luma_dc, luma_ac, chroma_dc, chroma_ac, t8)
        pred_y, pred_u, pred_v = self.inter(
            mv, ry, ru, rv, ref_idx, mv1, sel, ry1, ru1, rv1, bmv0, bref0,
            bsel, bmv1, bref1, wtab0, wtab1, w0tab, cdy)

        if not self.any_intra:
            # every MB is inter: assemble without the wavefront
            planes = tuple(
                self._planes((p + r).clamp(0, 255).to(torch.uint8), s)
                for p, r, s in ((pred_y, resid_y, 16), (pred_u, resid_u, 8),
                                (pred_v, resid_v, 8)))
            return planes, tuple(pad_plane(p) for p in planes)

        args = (intra, luma_mode, chroma_mode, row_top, i4, i4_modes, t8,
                (pred_y, pred_u, pred_v), (resid_y, resid_u, resid_v),
                (ipcm, ipcm_y, ipcm_u, ipcm_v))
        with timer.timer("h264.recon.intra"):
            if intra.device.type == "cpu":
                fy, fu, fv = self._wavefront(*args)
            else:
                fy, fu, fv = h264_intra_frame(
                    self.mb_w, self.mb_h, self.any_i4, self.any_i8,
                    self.any_ipcm, *args)
        H, W = 16 * self.mb_h, 16 * self.mb_w
        planes = (fy[1:1 + H, 1:1 + W].to(torch.uint8),
                  fu[1:1 + H // 2, 1:1 + W // 2].to(torch.uint8),
                  fv[1:1 + H // 2, 1:1 + W // 2].to(torch.uint8))
        return planes, tuple(pad_plane(p) for p in planes)

    def _wavefront(self, intra, luma_mode, chroma_mode, row_top, i4,
                   i4_modes, t8, pred, resid, pcm):
        """The intra assembly: one batched step per MB wave; the plain
        twin of the kernel `h264_intra_frame` (one launch per picture),
        which CUDA tensors take. Frame buffers carry a 1-pixel top/left
        border (128) and a right/bottom margin that the I_4x4 top-right
        reads of the last column land in."""
        mb_w, mb_h = self.mb_w, self.mb_h
        H, W = 16 * mb_h, 16 * mb_w
        dev = intra.device
        i32 = torch.int32
        fy = torch.full((1 + H + 16, 1 + W + 16), 128, dtype=i32, device=dev)
        fu = torch.full((1 + H // 2 + 8, 1 + W // 2 + 8), 128, dtype=i32,
                        device=dev)
        fv = fu.clone()
        r16 = torch.arange(16, device=dev)
        r8 = torch.arange(8, device=dev)
        lmode, cmode = luma_mode.long(), chroma_mode.long()
        pred_y, pred_u, pred_v = pred
        resid_y, resid_u, resid_v = resid
        if self.any_i4:
            i4b = i4.bool()
            i4m = i4_modes.long()
            is8_all = i4b & t8.bool() if self.any_i8 else None
        row_top = None if row_top is None else row_top.bool()
        if self.any_ipcm:
            ipcm = pcm[0].bool()
            pcm_y, pcm_u, pcm_v = (p.to(i32) for p in pcm[1:])

        for w, count in enumerate(self.wave_counts):
            if not count:
                continue        # x+2y waves of a 1-MB-wide picture
            wt = self.wave_tab[w, :count]
            idx, bx, by = wt[:, 0], wt[:, 1], wt[:, 2]
            y0, x0 = by * 16 + 1, bx * 16 + 1
            cy0, cx0 = by * 8 + 1, bx * 8 + 1

            top = fy[(y0 - 1)[:, None], x0[:, None] + r16]
            left = fy[y0[:, None] + r16, (x0 - 1)[:, None]]
            tl = fy[y0 - 1, x0 - 1]
            # intra availability honours slice boundaries: row_top[y] is
            # False on the first MB row of each slice (row-aligned slices)
            at = (by > 0) if row_top is None else row_top[by]
            al = bx > 0

            def cnb(f):
                return (f[(cy0 - 1)[:, None], cx0[:, None] + r8],
                        f[cy0[:, None] + r8, (cx0 - 1)[:, None]],
                        f[cy0 - 1, cx0 - 1])
            cm = cmode[idx]
            ipred_y = h264pred.pred16x16(lmode[idx], top, left, tl, at, al)
            ipred_u = h264pred.pred8x8_chroma(cm, *cnb(fu), at, al)
            ipred_v = h264pred.pred8x8_chroma(cm, *cnb(fv), at, al)

            isin = intra[idx][:, None, None]
            oy = (torch.where(isin, ipred_y, pred_y[idx]) + resid_y[idx]) \
                .clamp(0, 255)
            ou = (torch.where(isin, ipred_u, pred_u[idx]) + resid_u[idx]) \
                .clamp(0, 255)
            ov = (torch.where(isin, ipred_v, pred_v[idx]) + resid_v[idx]) \
                .clamp(0, 255)

            if self.any_i4:
                oy = self._intra4(fy, idx, bx, y0, x0, top, left, tl, at,
                                  al, oy, i4b, i4m, is8_all, resid_y)
            if self.any_ipcm:
                # I_PCM (spec 8.3.5): the raw samples replace the whole MB
                # inside the wave, so later intra neighbours read them
                pm = ipcm[idx][:, None, None]
                oy = torch.where(pm, pcm_y[idx], oy)
                ou = torch.where(pm, pcm_u[idx], ou)
                ov = torch.where(pm, pcm_v[idx], ov)

            fy[y0[:, None, None] + r16[None, :, None],
               x0[:, None, None] + r16[None, None, :]] = oy
            fu[cy0[:, None, None] + r8[None, :, None],
               cx0[:, None, None] + r8[None, None, :]] = ou
            fv[cy0[:, None, None] + r8[None, :, None],
               cx0[:, None, None] + r8[None, None, :]] = ov
        return fy, fu, fv

    def _intra4(self, fy, idx, bx, y0, x0, top, left, tl, at, al, oy, i4b,
                i4m, is8_all, resid_y):
        """I_4x4 (16 sub-blocks in Z order) and I_8x8 (4 quadrants)
        against a local patch; the residual is added per block because
        prediction reads the previous blocks' reconstruction (8.3.1)."""
        n = idx.shape[0]
        dev = idx.device
        r8 = torch.arange(8, device=dev)
        tr8 = fy[(y0 - 1)[:, None], x0[:, None] + 16 + r8]
        patch = torch.zeros((n, 17, 25), dtype=torch.int32, device=dev)
        patch[:, 0, 0] = tl
        patch[:, 0, 1:17] = top
        patch[:, 0, 17:25] = tr8
        patch[:, 1:17, 0] = left
        atr_frame = at & (bx < self.mb_w - 1)
        rtrue = torch.ones(n, dtype=torch.bool, device=dev)
        for b in range(16):
            bx4, by4 = int(_BLK_XY[b, 0]), int(_BLK_XY[b, 1])
            px0, py0 = 1 + 4 * bx4, 1 + 4 * by4
            t4 = patch[:, py0 - 1, px0:px0 + 4]
            if by4 > 0:
                tr_ok = rtrue if self.tr_in_mb[b] else ~rtrue
            elif bx4 == 3:
                tr_ok = atr_frame
            else:
                tr_ok = at
            tr4 = torch.where(tr_ok[:, None],
                              patch[:, py0 - 1, px0 + 4:px0 + 8], t4[:, 3:4])
            p4 = h264pred.pred4x4(i4m[idx, b], torch.cat([t4, tr4], 1),
                                  patch[:, py0:py0 + 4, px0 - 1],
                                  patch[:, py0 - 1, px0 - 1],
                                  at if by4 == 0 else rtrue,
                                  al if bx4 == 0 else rtrue)
            blkres = resid_y[idx, 4 * by4:4 * by4 + 4, 4 * bx4:4 * bx4 + 4]
            patch[:, py0:py0 + 4, px0:px0 + 4] = (p4 + blkres).clamp(0, 255)
        is_i4 = i4b[idx][:, None, None]
        if is8_all is None:
            return torch.where(is_i4, patch[:, 1:17, 1:17], oy)
        # I_8x8 (i4 & t8): the i4 pass above wrote this MB's patch with
        # 8x8 modes read as 4x4 ones; each quadrant is overwritten before
        # any later read. pred8x8_luma filters its reference samples.
        atr_q1 = at & (bx < self.mb_w - 1)
        quad_av = [(at, al, at & al, at),
                   (at, rtrue, at, atr_q1),
                   (rtrue, al, al, rtrue),
                   (rtrue, rtrue, rtrue, ~rtrue)]
        is8v = is8_all[idx]
        for b in range(4):
            qx, qy = (b & 1) * 8, (b >> 1) * 8
            px0, py0 = 1 + qx, 1 + qy
            p8 = h264pred.pred8x8_luma(
                i4m[idx, 4 * b], patch[:, py0 - 1, px0:px0 + 16],
                patch[:, py0:py0 + 8, px0 - 1], patch[:, py0 - 1, px0 - 1],
                *quad_av[b])
            rec = (p8 + resid_y[idx, qy:qy + 8, qx:qx + 8]).clamp(0, 255)
            # only I_8x8 MBs take the 8x8 recon; same-wave I_4x4 MBs keep
            # their already-correct patch
            patch[:, py0:py0 + 8, px0:px0 + 8] = torch.where(
                is8v[:, None, None], rec, patch[:, py0:py0 + 8,
                                                px0:px0 + 8])
        return torch.where(is8v[:, None, None] | is_i4,
                           patch[:, 1:17, 1:17], oy)


class ReconH264Sparse(nn.Module):
    """Sparse-residual recon + deblock + crop of one frame; the JAX
    recon_h264_sparse_jit program. The host sends only the coded 4x4
    blocks (values + flat block indices, padded to the bucket capacity
    with the index of a dropped sentinel row)."""

    def __init__(self, mb_w: int, mb_h: int, any_intra: bool, ycap: int,
                 ccap: int, crop=None, deblock: bool = False,
                 nrefs: int = 1, db_offsets=(0, 0), any_i4: bool = False,
                 bpred: bool = False, part: bool = False, nrefs1: int = 1,
                 weighted=None, wmat=None, cqpo=(0, 0),
                 any_t8: bool = False, any_i8: bool = False,
                 any_ipcm: bool = False, field: bool = False,
                 any_cdy: bool = False, any_ydc: bool = True,
                 any_cdc: bool = True, *, device: torch.device):
        super().__init__()
        self.dense = recon_h264(mb_w, mb_h, any_intra, nrefs, any_i4, bpred,
                                part, nrefs1, weighted, wmat, cqpo, any_t8,
                                any_i8, any_ipcm, any_cdy, device=device)
        self.mb_w, self.mb_h = mb_w, mb_h
        self.ycap, self.ccap, self.crop = ycap, ccap, crop
        self.any_ydc, self.any_cdc, self.any_t8 = any_ydc, any_cdc, any_t8
        self.part = part
        self.deblock = (deblock_frame_exact(mb_w, mb_h, db_offsets[0],
                                            db_offsets[1], part=part,
                                            cqpo=cqpo, any_t8=any_t8,
                                            field=field)
                        if deblock else None)

    def forward(self, intra, luma_mode, chroma_mode, mv, qp, luma_dc,
                yvals, yidx, cvals, cidx, chroma_dc, ry, ru, rv, nnz=None,
                ref_idx=None, i4=None, i4_modes=None, mv1=None, sel=None,
                ry1=None, ru1=None, rv1=None, bmv0=None, bref0=None,
                bsel=None, bmv1=None, bref1=None, pid0=None, pid1=None,
                wtab0=None, wtab1=None, w0tab=None, row_top=None, t8=None,
                ipcm=None, ipcm_y=None, ipcm_u=None, ipcm_v=None, cdy=None):
        """-> (cropped y, u, v) uint8 planes, and the uncropped planes
        edge-padded by EDGE for the DPB."""
        nmb = self.mb_w * self.mb_h
        dev = intra.device
        if yvals.shape != (self.ycap, 16) or cvals.shape != (self.ccap, 16):
            raise ValueError("coefficient transport does not match the "
                             f"program's buckets ({self.ycap}, {self.ccap})")
        # plain index_put_: padding rows all hit the sentinel row, which
        # is dropped; coded rows are unique
        luma_ac = torch.zeros((nmb * 16 + 1, 16), dtype=torch.int16,
                              device=dev)
        luma_ac[yidx.long()] = yvals.to(torch.int16)
        chroma_ac = torch.zeros((nmb * 8 + 1, 16), dtype=torch.int16,
                                device=dev)
        chroma_ac[cidx.long()] = cvals.to(torch.int16)
        if not self.any_ydc:
            luma_dc = torch.zeros((nmb, 16), dtype=torch.int16, device=dev)
        if not self.any_cdc:
            chroma_dc = torch.zeros((nmb, 2, 4), dtype=torch.int16,
                                    device=dev)
        planes, padded = self.dense(
            intra, luma_mode, chroma_mode, mv, qp, luma_dc,
            luma_ac[:nmb * 16].reshape(nmb, 16, 16), chroma_dc,
            chroma_ac[:nmb * 8].reshape(nmb, 8, 16), ry, ru, rv,
            ref_idx=ref_idx, i4=i4, i4_modes=i4_modes, mv1=mv1, sel=sel,
            ry1=ry1, ru1=ru1, rv1=rv1, bmv0=bmv0, bref0=bref0, bsel=bsel,
            bmv1=bmv1, bref1=bref1, wtab0=wtab0, wtab1=wtab1, w0tab=w0tab,
            row_top=row_top, t8=t8, ipcm=ipcm, ipcm_y=ipcm_y, ipcm_u=ipcm_u,
            ipcm_v=ipcm_v, cdy=cdy)
        if self.deblock is not None:
            kw = {"t8": t8} if self.any_t8 else {}
            motion = (bmv0, pid0, bmv1, pid1) if self.part else (mv,)
            planes = tuple(p.to(torch.uint8) for p in self.deblock(
                *(p.to(torch.int32) for p in planes), intra, qp, nnz,
                *motion, **kw))
            padded = tuple(pad_plane(p) for p in planes)
        if self.crop is not None:
            cl, cr, ct, cb, W, H = self.crop
            planes = (planes[0][2 * ct:2 * ct + H, 2 * cl:2 * cl + W],
                      planes[1][ct:ct + (H + 1) // 2, cl:cl + (W + 1) // 2],
                      planes[2][ct:ct + (H + 1) // 2, cl:cl + (W + 1) // 2])
        return planes, padded


class ReconH264Deblock(nn.Module):
    """Dense-input recon + in-loop deblocking of one picture: the JAX
    recon_h264_deblock_jit program, the H.264 encoder's closed-loop
    reference path when deblocking is on (the decoder deblocks in
    ReconH264Sparse). The deblock's edges go through `run`, K1
    (h264_deblock_frame) by default: one launch per picture on the card,
    deblock_frame_plain on CPU tensors."""

    def __init__(self, mb_w: int, mb_h: int, any_intra: bool = True,
                 any_i4: bool = False, any_t8: bool = False,
                 any_i8: bool = False, any_ipcm: bool = False,
                 field: bool = False, cdy: int = 0, *,
                 device: torch.device):
        super().__init__()
        self.dense = recon_h264(mb_w, mb_h, any_intra, 1, any_i4,
                                any_t8=any_t8, any_i8=any_i8,
                                any_ipcm=any_ipcm, any_cdy=bool(cdy),
                                device=device)
        self.deblock = deblock_frame_exact(mb_w, mb_h, any_t8=any_t8,
                                           field=field)
        self.nmb, self.cdy, self.any_t8 = mb_w * mb_h, cdy, any_t8

    def forward(self, intra, luma_mode, chroma_mode, mv, qp, luma_dc,
                luma_ac, chroma_dc, chroma_ac, nnz, ry, ru, rv, i4=None,
                i4_modes=None, t8=None, ipcm=None, ipcm_y=None, ipcm_u=None,
                ipcm_v=None, run=h264_deblock_frame):
        """-> (y, u, v) deblocked uint8 planes, and the same edge-padded
        by EDGE."""
        cdy = (torch.full((self.nmb,), self.cdy, dtype=torch.int32,
                          device=intra.device) if self.cdy else None)
        planes, _ = self.dense(intra, luma_mode, chroma_mode, mv, qp,
                               luma_dc, luma_ac, chroma_dc, chroma_ac, ry,
                               ru, rv, i4=i4, i4_modes=i4_modes, t8=t8,
                               ipcm=ipcm, ipcm_y=ipcm_y, ipcm_u=ipcm_u,
                               ipcm_v=ipcm_v, cdy=cdy)
        kw = {"t8": t8} if self.any_t8 else {}
        planes = tuple(p.to(torch.uint8) for p in self.deblock(
            *(p.to(torch.int32) for p in planes), intra, qp, nnz, mv,
            run=run, **kw))
        return planes, tuple(pad_plane(p) for p in planes)


@functools.lru_cache(maxsize=16)
def recon_h264(mb_w: int, mb_h: int, any_intra: bool = True, nrefs: int = 1,
               any_i4: bool = False, bpred: bool = False,
               part: bool = False, nrefs1: int = 1, weighted=None,
               wmat=None, cqpo=(0, 0), any_t8: bool = False,
               any_i8: bool = False, any_ipcm: bool = False,
               any_cdy: bool = False, *, device: torch.device) -> ReconH264:
    """recon_h264_jit's key plus the device -> the module on device."""
    timer.count("programs.built", program="recon_h264")
    return ReconH264(mb_w, mb_h, any_intra, nrefs, any_i4, bpred, part,
                     nrefs1, weighted, wmat, cqpo, any_t8, any_i8, any_ipcm,
                     any_cdy).to(device)


@functools.lru_cache(maxsize=64)
def recon_h264_sparse(mb_w: int, mb_h: int, any_intra: bool, ycap: int,
                      ccap: int, crop=None, deblock: bool = False,
                      nrefs: int = 1, db_offsets=(0, 0),
                      any_i4: bool = False, bpred: bool = False,
                      part: bool = False, nrefs1: int = 1, weighted=None,
                      wmat=None, cqpo=(0, 0), any_t8: bool = False,
                      any_i8: bool = False, any_ipcm: bool = False,
                      field: bool = False, any_cdy: bool = False,
                      any_ydc: bool = True, any_cdc: bool = True, *,
                      device: torch.device) -> ReconH264Sparse:
    """recon_h264_sparse_jit's key plus the device -> the module on
    device."""
    timer.count("programs.built", program="recon_h264_sparse")
    return ReconH264Sparse(mb_w, mb_h, any_intra, ycap, ccap, crop, deblock,
                           nrefs, db_offsets, any_i4, bpred, part, nrefs1,
                           weighted, wmat, cqpo, any_t8, any_i8, any_ipcm,
                           field, any_cdy, any_ydc, any_cdc, device=device)


@functools.lru_cache(maxsize=16)
def recon_h264_deblock(mb_w: int, mb_h: int, any_intra: bool = True,
                       any_i4: bool = False, any_t8: bool = False,
                       any_i8: bool = False, any_ipcm: bool = False,
                       field: bool = False, cdy: int = 0, *,
                       device: torch.device) -> ReconH264Deblock:
    """recon_h264_deblock_jit's key plus the device -> the module on
    device."""
    timer.count("programs.built", program="recon_h264_deblock")
    return ReconH264Deblock(mb_w, mb_h, any_intra, any_i4, any_t8, any_i8,
                            any_ipcm, field, cdy, device=device).to(device)


@functools.lru_cache(maxsize=8)
def zero_refs_h264(mb_w: int, mb_h: int, *, device: torch.device):
    """Mid-grey padded (Y, U, V) planes for missing references."""
    H, W = mb_h * 16, mb_w * 16
    y = torch.full((H + 2 * EDGE, W + 2 * EDGE), 128, dtype=torch.uint8,
                   device=device)
    c = torch.full((H // 2 + 2 * EDGE, W // 2 + 2 * EDGE), 128,
                   dtype=torch.uint8, device=device)
    return (y, c, c)


def sparse_caps(mb_w: int, mb_h: int, ny: int, nc: int):
    """Pick the (ycap, ccap) bucket pair for a frame with ny coded luma
    4x4 blocks and nc coded chroma blocks.  Buckets are tied to one
    coarse level so at most 4 sparse program variants exist per frame
    geometry (compile-count bound)."""
    nmb = mb_w * mb_h
    ytot, ctot = nmb * 16, nmb * 8
    for div in (32, 8, 2):
        ycap = max(64, ytot // div)
        ccap = max(32, ctot // div)
        if ny <= ycap and nc <= ccap:
            return ycap, ccap
    return ytot, ctot
