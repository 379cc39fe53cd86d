"""The H.264 encoder's device programs (counterpart of the programs in
`libav_tpu/codecs/h264/enc.py`: _encode_i_jit, _encode_i4_jit,
_encode_i8_jit, _encode_p_jit and _encode_b_jit).

  EncodeI16  I_16x16 with DC prediction: forward 4x4 transform, the luma
             DC Hadamard, quantisation and the decoder's reconstruction
             in one pass over the x+y macroblock waves;
  EncodeI4   I_4x4: per 4x4 block all nine modes against the
             reconstructed neighbours, the least SAD, transform, quant
             and reconstruction, over the x+2y waves;
  EncodeI8   I_8x8 the same way with the filtered-edge 8x8 modes and the
             float32 8x8 forward transform (ops/h264transform.py
             fdct8x8_h264_xla, which sums as XLA does);
  EncodeP    the full-pel diamond search (ops/me.py search), a
             quarter-pel refinement, one or two references, quarter-pel
             prediction, the 4x4 (and, with dct8, the 8x8) luma levels
             and the chroma levels;
  EncodeB    both lists searched, per MB the cheaper of L0, L1 and Bi.

PyTorch runs eagerly, so the JAX programs' `lax.scan` over the waves is a
host loop, one batched step per wave over that wave's macroblocks only
(the JAX program pads each wave to a fixed width and parks the padding in
the frame buffers' right margin, which only masked reads see). The wave
tables are buffers built once per geometry. Every mode, reference and
list choice is a chain of strict comparisons, so a tie keeps the first
candidate, as `jnp.argmin` does.

The intra programs return their outputs in macroblock order (the JAX
programs return them in wave layout, which the JAX packer scatters back)
and the reconstructed planes; P and B return per-MB tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.ops import h264mc
from libav_tpu_torch.ops.h264deblock import CHROMA_QP
from libav_tpu_torch.ops.h264pred import pred4x4, pred8x8_luma
from libav_tpu_torch.ops.h264transform import (_V, dequant8x8_tab,
                                               dequant_scale, fdct4x4,
                                               fdct8x8_h264_xla,
                                               hadamard4x4, idct4x4,
                                               idct8x8_h264, quant, quant_mf)
from libav_tpu_torch.ops.me import search

# 4x4 luma block index -> (blkX, blkY) in 4x4 units (spec 6.4.3)
_BLK_XY = np.array([(2 * ((i >> 2) & 1) + (i & 1),
                     2 * (i >> 3) + ((i >> 1) & 1)) for i in range(16)],
                   dtype=np.int32)
# neighbours each intra 4x4/8x8 mode needs: (top, left, topleft)
_MODE_NEEDS = np.array([(1, 0, 0), (0, 1, 0), (0, 0, 0), (1, 0, 0),
                        (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 0, 0),
                        (0, 1, 0)], np.int32)
# quarter-pel refinement offsets
_OFFS = np.array([(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
                  (1, 1), (1, -1), (-1, 1), (-1, -1)], dtype=np.int32)
_BIG = 1 << 30


def first_min(costs):
    """Index of the least of a list of (B,) costs, the first on a tie
    (jnp.argmin's rule), and that cost: a chain of strict comparisons."""
    best = costs[0]
    pick = torch.zeros_like(best)
    for k in range(1, len(costs)):
        better = costs[k] < best
        pick = torch.where(better, k, pick)
        best = torch.where(better, costs[k], best)
    return pick, best


def _mbs(plane: torch.Tensor, mb_w: int, mb_h: int, s: int) -> torch.Tensor:
    """(mb_h*s, mb_w*s) plane -> (nmb, s, s) int32 macroblocks."""
    return (plane.to(torch.int32).reshape(mb_h, s, mb_w, s)
            .permute(0, 2, 1, 3).reshape(mb_w * mb_h, s, s))


def _blocks4(resid: torch.Tensor, order) -> torch.Tensor:
    """(B, n, n) -> (B, len(order), 4, 4) blocks at (bx, by) in 4x4
    units."""
    return torch.stack([resid[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                        for bx, by in order], dim=1)


def _place4(blocks: torch.Tensor, order, n: int) -> torch.Tensor:
    """Inverse of _blocks4: (B, k, 4, 4) -> (B, n, n)."""
    out = blocks.new_zeros((blocks.shape[0], n, n))
    for b, (bx, by) in enumerate(order):
        out[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = blocks[:, b]
    return out


_CHROMA_ORDER = [(b & 1, b >> 1) for b in range(4)]


def _chroma_dc(w: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard of the four blocks' DC coefficients, (B, 4)."""
    a, b, c, d = (w[:, k] for k in range(4))
    return torch.stack([a + b + c + d, a - b + c - d,
                        a + b - c - d, a - b - c + d], dim=1)


class _Quant:
    """The quantiser constants of one qp and intra/inter rounding."""

    def __init__(self, qp: int, div: int, device):
        self.mf = torch.as_tensor(quant_mf(qp)).to(device)
        self.mf0 = int(quant_mf(qp)[0, 0])
        self.scale = torch.as_tensor(dequant_scale(qp)).to(device)
        self.qbits = 15 + qp // 6
        self.f = (1 << self.qbits) // div
        self.div = div
        self.v0 = int(_V[qp % 6, 0])
        self.qp = qp


def chroma_levels(resid: torch.Tensor, q: _Quant):
    """(B, 8, 8) chroma residual -> (dc levels (B, 4), ac levels (B, 4,
    4, 4) with the DC positions zero, raw coefficients)."""
    wv = fdct4x4(_blocks4(resid, _CHROMA_ORDER).reshape(-1, 4, 4)) \
        .reshape(-1, 4, 4, 4)
    had = _chroma_dc(wv[:, :, 0, 0])
    dc_lv = quant(had, q.mf0, (1 << (q.qbits + 1)) // q.div, q.qbits + 1)
    ac_lv = quant(wv, q.mf, q.f, q.qbits)
    ac_lv[:, :, 0, 0] = 0
    return dc_lv, ac_lv


def chroma_recon(dc_lv, ac_lv, q: _Quant) -> torch.Tensor:
    """The decoder's chroma reconstruction of (dc, ac) levels -> the
    (B, 8, 8) residual."""
    dc_deq = ((_chroma_dc(dc_lv) * q.v0) << (q.qp // 6)) >> 1
    deq = ac_lv * q.scale
    deq[:, :, 0, 0] = dc_deq
    rec = idct4x4(deq.reshape(-1, 4, 4)).reshape(-1, 4, 4, 4)
    return _place4(rec, _CHROMA_ORDER, 8)


def _put(frame, y0, x0, block):
    """Write each MB's (n, n) block at (y0, x0) of the frame buffer."""
    r = torch.arange(block.shape[-1], device=frame.device)
    frame[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]] = \
        block


def _dc_pred(frame, yy, xx, n: int, has_t, has_l):
    r = torch.arange(n, device=frame.device)
    ts = frame[(yy - 1)[:, None], xx[:, None] + r].sum(1, dtype=torch.int32)
    ls = frame[yy[:, None] + r, (xx - 1)[:, None]].sum(1, dtype=torch.int32)
    lg = int(np.log2(n))
    return torch.where(has_t & has_l, (ts + ls + n) >> (lg + 1),
                       torch.where(has_t, (ts + n // 2) >> lg,
                                   torch.where(has_l, (ls + n // 2) >> lg,
                                               128)))


class _Intra(nn.Module):
    """Shared part of the intra programs: the wave tables of an mb_w x
    mb_h picture (slope 1: x+y waves, 2: x+2y), the chroma quantiser and
    the frame buffers."""

    def __init__(self, mb_w: int, mb_h: int, qp: int, slope: int):
        super().__init__()
        self.mb_w, self.mb_h, self.qp = mb_w, mb_h, qp
        self.qpc = int(CHROMA_QP[qp])
        n_waves = (mb_w - 1) + slope * (mb_h - 1) + 1
        waves = [[] for _ in range(n_waves)]
        for y in range(mb_h):
            for x in range(mb_w):
                waves[x + slope * y].append((y * mb_w + x, x, y))
        self.wave_counts = [len(w) for w in waves]
        tab = np.zeros((n_waves, max(self.wave_counts), 3), np.int64)
        for w, wv in enumerate(waves):
            tab[w, :len(wv)] = wv
        self.register_buffer("wave_tab", torch.as_tensor(tab))
        self.register_buffer("mode_needs", torch.as_tensor(
            _MODE_NEEDS.astype(bool))[:, :, None])
        self.register_buffer("modes", torch.arange(
            9, dtype=torch.int32)[:, None])

    def _setup(self, src_y, src_u, src_v):
        """-> (frame buffers, source macroblocks, the chroma quantiser)."""
        dev = src_y.device
        mb_w, mb_h = self.mb_w, self.mb_h
        H, W = 16 * mb_h, 16 * mb_w
        i32 = torch.int32
        fy = torch.full((1 + H + 16, 1 + W + 16), 128, dtype=i32, device=dev)
        fu = torch.full((1 + H // 2 + 8, 1 + W // 2 + 8), 128, dtype=i32,
                        device=dev)
        fv = fu.clone()
        return (fy, fu, fv), (_mbs(src_y, mb_w, mb_h, 16),
                              _mbs(src_u, mb_w, mb_h, 8),
                              _mbs(src_v, mb_w, mb_h, 8)), \
            _Quant(self.qpc, 3, dev)

    def _waves(self, row_top):
        for w, count in enumerate(self.wave_counts):
            wt = self.wave_tab[w, :count]
            idx, bx, by = wt[:, 0], wt[:, 1], wt[:, 2]
            at = (by > 0) if row_top is None else row_top[by]
            yield idx, bx, by, at, bx > 0

    def _chroma(self, qc, frames, srcs, idx, bx, by, at, al):
        """DC-predicted chroma of one wave: levels out, recon written."""
        cy0, cx0 = by * 8 + 1, bx * 8 + 1
        out = []
        for f, s in zip(frames, srcs):
            dc = _dc_pred(f, cy0, cx0, 8, at, al)
            dc_lv, ac_lv = chroma_levels(s[idx] - dc[:, None, None], qc)
            rr = chroma_recon(dc_lv, ac_lv, qc)
            _put(f, cy0, cx0, (dc[:, None, None] + rr).clamp(0, 255))
            out += [dc_lv, ac_lv]
        return out

    def _planes(self, fy, fu, fv):
        H, W = 16 * self.mb_h, 16 * self.mb_w
        return (fy[1:1 + H, 1:1 + W].to(torch.uint8),
                fu[1:1 + H // 2, 1:1 + W // 2].to(torch.uint8),
                fv[1:1 + H // 2, 1:1 + W // 2].to(torch.uint8))

    def _outputs(self, nmb, dev, shapes):
        return [torch.zeros((nmb, *s), dtype=torch.int32, device=dev)
                for s in shapes]


class EncodeI16(_Intra):
    """The JAX _encode_i_jit program: (src_y, src_u, src_v[, row_top]) ->
    ((luma dc (nmb, 4, 4), luma ac (nmb, 16, 4, 4), u dc (nmb, 4), u ac
    (nmb, 4, 4, 4), v dc, v ac) levels in MB order, (y, u, v) uint8
    recon)."""

    def __init__(self, mb_w: int, mb_h: int, qp: int):
        super().__init__(mb_w, mb_h, qp, 1)
        self.shift = 2 - qp // 6
        self.register_buffer("blk_x", torch.as_tensor(_BLK_XY[:, 0]).long())
        self.register_buffer("blk_y", torch.as_tensor(_BLK_XY[:, 1]).long())

    def _luma(self, resid, q: _Quant):
        B = resid.shape[0]
        wv = fdct4x4(_blocks4(resid, _BLK_XY).reshape(-1, 4, 4)) \
            .reshape(B, 16, 4, 4)
        bx, by = self.blk_x, self.blk_y
        dcg = torch.zeros((B, 4, 4), dtype=torch.int32, device=resid.device)
        dcg[:, by, bx] = wv[:, :, 0, 0]
        dc_lv = quant(hadamard4x4(dcg), q.mf0, (1 << (q.qbits + 2)) // 3,
                      q.qbits + 2)
        ac_lv = quant(wv, q.mf, q.f, q.qbits)
        ac_lv[:, :, 0, 0] = 0
        f2 = hadamard4x4(dc_lv)
        if self.shift > 0:
            dc_deq = (f2 * q.v0 + (1 << (self.shift - 1))) >> self.shift
        else:
            dc_deq = (f2 * q.v0) << (-self.shift)
        deq = ac_lv * q.scale
        deq[:, :, 0, 0] = dc_deq[:, by, bx]
        rec = idct4x4(deq.reshape(-1, 4, 4)).reshape(B, 16, 4, 4)
        return dc_lv, ac_lv, _place4(rec, _BLK_XY, 16)

    def forward(self, src_y, src_u, src_v, row_top=None):
        dev = src_y.device
        (fy, fu, fv), (sy, su, sv), qc = self._setup(src_y, src_u, src_v)
        qy = _Quant(self.qp, 3, dev)
        outs = self._outputs(self.mb_w * self.mb_h, dev, [
            (4, 4), (16, 4, 4), (4,), (4, 4, 4), (4,), (4, 4, 4)])
        for idx, bx, by, at, al in self._waves(row_top):
            y0, x0 = by * 16 + 1, bx * 16 + 1
            dcy = _dc_pred(fy, y0, x0, 16, at, al)
            ydc, yac, yrr = self._luma(sy[idx] - dcy[:, None, None], qy)
            _put(fy, y0, x0, (dcy[:, None, None] + yrr).clamp(0, 255))
            vals = [ydc, yac] + self._chroma(qc, (fu, fv), (su, sv), idx,
                                             bx, by, at, al)
            for o, v in zip(outs, vals):
                o[idx] = v
        return tuple(outs), self._planes(fy, fu, fv)


def _neighbours(fy, y0, x0, dev):
    """The (B, 17, 25) patch of an MB's reconstructed neighbours: top-left
    at [0, 0], top row [0, 1:17], top-right [0, 17:25], left column
    [1:17, 0]."""
    r16 = torch.arange(16, device=dev)
    r8 = torch.arange(8, device=dev)
    patch = torch.zeros((y0.shape[0], 17, 25), dtype=torch.int32,
                        device=dev)
    patch[:, 0, 0] = fy[y0 - 1, x0 - 1]
    patch[:, 0, 1:17] = fy[(y0 - 1)[:, None], x0[:, None] + r16]
    patch[:, 0, 17:25] = fy[(y0 - 1)[:, None], x0[:, None] + 16 + r8]
    patch[:, 1:17, 0] = fy[y0[:, None] + r16, (x0 - 1)[:, None]]
    return patch


def _mode_choice(need, modes, preds, srcb, av_t, av_l, av_tl):
    """The nine candidate predictions (9, B, n, n) -> (mode (B,), its
    prediction): least SAD over the modes whose neighbours exist, the
    first on a tie (the index of the first cost equal to the minimum).
    need: (9, 3, 1) bool _MODE_NEEDS, modes: (9, 1) int32 0..8."""
    ok = ((~need[:, 0] | av_t) & (~need[:, 1] | av_l)
          & (~need[:, 2] | av_tl))                               # (9, B)
    sad = (srcb - preds).abs().sum(dim=(2, 3), dtype=torch.int32)
    cost = torch.where(ok, sad, _BIG)
    mode = torch.where(cost == cost.min(0).values, modes, 9).min(0).values
    pred = torch.gather(preds, 0, mode.long()[None, :, None, None].expand(
        1, *preds.shape[1:]))[0]
    return mode, pred


def _all_modes(fn, B, *args):
    """fn(mode, *args) for the nine modes in one call: (9, B, ...)."""
    dev = args[0].device
    mode = torch.arange(9, dtype=torch.int32, device=dev).repeat_interleave(B)
    rep = [a.repeat((9,) + (1,) * (a.dim() - 1)) for a in args]
    out = fn(mode, *rep)
    return out.reshape(9, B, *out.shape[1:])


class EncodeI4(_Intra):
    """The JAX _encode_i4_jit program: (src_y, src_u, src_v[, row_top])
    -> ((modes (nmb, 16), levels (nmb, 16, 4, 4) raster, u dc, u ac, v dc,
    v ac) in MB order, (y, u, v) uint8 recon)."""

    def __init__(self, mb_w: int, mb_h: int, qp: int):
        super().__init__(mb_w, mb_h, qp, 2)
        zidx = {(int(_BLK_XY[b][0]), int(_BLK_XY[b][1])): b
                for b in range(16)}
        self.tr_in_mb = np.zeros(16, bool)
        for b in range(16):
            bx4, by4 = int(_BLK_XY[b][0]), int(_BLK_XY[b][1])
            if by4 > 0 and bx4 < 3:
                self.tr_in_mb[b] = zidx[(bx4 + 1, by4 - 1)] < b

    def forward(self, src_y, src_u, src_v, row_top=None):
        dev = src_y.device
        (fy, fu, fv), (sy, su, sv), qc = self._setup(src_y, src_u, src_v)
        qy = _Quant(self.qp, 3, dev)
        outs = self._outputs(self.mb_w * self.mb_h, dev, [
            (16,), (16, 4, 4), (4,), (4, 4, 4), (4,), (4, 4, 4)])
        for idx, bx, by, at, al in self._waves(row_top):
            B = idx.shape[0]
            y0, x0 = by * 16 + 1, bx * 16 + 1
            rtrue = torch.ones((B,), dtype=torch.bool, device=dev)
            patch = _neighbours(fy, y0, x0, dev)
            atr_frame = at & (bx < self.mb_w - 1)
            src_mb = sy[idx]
            modes, levels = [], []
            for b in range(16):
                bx4, by4 = int(_BLK_XY[b][0]), int(_BLK_XY[b][1])
                px0, py0 = 1 + 4 * bx4, 1 + 4 * by4
                t4 = patch[:, py0 - 1, px0:px0 + 4]
                l4v = patch[:, py0:py0 + 4, px0 - 1]
                tlv = patch[:, py0 - 1, px0 - 1]
                tr4 = patch[:, py0 - 1, px0 + 4:px0 + 8]
                if by4 > 0:
                    tr_ok = rtrue if self.tr_in_mb[b] else ~rtrue
                elif bx4 == 3:
                    tr_ok = atr_frame
                else:
                    tr_ok = at
                tr4 = torch.where(tr_ok[:, None], tr4, t4[:, 3:4])
                t8v = torch.cat([t4, tr4], dim=1)
                av_t = at if by4 == 0 else rtrue
                av_l = al if bx4 == 0 else rtrue
                if by4 > 0 and bx4 > 0:
                    av_tl = rtrue
                elif by4 == 0 and bx4 > 0:
                    av_tl = at
                elif by4 > 0:
                    av_tl = al
                else:
                    av_tl = at & al
                srcb = src_mb[:, 4 * by4:4 * by4 + 4, 4 * bx4:4 * bx4 + 4]
                preds = _all_modes(pred4x4, B, t8v, l4v, tlv, av_t, av_l)
                mode, pred = _mode_choice(self.mode_needs, self.modes, preds,
                                          srcb, av_t, av_l, av_tl)
                lv = quant(fdct4x4(srcb - pred), qy.mf, qy.f, qy.qbits)
                patch[:, py0:py0 + 4, px0:px0 + 4] = \
                    (pred + idct4x4(lv * qy.scale)).clamp(0, 255)
                modes.append(mode)
                levels.append(lv)
            _put(fy, y0, x0, patch[:, 1:17, 1:17])
            vals = [torch.stack(modes, 1), torch.stack(levels, 1)] + \
                self._chroma(qc, (fu, fv), (su, sv), idx, bx, by, at, al)
            for o, v in zip(outs, vals):
                o[idx] = v
        return tuple(outs), self._planes(fy, fu, fv)


class EncodeI8(_Intra):
    """The JAX _encode_i8_jit program: (src_y, src_u, src_v[, row_top])
    -> ((modes (nmb, 4), levels (nmb, 4, 8, 8) raster, u dc, u ac, v dc,
    v ac) in MB order, (y, u, v) uint8 recon)."""

    def __init__(self, mb_w: int, mb_h: int, qp: int):
        super().__init__(mb_w, mb_h, qp, 2)
        self.register_buffer("ls8", torch.as_tensor(dequant8x8_tab(qp)))

    def _deq8(self, lv):
        """Exact 8x8 dequant (spec 8.5.13), flat W."""
        q6 = self.qp // 6
        if q6 >= 6:
            return (lv * self.ls8) << (q6 - 6)
        return (lv * self.ls8 + (1 << (5 - q6))) >> (6 - q6)

    def forward(self, src_y, src_u, src_v, row_top=None):
        dev = src_y.device
        (fy, fu, fv), (sy, su, sv), qc = self._setup(src_y, src_u, src_v)
        outs = self._outputs(self.mb_w * self.mb_h, dev, [
            (4,), (4, 8, 8), (4,), (4, 4, 4), (4,), (4, 4, 4)])
        for idx, bx, by, at, al in self._waves(row_top):
            B = idx.shape[0]
            y0, x0 = by * 16 + 1, bx * 16 + 1
            rtrue = torch.ones((B,), dtype=torch.bool, device=dev)
            atr_frame = at & (bx < self.mb_w - 1)
            patch = _neighbours(fy, y0, x0, dev)
            quad_av = [(at, al, at & al, at),
                       (at, rtrue, at, atr_frame),
                       (rtrue, al, al, rtrue),
                       (rtrue, rtrue, rtrue, ~rtrue)]
            src_mb = sy[idx]
            modes, levels = [], []
            for b in range(4):
                qx, qy = (b & 1) * 8, (b >> 1) * 8
                px0, py0 = 1 + qx, 1 + qy
                top16 = patch[:, py0 - 1, px0:px0 + 16]
                left8 = patch[:, py0:py0 + 8, px0 - 1]
                tl8 = patch[:, py0 - 1, px0 - 1]
                av_t, av_l, av_tl, av_tr = quad_av[b]
                srcb = src_mb[:, qy:qy + 8, qx:qx + 8]
                preds = _all_modes(pred8x8_luma, B, top16, left8, tl8, av_t,
                                   av_l, av_tl, av_tr)
                mode, pred = _mode_choice(self.mode_needs, self.modes, preds,
                                          srcb, av_t, av_l, av_tl)
                lv = fdct8x8_h264_xla(srcb - pred, self.qp)
                patch[:, py0:py0 + 8, px0:px0 + 8] = \
                    (pred + idct8x8_h264(self._deq8(lv))).clamp(0, 255)
                modes.append(mode)
                levels.append(lv)
            _put(fy, y0, x0, patch[:, 1:17, 1:17])
            vals = [torch.stack(modes, 1), torch.stack(levels, 1)] + \
                self._chroma(qc, (fu, fv), (su, sv), idx, bx, by, at, al)
            for o, v in zip(outs, vals):
                o[idx] = v
        return tuple(outs), self._planes(fy, fu, fv)


class _Inter(nn.Module):
    """Shared part of the P and B programs: MB origins, the search and
    the quarter-pel refinement around its vectors."""

    def __init__(self, mb_w: int, mb_h: int, qp: int, search_range: int):
        super().__init__()
        self.mb_w, self.mb_h, self.qp = mb_w, mb_h, qp
        self.qpc = int(CHROMA_QP[qp])
        self.search_range = search_range
        nmb = mb_w * mb_h
        self.register_buffer("mbx", torch.as_tensor(
            ((np.arange(nmb) % mb_w) * 16).astype(np.int32)))
        self.register_buffer("mby", torch.as_tensor(
            ((np.arange(nmb) // mb_w) * 16).astype(np.int32)))
        self.register_buffer("offs", torch.as_tensor(_OFFS))

    def _search_one(self, cur_mbs, ref):
        """Full-pel search, then two passes of the nine offsets at half
        and quarter pel: (quarter-pel mv (nmb, 2), its SAD)."""
        fmv, _ = search(self.mb_w, self.mb_h, self.search_range,
                        device=cur_mbs.device)(cur_mbs, ref)
        best = torch.full((cur_mbs.shape[0],), _BIG, dtype=torch.int32,
                          device=cur_mbs.device)
        out_mv = fmv * 4
        for scale in (2, 1):
            mv = out_mv
            for k in range(len(_OFFS)):
                cand = mv + self.offs[k] * scale
                pred = h264mc.qpel_mc(ref, self.mbx, self.mby, cand[:, 0],
                                      cand[:, 1], 16)
                sad = (cur_mbs - pred).abs().sum(dim=(1, 2),
                                                 dtype=torch.int32)
                out_mv = torch.where((sad < best)[:, None], cand, out_mv)
                best = torch.minimum(sad, best)
        return out_mv, best

    def _luma_levels(self, resid_y, q: _Quant):
        nmb = resid_y.shape[0]
        wy = fdct4x4(_blocks4(resid_y, _BLK_XY).reshape(-1, 4, 4)) \
            .reshape(nmb, 16, 4, 4)
        return quant(wy, q.mf, q.f, q.qbits)


class EncodeP(_Inter):
    """The JAX _encode_p_jit program: (src_y, src_u, src_v, ry, ru, rv)
    -> (mv (nmb, 2) quarter-pel, luma levels (nmb, 16, 4, 4), u dc, u ac,
    v dc, v ac, ref_idx (nmb,)[, 8x8 luma levels (nmb, 4, 8, 8) raster
    with dct8]). With nrefs > 1 the references are (R, Hp, Wp) stacks and
    each MB takes the cheaper one (a bias of 16 per index)."""

    def __init__(self, mb_w: int, mb_h: int, qp: int, search_range: int = 12,
                 cdy: int = 0, nrefs: int = 1, dct8: bool = False):
        super().__init__(mb_w, mb_h, qp, search_range)
        self.cdy, self.nrefs, self.dct8 = cdy, nrefs, dct8

    def forward(self, src_y, src_u, src_v, ry, ru, rv):
        dev = src_y.device
        mb_w, mb_h = self.mb_w, self.mb_h
        cur_mbs = _mbs(src_y, mb_w, mb_h, 16)
        cx, cy = self.mbx // 2, self.mby // 2
        if self.nrefs == 1:
            mv, _ = self._search_one(cur_mbs, ry)
            ref_idx = torch.zeros((cur_mbs.shape[0],), dtype=torch.int32,
                                  device=dev)
            pred_y = h264mc.qpel_mc(ry, self.mbx, self.mby, mv[:, 0],
                                    mv[:, 1], 16)
            cmvy = mv[:, 1] + self.cdy if self.cdy else mv[:, 1]
            pred_u = h264mc.chroma_mc(ru, cx, cy, mv[:, 0], cmvy, 8)
            pred_v = h264mc.chroma_mc(rv, cx, cy, mv[:, 0], cmvy, 8)
        else:
            mvs, costs = [], []
            for r in range(self.nrefs):
                m, c = self._search_one(cur_mbs, ry[r])
                mvs.append(m)
                costs.append(c + 16 * r)   # te(v)+pred coding-cost bias
            ref_idx, _ = first_min(costs)
            mv = mvs[0]
            for r in range(1, self.nrefs):
                mv = torch.where((ref_idx == r)[:, None], mvs[r], mv)
            pred_y = h264mc.qpel_mc(ry, self.mbx, self.mby, mv[:, 0],
                                    mv[:, 1], 16, ref_idx)
            pred_u = h264mc.chroma_mc(ru, cx, cy, mv[:, 0], mv[:, 1], 8,
                                      ref_idx)
            pred_v = h264mc.chroma_mc(rv, cx, cy, mv[:, 0], mv[:, 1], 8,
                                      ref_idx)
        resid_y = cur_mbs - pred_y
        luma_lv = self._luma_levels(resid_y, _Quant(self.qp, 6, dev))
        qc = _Quant(self.qpc, 6, dev)
        udc, uac = chroma_levels(_mbs(src_u, mb_w, mb_h, 8) - pred_u, qc)
        vdc, vac = chroma_levels(_mbs(src_v, mb_w, mb_h, 8) - pred_v, qc)
        out = (mv, luma_lv, udc, uac, vdc, vac, ref_idx)
        if self.dct8:
            q8 = torch.stack([resid_y[:, (b >> 1) * 8:(b >> 1) * 8 + 8,
                                      (b & 1) * 8:(b & 1) * 8 + 8]
                              for b in range(4)], dim=1)
            out += (fdct8x8_h264_xla(q8, self.qp),)
        return out


class EncodeB(_Inter):
    """The JAX _encode_b_jit program: (src_y, src_u, src_v, ry0, ru0,
    rv0, ry1, ru1, rv1) -> (sel (nmb,) 0 L0 / 1 L1 / 2 Bi, mv0, mv1
    (unused lists zero), luma levels, u dc, u ac, v dc, v ac)."""

    def __init__(self, mb_w: int, mb_h: int, qp: int,
                 search_range: int = 12):
        super().__init__(mb_w, mb_h, qp, search_range)

    def forward(self, src_y, src_u, src_v, ry0, ru0, rv0, ry1, ru1, rv1):
        dev = src_y.device
        mb_w, mb_h = self.mb_w, self.mb_h
        cur_mbs = _mbs(src_y, mb_w, mb_h, 16)
        mv0, c0 = self._search_one(cur_mbs, ry0)
        mv1, c1 = self._search_one(cur_mbs, ry1)
        p0y = h264mc.qpel_mc(ry0, self.mbx, self.mby, mv0[:, 0], mv0[:, 1],
                             16)
        p1y = h264mc.qpel_mc(ry1, self.mbx, self.mby, mv1[:, 0], mv1[:, 1],
                             16)
        pbi = (p0y + p1y + 1) >> 1
        cbi = (cur_mbs - pbi).abs().sum(dim=(1, 2), dtype=torch.int32) + 32
        sel, _ = first_min([c0, c1 + 8, cbi])
        mv0 = torch.where((sel != 1)[:, None], mv0, 0)
        mv1 = torch.where((sel != 0)[:, None], mv1, 0)
        s3 = sel[:, None, None]

        def pick(q0, q1, qbi):
            return torch.where(s3 == 0, q0, torch.where(s3 == 1, q1, qbi))

        pred_y = pick(p0y, p1y, pbi)
        cx, cy = self.mbx // 2, self.mby // 2

        def cmc(r0, r1):
            q0 = h264mc.chroma_mc(r0, cx, cy, mv0[:, 0], mv0[:, 1], 8)
            q1 = h264mc.chroma_mc(r1, cx, cy, mv1[:, 0], mv1[:, 1], 8)
            return pick(q0, q1, (q0 + q1 + 1) >> 1)

        pred_u = cmc(ru0, ru1)
        pred_v = cmc(rv0, rv1)
        luma_lv = self._luma_levels(cur_mbs - pred_y, _Quant(self.qp, 6, dev))
        qc = _Quant(self.qpc, 6, dev)
        udc, uac = chroma_levels(_mbs(src_u, mb_w, mb_h, 8) - pred_u, qc)
        vdc, vac = chroma_levels(_mbs(src_v, mb_w, mb_h, 8) - pred_v, qc)
        return sel, mv0, mv1, luma_lv, udc, uac, vdc, vac


@functools.lru_cache(maxsize=32)
def encode_i16(mb_w: int, mb_h: int, qp: int, *,
               device: torch.device) -> EncodeI16:
    """_encode_i_jit's key plus the device -> the module on device."""
    return EncodeI16(mb_w, mb_h, qp).to(device)


@functools.lru_cache(maxsize=32)
def encode_i4(mb_w: int, mb_h: int, qp: int, *,
              device: torch.device) -> EncodeI4:
    return EncodeI4(mb_w, mb_h, qp).to(device)


@functools.lru_cache(maxsize=32)
def encode_i8(mb_w: int, mb_h: int, qp: int, *,
              device: torch.device) -> EncodeI8:
    return EncodeI8(mb_w, mb_h, qp).to(device)


@functools.lru_cache(maxsize=32)
def encode_p(mb_w: int, mb_h: int, qp: int, search_range: int = 12,
             cdy: int = 0, nrefs: int = 1, dct8: bool = False, *,
             device: torch.device) -> EncodeP:
    return EncodeP(mb_w, mb_h, qp, search_range, cdy, nrefs,
                   dct8).to(device)


@functools.lru_cache(maxsize=32)
def encode_b(mb_w: int, mb_h: int, qp: int, search_range: int = 12, *,
             device: torch.device) -> EncodeB:
    return EncodeB(mb_w, mb_h, qp, search_range).to(device)
