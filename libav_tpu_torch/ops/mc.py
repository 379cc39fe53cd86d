"""Reference-plane padding, patch gathers, half-pel and MPEG-4
quarter-sample motion compensation and the chroma vector rules
(counterpart of `libav_tpu/ops/mc.py`: EDGE, pad_plane, mc_hpel,
avg_pred, chroma_mv_div2, chroma_mv_h263, chroma_mv_h263_4mv, the qpel
lowpass matrix, mc_qpel_mpeg4 (+ _ref, _8, _tiled8), mc_hpel_tiled8,
chroma_mv_4mv_hpel/_qpel and chroma_mv_qpel; reference: hpeldsp.h
put_pixels_tab, qpeldsp.c and mpegvideo_motion.c mpeg_motion, qpel_motion
and apply_8x8).

Every block's source patch is gathered from the edge-padded reference in
one indexing op. The patch origin follows `lax.dynamic_slice`'s start
index rule (a negative start counts from the end of the axis, then the
window is clamped into range), so a motion vector that points further
than EDGE outside the frame reads the same pixels in both packages.
The quarter-sample MC clips its patch origin into the plane first, as
the JAX function does, so it never wraps.

The qpel lowpass is the JAX package's constant (n + 1, n) tap matrix,
applied as a float32 matmul: CUDA's torch.matmul takes no integer
tensors. Every input is an integer in [0, 255] and every tap an integer
whose magnitudes sum to 60 per column, so each product and every partial
sum is an integer below 2^24 in magnitude and float32 holds it exactly
in any summation order (TF32 too, whose 11-bit significands hold both
factors exactly).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

EDGE = 16   # reference: mpegvideo EDGE_WIDTH — frame padding for MC


def pad_plane(plane: torch.Tensor, edge: int = EDGE) -> torch.Tensor:
    """Edge-replicate pad of a 2-D plane of any dtype (reference: videodsp
    emulated_edge_mc / draw_edges). Written as a clamped gather because
    torch's replicate padding does not take integer tensors."""
    h, w = plane.shape
    rows = torch.arange(-edge, h + edge, device=plane.device).clamp_(0, h - 1)
    cols = torch.arange(-edge, w + edge, device=plane.device).clamp_(0, w - 1)
    return plane[rows[:, None], cols[None, :]]


def pad_rows(plane: torch.Tensor, edge: int = EDGE) -> torch.Tensor:
    """Edge-replicate pad of the rows only (columns keep their padding)."""
    h = plane.shape[0]
    rows = torch.arange(-edge, h + edge, device=plane.device).clamp_(0, h - 1)
    return plane[rows]


def dynamic_slice_start(i: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """lax.dynamic_slice's start of an n-wide window on an axis of dim."""
    i = i.long()
    return torch.where(i < 0, i + dim, i).clamp(0, dim - n)


def gather_patches(padded: torch.Tensor, y0: torch.Tensor,
                   x0: torch.Tensor, n: int,
                   ridx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, n, n) int32 windows of padded (Hp, Wp) or (R, Hp, Wp) at
    (y0, x0) [and reference ridx]."""
    hp, wp = padded.shape[-2:]
    r = torch.arange(n, device=padded.device)
    rows = (dynamic_slice_start(y0, hp, n)[:, None] + r)[:, :, None]
    cols = (dynamic_slice_start(x0, wp, n)[:, None] + r)[:, None, :]
    if ridx is None:
        return padded[rows, cols].to(torch.int32)
    ri = dynamic_slice_start(ridx, padded.shape[0], 1)[:, None, None]
    return padded[ri, rows, cols].to(torch.int32)


def mc_hpel(padded: torch.Tensor, xs, ys, mvx, mvy, size: int,
            rnd: int = 1, ridx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched half-pel MC. padded (H+2E, W+2E) uint8/int32, or an
    (R, Hp, Wp) stack with ridx (B,) picking each block's reference;
    xs, ys, mvx, mvy (B,) int. -> (B, size, size) int32. All four phases
    are computed and selected per block, as in the JAX package."""
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    x0 = xs + (mvx >> 1) + EDGE
    y0 = ys + (mvy >> 1) + EDGE
    fx = (mvx & 1)[:, None, None].bool()
    fy = (mvy & 1)[:, None, None].bool()
    p = gather_patches(padded, y0, x0, size + 1, ridx)
    p00 = p[:, :size, :size]
    p01 = p[:, :size, 1:]
    p10 = p[:, 1:, :size]
    p11 = p[:, 1:, 1:]
    h = (p00 + p01 + rnd) >> 1
    v = (p00 + p10 + rnd) >> 1
    hv = (p00 + p01 + p10 + p11 + 1 + rnd) >> 2
    return torch.where(fx & fy, hv, torch.where(fx, h, torch.where(fy, v,
                                                                   p00)))


def avg_pred(a, b):
    """Bidirectional average (reference: hpeldsp avg_pixels)."""
    return (a + b + 1) >> 1


def chroma_mv_div2(mv: torch.Tensor) -> torch.Tensor:
    """MPEG-1/2 chroma motion vector: luma mv / 2 truncated toward zero
    (ISO 11172-2 §2.4.4.2). torch's integer // and % floor, as numpy's
    and jax's do, so the JAX package's expression carries over."""
    return mv // 2 + ((mv % 2) != 0) * (mv < 0)


def chroma_mv_h263(mv: torch.Tensor) -> torch.Tensor:
    """H.263 / MPEG-4 1MV chroma vector in chroma half-pel units
    (reference: mpegvideo_motion.c mpeg_motion_internal, FMT_H263): half
    pel whenever mv % 4 != 0, integer part mv >> 2."""
    return 2 * (mv >> 2) + ((mv & 3) != 0).to(mv.dtype)


def chroma_mv_h263_ref(mv):
    """The JAX package's numpy reference, copied."""
    return 2 * (mv >> 2) + ((mv & 3) != 0).astype(mv.dtype)


_H263_CHROMA_ROUNDTAB = np.array(
    [0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=np.int32)


def chroma_mv_h263_4mv(mv_sum: torch.Tensor) -> torch.Tensor:
    """H.263/MPEG-4 4MV chroma vector from the SUM of the four luma
    vectors (reference: motion_est.h:96 ff_h263_round_chroma:
    roundtab[x & 0xf] + (x >> 3))."""
    tab = torch.as_tensor(_H263_CHROMA_ROUNDTAB, device=mv_sum.device)
    return (tab[(mv_sum & 0xF).long()] + (mv_sum >> 3)).to(torch.int32)


def _trunc_half(mv: torch.Tensor) -> torch.Tensor:
    """C integer division by 2 (toward zero)."""
    return torch.where(mv >= 0, mv >> 1, -((-mv) >> 1))


def chroma_mv_4mv_hpel(mv4: torch.Tensor) -> torch.Tensor:
    """Chroma vector from four half-pel luma vectors (B, 4, 2): plain sum
    + 4MV rounding (apply_8x8 + chroma_4mv_motion)."""
    return chroma_mv_h263_4mv(mv4.to(torch.int32).sum(dim=1,
                                                      dtype=torch.int32))


def chroma_mv_4mv_qpel(mv4: torch.Tensor) -> torch.Tensor:
    """Chroma vector from four quarter-pel luma vectors: each C-trunc
    halved, summed, then 4MV rounding (apply_8x8 quarter branch)."""
    t = _trunc_half(mv4.to(torch.int32))
    return chroma_mv_h263_4mv(t.sum(dim=1, dtype=torch.int32))


def chroma_mv_qpel(mv: torch.Tensor) -> torch.Tensor:
    """Chroma half-pel vector from a quarter-sample luma vector
    (reference: mpegvideo_motion.c qpel_motion: trunc-div by 2, then the
    (x >> 1) | (x & 1) half-pel rounding)."""
    t = _trunc_half(mv.to(torch.int32))
    return (t >> 1) | (t & 1)


def _qpel_lowpass_matrix(n: int = 16) -> np.ndarray:
    """M[i, j]: contribution of src[i] (0..n) to dst[j] (0..n-1),
    transcribed from qpeldsp.c mpeg4_qpel16_h_lowpass (n=16) /
    mpeg4_qpel8_h_lowpass (n=8) — edge taps reflect within the n+1
    extended block, which is why 8x8-tiled MC differs from 16x16.
    The JAX package's numpy code, copied."""
    M = np.zeros((n + 1, n), dtype=np.int32)
    for j in range(n):
        pairs = [((j, j + 1), 20),
                 ((j - 1, j + 2), -6),
                 ((j - 2, j + 3), 3),
                 ((j - 3, j + 4), -1)]
        for (i1, i2), w in pairs:
            for i in (i1, i2):
                if i < 0:
                    i = -i - 1          # left reflection 0,1,2 pattern
                if i > n:
                    i = 2 * n + 1 - i   # right reflection
                M[i, j] += w
    return M


def mc_qpel_mpeg4_ref(padded: np.ndarray, xs, ys, mvx, mvy,
                      no_rnd: int = 0) -> np.ndarray:
    """Golden scalar MPEG-4 quarter-sample 16x16 MC (put / put_no_rnd);
    the JAX package's numpy reference, copied."""
    M = _qpel_lowpass_matrix()
    r1 = 15 if no_rnd else 16
    a2 = 0 if no_rnd else 1
    B = len(xs)
    out = np.zeros((B, 16, 16), dtype=np.int32)
    for i in range(B):
        x0 = int(xs[i]) + (int(mvx[i]) >> 2) + EDGE
        y0 = int(ys[i]) + (int(mvy[i]) >> 2) + EDGE
        dx, dy = int(mvx[i]) & 3, int(mvy[i]) & 3
        p = padded[y0:y0 + 17, x0:x0 + 17].astype(np.int64)
        hh = np.clip((p @ M + r1) >> 5, 0, 255)          # (17, 16)
        if dx == 0:
            X = p[:, :16]
        elif dx == 1:
            X = (hh + p[:, :16] + a2) >> 1
        elif dx == 2:
            X = hh
        else:
            X = (hh + p[:, 1:17] + a2) >> 1
        vx = np.clip((M.T @ X + r1) >> 5, 0, 255)        # (16, 16)
        if dy == 0:
            out[i] = X[:16]
        elif dy == 1:
            out[i] = (X[:16] + vx + a2) >> 1
        elif dy == 2:
            out[i] = vx
        else:
            out[i] = (X[1:17] + vx + a2) >> 1
    return out


def _lowpass(x: torch.Tensor, m: torch.Tensor, r1: int) -> torch.Tensor:
    """clip((x @ m + r1) >> 5, 0, 255) for integer x in [0, 255] and the
    float32 tap matrix m: exact (module docstring)."""
    y = torch.matmul(x.to(torch.float32), m).to(torch.int32)
    return ((y + r1) >> 5).clamp(0, 255)


def _mc_qpel(padded: torch.Tensor, xs, ys, mvx, mvy, n: int,
             no_rnd: int) -> torch.Tensor:
    """n x n quarter-sample blocks (n = 16 or 8): one (n+1, n+1) gather
    per block at the clipped origin, the staged lowpass with the n-wide
    reflection matrix, the phase selected per block."""
    m = torch.as_tensor(_qpel_lowpass_matrix(n), dtype=torch.float32,
                        device=padded.device)
    r1 = 15 if no_rnd else 16
    a2 = 0 if no_rnd else 1
    hp, wp = padded.shape
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    x0 = (xs + (mvx >> 2) + EDGE).clamp(0, wp - n - 1).long()
    y0 = (ys + (mvy >> 2) + EDGE).clamp(0, hp - n - 1).long()
    dx = (mvx & 3)[:, None, None]
    dy = (mvy & 3)[:, None, None]
    r = torch.arange(n + 1, device=padded.device)
    p = padded[(y0[:, None] + r)[:, :, None],
               (x0[:, None] + r)[:, None, :]].to(torch.int32)
    hh = _lowpass(p, m, r1)                              # (B, n+1, n)
    xl = p[:, :, :n]
    xr = p[:, :, 1:]
    X = torch.where(dx == 0, xl,
                    torch.where(dx == 1, (hh + xl + a2) >> 1,
                                torch.where(dx == 2, hh,
                                            (hh + xr + a2) >> 1)))
    vx = _lowpass(X.transpose(1, 2), m, r1).transpose(1, 2)  # (B, n, n)
    xt = X[:, :n]
    xb = X[:, 1:]
    return torch.where(dy == 0, xt,
                       torch.where(dy == 1, (xt + vx + a2) >> 1,
                                   torch.where(dy == 2, vx,
                                               (xb + vx + a2) >> 1)))


def mc_qpel_mpeg4(padded: torch.Tensor, xs, ys, mvx, mvy,
                  no_rnd: int = 0) -> torch.Tensor:
    """Batched 16x16 quarter-sample MC (qpeldsp.c put_qpel16 /
    put_no_rnd_qpel16): padded (H+2E, W+2E), xs, ys, mvx, mvy (B,) ->
    (B, 16, 16) int32."""
    return _mc_qpel(padded, xs, ys, mvx, mvy, 16, no_rnd)


def mc_qpel_mpeg4_8(padded: torch.Tensor, xs, ys, mvx, mvy,
                    no_rnd: int = 0) -> torch.Tensor:
    """8x8-block quarter-sample MC (qpeldsp.c put_qpel8 chain): the same
    staged lowpass with the 8-wide reflection matrix; per-8x8-block
    positions and vectors."""
    return _mc_qpel(padded, xs, ys, mvx, mvy, 8, no_rnd)


def _tiled8(blk: torch.Tensor, n: int) -> torch.Tensor:
    """(4n, 8, 8) blocks in (block 0-3 of each MB) order -> (n, 16, 16)."""
    return (blk.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n, 16, 16))


def _quad(xs, ys, mv4):
    """The four 8x8 blocks of each MB: positions and vectors, flat."""
    offs = torch.tensor([(0, 0), (8, 0), (0, 8), (8, 8)], dtype=torch.int32,
                        device=mv4.device)
    xs4 = (xs[:, None] + offs[None, :, 0]).reshape(-1)
    ys4 = (ys[:, None] + offs[None, :, 1]).reshape(-1)
    return xs4, ys4, mv4[:, :, 0].reshape(-1), mv4[:, :, 1].reshape(-1)


def mc_qpel_mpeg4_tiled8(padded: torch.Tensor, xs, ys, mv4,
                         no_rnd: int = 0) -> torch.Tensor:
    """16x16 prediction built from four 8x8 qpel blocks with per-block
    vectors mv4 (B, 4, 2) — the reference's MV_TYPE_8X8 path
    (mpegvideo_motion.c apply_8x8): MPEG-4 4MV in quarter-sample mode
    and qpel direct mode (mpeg4video.c:176, equal vectors)."""
    return _tiled8(mc_qpel_mpeg4_8(padded, *_quad(xs, ys, mv4), no_rnd),
                   xs.shape[0])


def mc_hpel_tiled8(padded: torch.Tensor, xs, ys, mv4,
                   rnd: int = 1) -> torch.Tensor:
    """16x16 from four 8x8 half-pel blocks with per-block vectors (B, 4,
    2) (reference apply_8x8 non-quarter branch)."""
    return _tiled8(mc_hpel(padded, *_quad(xs, ys, mv4), 8, rnd),
                   xs.shape[0])
