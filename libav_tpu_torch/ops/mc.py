"""Reference-plane padding, patch gathers and half-pel motion
compensation (counterpart of `libav_tpu/ops/mc.py` EDGE, pad_plane,
mc_hpel, avg_pred, chroma_mv_div2 and chroma_mv_h263; reference:
hpeldsp.h put_pixels_tab and mpegvideo_motion.c mpeg_motion).

Every block's source patch is gathered from the edge-padded reference in
one indexing op. The patch origin follows `lax.dynamic_slice`'s start
index rule (a negative start counts from the end of the axis, then the
window is clamped into range), so a motion vector that points further
than EDGE outside the frame reads the same pixels in both packages.
"""

from __future__ import annotations

from typing import Optional

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
