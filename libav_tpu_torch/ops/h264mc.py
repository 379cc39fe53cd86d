"""H.264 quarter-pel luma and eighth-pel chroma motion compensation
(counterpart of `libav_tpu/ops/h264mc.py` qpel_mc and chroma_mc; spec
ISO 14496-10 §8.4.2.2).

One gather of each block's source patch from the edge-padded reference,
then all sixteen quarter-pel phases computed and selected per block, as
in the JAX package. The patch origin follows `lax.dynamic_slice`'s start
index rule (`ops/mc.py` gather_patches).
"""

from __future__ import annotations

from typing import Optional

import torch

from libav_tpu_torch.ops.mc import EDGE, gather_patches

_W6 = (1, -5, 20, 20, -5, 1)


def _conv6(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    out = 0
    for t, w in enumerate(_W6):
        out = out + w * x.narrow(dim, t, n - 5)
    return out


def _avg(a, b):
    return (a + b + 1) >> 1


def qpel_mc(padded: torch.Tensor, xs, ys, mvx, mvy, size: int,
            ridx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched quarter-pel MC. padded (Hp, Wp) uint8, or an (R, Hp, Wp)
    stack with ridx (B,) picking each block's reference; xs/ys block
    origins in unpadded pixels, mv in quarter-pel. -> (B, size, size)
    int32."""
    S = size
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    x0 = xs + (mvx >> 2) + EDGE - 2
    y0 = ys + (mvy >> 2) + EDGE - 2
    fx = (mvx & 3)[:, None, None]
    fy = (mvy & 3)[:, None, None]
    P = gather_patches(padded, y0, x0, S + 6, ridx)

    G = P[:, 2:S + 3, 2:S + 3]
    b1 = _conv6(P, 2)                            # (B, S+6, S+1)
    b = ((b1[:, 2:S + 3] + 16) >> 5).clamp(0, 255)
    h1 = _conv6(P, 1)                            # (B, S+1, S+6)
    h = ((h1[:, :, 2:S + 3] + 16) >> 5).clamp(0, 255)
    j1 = _conv6(b1, 1)                           # (B, S+1, S+1)
    j = ((j1 + 512) >> 10).clamp(0, 255)

    g0 = G[:, :S, :S]
    gx = G[:, :S, 1:S + 1]
    gy = G[:, 1:S + 1, :S]
    b0 = b[:, :S, :S]
    by = b[:, 1:S + 1, :S]
    h0 = h[:, :S, :S]
    hx = h[:, :S, 1:S + 1]
    j0 = j[:, :S, :S]

    # rows: fy, cols: fx (the JAX package's decision table)
    tbl = [
        [g0, _avg(g0, b0), b0, _avg(b0, gx)],
        [_avg(g0, h0), _avg(b0, h0), _avg(b0, j0), _avg(b0, hx)],
        [h0, _avg(h0, j0), j0, _avg(j0, hx)],
        [_avg(h0, gy), _avg(by, h0), _avg(j0, by), _avg(by, hx)],
    ]
    rows = []
    for r in range(4):
        v = tbl[r][3]
        for c in (2, 1, 0):
            v = torch.where(fx == c, tbl[r][c], v)
        rows.append(v)
    out = rows[3]
    for r in (2, 1, 0):
        out = torch.where(fy == r, rows[r], out)
    return out.clamp(0, 255)


def chroma_mc(padded: torch.Tensor, xs, ys, mvx, mvy, size: int,
              ridx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched eighth-pel bilinear chroma MC (spec 8.4.2.2.2); same
    contract as qpel_mc with mv in eighth-pel units."""
    S = size
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    x0 = xs + (mvx >> 3) + EDGE
    y0 = ys + (mvy >> 3) + EDGE
    dx = (mvx & 7)[:, None, None]
    dy = (mvy & 7)[:, None, None]
    P = gather_patches(padded, y0, x0, S + 1, ridx)
    A = P[:, :S, :S]
    B_ = P[:, :S, 1:S + 1]
    C = P[:, 1:S + 1, :S]
    D = P[:, 1:S + 1, 1:S + 1]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B_ +
            (8 - dx) * dy * C + dx * dy * D + 32) >> 6
