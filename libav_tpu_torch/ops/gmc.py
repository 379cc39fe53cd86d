"""MPEG-4 global motion compensation: the warp of the reference planes
and the sprite parameters (counterpart of `libav_tpu/ops/gmc.py`;
reference: libavcodec/mpegvideodsp.c ff_gmc_c + gmc1_c, driven per
macroblock by mpegvideo_motion.c gmc_motion / gmc1_motion).

The per-MB affine parameters are linear in the position, so the whole
frame's GMC prediction is one warp of each reference plane, an integer
gather and bilinear blend as one torch program per plane on the planes'
device. Macroblocks that select GMC (mcsel) then read their block from
the warped planes at zero motion. Both reference kernels are reproduced:
gmc1 (translation only, 4-bit phase bilinear, per-MB source clamping;
one warping point) and the general per-pixel affine gmc with its
asymmetric edge handling.

The arithmetic is the JAX program's, in int32 on the device: the warp
coordinates `ox0 + dxx * x + dxy * y` may wrap, and torch's int32 wraps
as XLA's does; right shifts of negatives are arithmetic in both. The JAX
program's out-of-range gather indices clamp into the plane, which
`_gmc1_plane` writes out. The one-point path builds its per-MB source
corners in Python loops on the host (`warp_refs`), as the JAX package
does, and uploads them once per VOP. GMCParams, compute_warp_params and
get_amv are host code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from libav_tpu_torch.ops.mc import EDGE


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _gmc_affine_plane(ref: torch.Tensor, ox0: int, oy0: int, dxx: int,
                      dxy: int, dyx: int, dyy: int, h_edge: int,
                      v_edge: int, shift: int, r: int) -> torch.Tensor:
    """ff_gmc_c over the whole (padded) plane; ref is EDGE-padded,
    output interior (h_edge x v_edge) is written, padding copied."""
    dev = ref.device
    width = h_edge - 1                     # ff_gmc_c width--
    height = v_edge - 1
    s = 1 << shift
    ys = torch.arange(v_edge, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(h_edge, dtype=torch.int32, device=dev)[None, :]
    vx = _i32(ox0, dev) + _i32(dxx, dev) * xs + _i32(dxy, dev) * ys
    vy = _i32(oy0, dev) + _i32(dyx, dev) * xs + _i32(dyy, dev) * ys
    src_x16 = vx >> 16
    src_y16 = vy >> 16
    frac_x = src_x16 & (s - 1)
    frac_y = src_y16 & (s - 1)
    sx = src_x16 >> shift
    sy = src_y16 >> shift
    in_x = (sx >= 0) & (sx < width)
    in_y = (sy >= 0) & (sy < height)
    cx = sx.clamp(0, width).long()
    cy = sy.clamp(0, height).long()
    cx1 = (sx + 1).clamp(0, width).long()  # only used when in_x
    cy1 = (sy + 1).clamp(0, height).long()
    core = ref[EDGE:EDGE + v_edge + 1, EDGE:EDGE + h_edge + 1]
    p00 = core[cy, cx].to(torch.int32)
    p01 = core[cy, cx1].to(torch.int32)
    p10 = core[cy1, cx].to(torch.int32)
    p11 = core[cy1, cx1].to(torch.int32)
    both = ((p00 * (s - frac_x) + p01 * frac_x) * (s - frac_y) +
            (p10 * (s - frac_x) + p11 * frac_x) * frac_y + r) >> (2 * shift)
    xonly = ((p00 * (s - frac_x) + p01 * frac_x) * s + r) >> (2 * shift)
    yonly = ((p00 * (s - frac_y) + p10 * frac_y) * s + r) >> (2 * shift)
    out = torch.where(in_x & in_y, both,
                      torch.where(in_x, xonly, torch.where(in_y, yonly, p00)))
    res = ref.clone()
    res[EDGE:EDGE + v_edge, EDGE:EDGE + h_edge] = out.to(torch.uint8)
    return res


def _gmc1_plane(ref: torch.Tensor, src_pos: torch.Tensor,
                motion: torch.Tensor, mb16: bool,
                rounder: int) -> torch.Tensor:
    """gmc1_c per MB over the whole plane: src_pos (nmb_y, nmb_x, 2)
    precomputed clamped source corners (plane coords, may be negative),
    motion (nmb_y, nmb_x, 2) per-MB effective phases in 1/16 units
    (zeroed at the clamp boundary like gmc1_motion)."""
    B = 16 if mb16 else 8
    dev = ref.device
    nby, nbx = src_pos.shape[0], src_pos.shape[1]
    x16 = motion[..., 0] & 15
    y16 = motion[..., 1] & 15
    A = (16 - x16) * (16 - y16)
    Bc = x16 * (16 - y16)
    C = (16 - x16) * y16
    D = x16 * y16
    # (B+1)x(B+1) windows at src_pos; the JAX gather clamps an index past
    # the padded plane (a window at the right or bottom clamp reaches one
    # column or row beyond it, with weight 0) to the last one
    k = torch.arange(B + 1, device=dev)
    oy = (src_pos[..., 1][:, :, None, None].long() + k[None, None, :, None]
          + EDGE).clamp(0, ref.shape[0] - 1)
    ox = (src_pos[..., 0][:, :, None, None].long() + k[None, None, None, :]
          + EDGE).clamp(0, ref.shape[1] - 1)
    win = ref[oy, ox].to(torch.int32)      # (nby, nbx, B+1, B+1)
    a = win[:, :, :B, :B]
    b = win[:, :, :B, 1:]
    c = win[:, :, 1:, :B]
    d = win[:, :, 1:, 1:]
    blk = (A[..., None, None] * a + Bc[..., None, None] * b +
           C[..., None, None] * c + D[..., None, None] * d +
           rounder) >> 8
    # hpel fallback when phases are multiples of 8 (put_pixels dxy)
    full = torch.where(((x16 | y16) & 7)[..., None, None] == 0,
                       _hpel_put(win, x16, y16, B, rounder), blk)
    out = full.permute(0, 2, 1, 3).reshape(nby * B, nbx * B)
    res = ref.clone()
    res[EDGE:EDGE + nby * B, EDGE:EDGE + nbx * B] = out.to(torch.uint8)
    return res


def _hpel_put(win, x16, y16, B, rounder):
    """put_pixels_tab[dxy] (dxy = ((x>>3)&1) | ((y>>2)&2)) with
    avg rounding when rounder==128 and no-rnd when 127
    (gmc1_motion fallback for 8-multiple phases)."""
    a = win[:, :, :B, :B]
    b = win[:, :, :B, 1:]
    c = win[:, :, 1:, :B]
    d = win[:, :, 1:, 1:]
    rnd = 1 if rounder == 128 else 0
    hx = ((x16 >> 3) & 1)[..., None, None]
    hy = ((y16 >> 3) & 1)[..., None, None]
    h = (a + b + rnd) >> 1
    v = (a + c + rnd) >> 1
    hv = ((a + b + c + d + 2 * rnd) >> 2) if rounder == 128 else \
        ((a + b + c + d + 1) >> 2)
    return torch.where((hx & hy) == 1, hv,
                       torch.where(hx == 1, h, torch.where(hy == 1, v, a)))


class GMCParams:
    """Per-VOP warp state (mpeg4videodec.c mpeg4_decode_sprite_trajectory
    output): sprite_offset[2][2], sprite_delta[2][2], sprite_shift[2],
    real_points, accuracy."""

    def __init__(self, offset, delta, shift, real_points, accuracy,
                 no_rounding):
        self.offset = offset
        self.delta = delta
        self.shift = shift
        self.real_points = real_points
        self.accuracy = accuracy
        self.no_rounding = no_rounding


def compute_warp_params(traj, num_points, accuracy, w, h):
    """Integer warp derivation (mpeg4videodec.c :168-391, non-divx
    path). traj: list of (x, y) dmv ints."""
    a = 2 << accuracy
    rho = 3 - accuracy
    r = 16 // a
    d = [[0, 0] for _ in range(4)]
    for i in range(num_points):
        d[i][0], d[i][1] = traj[i]
    vop_ref = [[0, 0], [w, 0], [0, h], [w, h]]
    alpha = 0
    while (1 << alpha) < w:
        alpha += 1
    beta = 0
    while (1 << beta) < h:
        beta += 1
    w2, h2 = 1 << alpha, 1 << beta
    sr = [[0, 0] for _ in range(3)]
    for i in range(3):
        dx = d[0][0] + (d[1][0] if i == 1 else 0) + \
            (d[2][0] if i == 2 else 0)
        dy = d[0][1] + (d[1][1] if i == 1 else 0) + \
            (d[2][1] if i == 2 else 0)
        sr[i][0] = (a >> 1) * (2 * vop_ref[i][0] + dx)
        sr[i][1] = (a >> 1) * (2 * vop_ref[i][1] + dy)

    def rdiv(n, dd):
        return (n + (dd >> 1)) // dd if n >= 0 else -((-n + (dd >> 1)) // dd)

    vr = [[0, 0], [0, 0]]
    vr[0][0] = 16 * (vop_ref[0][0] + w2) + rdiv(
        (w - w2) * (r * sr[0][0] - 16 * vop_ref[0][0]) +
        w2 * (r * sr[1][0] - 16 * vop_ref[1][0]), w)
    vr[0][1] = 16 * vop_ref[0][1] + rdiv(
        (w - w2) * (r * sr[0][1] - 16 * vop_ref[0][1]) +
        w2 * (r * sr[1][1] - 16 * vop_ref[1][1]), w)
    vr[1][0] = 16 * vop_ref[0][0] + rdiv(
        (h - h2) * (r * sr[0][0] - 16 * vop_ref[0][0]) +
        h2 * (r * sr[2][0] - 16 * vop_ref[2][0]), h)
    vr[1][1] = 16 * (vop_ref[0][1] + h2) + rdiv(
        (h - h2) * (r * sr[0][1] - 16 * vop_ref[0][1]) +
        h2 * (r * sr[2][1] - 16 * vop_ref[2][1]), h)

    offset = [[0, 0], [0, 0]]
    delta = [[a, 0], [0, a]]
    shift = [0, 0]
    if num_points == 0:
        pass
    elif num_points == 1:
        offset[0][0] = sr[0][0] - a * vop_ref[0][0]
        offset[0][1] = sr[0][1] - a * vop_ref[0][1]
        offset[1][0] = ((sr[0][0] >> 1) | (sr[0][0] & 1)) - \
            a * (vop_ref[0][0] // 2)
        offset[1][1] = ((sr[0][1] >> 1) | (sr[0][1] & 1)) - \
            a * (vop_ref[0][1] // 2)
    elif num_points == 2:
        offset[0][0] = (sr[0][0] << (alpha + rho)) + \
            (-r * sr[0][0] + vr[0][0]) * (-vop_ref[0][0]) + \
            (r * sr[0][1] - vr[0][1]) * (-vop_ref[0][1]) + \
            (1 << (alpha + rho - 1))
        offset[0][1] = (sr[0][1] << (alpha + rho)) + \
            (-r * sr[0][1] + vr[0][1]) * (-vop_ref[0][0]) + \
            (-r * sr[0][0] + vr[0][0]) * (-vop_ref[0][1]) + \
            (1 << (alpha + rho - 1))
        offset[1][0] = ((-r * sr[0][0] + vr[0][0]) *
                        (-2 * vop_ref[0][0] + 1) +
                        (r * sr[0][1] - vr[0][1]) *
                        (-2 * vop_ref[0][1] + 1) +
                        2 * w2 * r * sr[0][0] - 16 * w2 +
                        (1 << (alpha + rho + 1)))
        offset[1][1] = ((-r * sr[0][1] + vr[0][1]) *
                        (-2 * vop_ref[0][0] + 1) +
                        (-r * sr[0][0] + vr[0][0]) *
                        (-2 * vop_ref[0][1] + 1) +
                        2 * w2 * r * sr[0][1] - 16 * w2 +
                        (1 << (alpha + rho + 1)))
        delta = [[-r * sr[0][0] + vr[0][0], r * sr[0][1] - vr[0][1]],
                 [-r * sr[0][1] + vr[0][1], -r * sr[0][0] + vr[0][0]]]
        shift = [alpha + rho, alpha + rho + 2]
    else:
        min_ab = min(alpha, beta)
        w3 = w2 >> min_ab
        h3 = h2 >> min_ab
        offset[0][0] = (sr[0][0] << (alpha + beta + rho - min_ab)) + \
            (-r * sr[0][0] + vr[0][0]) * h3 * (-vop_ref[0][0]) + \
            (-r * sr[0][0] + vr[1][0]) * w3 * (-vop_ref[0][1]) + \
            (1 << (alpha + beta + rho - min_ab - 1))
        offset[0][1] = (sr[0][1] << (alpha + beta + rho - min_ab)) + \
            (-r * sr[0][1] + vr[0][1]) * h3 * (-vop_ref[0][0]) + \
            (-r * sr[0][1] + vr[1][1]) * w3 * (-vop_ref[0][1]) + \
            (1 << (alpha + beta + rho - min_ab - 1))
        offset[1][0] = (-r * sr[0][0] + vr[0][0]) * h3 * \
            (-2 * vop_ref[0][0] + 1) + \
            (-r * sr[0][0] + vr[1][0]) * w3 * (-2 * vop_ref[0][1] + 1) + \
            2 * w2 * h3 * r * sr[0][0] - 16 * w2 * h3 + \
            (1 << (alpha + beta + rho - min_ab + 1))
        offset[1][1] = (-r * sr[0][1] + vr[0][1]) * h3 * \
            (-2 * vop_ref[0][0] + 1) + \
            (-r * sr[0][1] + vr[1][1]) * w3 * (-2 * vop_ref[0][1] + 1) + \
            2 * w2 * h3 * r * sr[0][1] - 16 * w2 * h3 + \
            (1 << (alpha + beta + rho - min_ab + 1))
        delta = [[(-r * sr[0][0] + vr[0][0]) * h3,
                  (-r * sr[0][0] + vr[1][0]) * w3],
                 [(-r * sr[0][1] + vr[0][1]) * h3,
                  (-r * sr[0][1] + vr[1][1]) * w3]]
        shift = [alpha + beta + rho - min_ab,
                 alpha + beta + rho - min_ab + 2]

    if (delta[0][0] == (a << shift[0]) and delta[0][1] == 0 and
            delta[1][0] == 0 and delta[1][1] == (a << shift[0])):
        offset[0][0] >>= shift[0]
        offset[0][1] >>= shift[0]
        offset[1][0] >>= shift[1]
        offset[1][1] >>= shift[1]
        delta = [[a, 0], [0, a]]
        shift = [0, 0]
        real_points = 1
    else:
        shift_y = 16 - shift[0]
        shift_c = 16 - shift[1]
        for i in range(2):
            offset[0][i] <<= shift_y
            offset[1][i] <<= shift_c
            delta[0][i] <<= shift_y
            delta[1][i] <<= shift_y
        shift = [16, 16]
        real_points = num_points
    return offset, delta, shift, real_points


def warp_refs(refs, params: GMCParams, mb_w: int, mb_h: int):
    """Produce GMC-predicted padded planes from the padded reference
    planes (the whole-frame equivalent of per-MB gmc_motion /
    gmc1_motion), on the references' device."""
    a = params.accuracy
    W, H = mb_w * 16, mb_h * 16
    if params.real_points == 1:
        def grids(pi, B, w_, h_):
            mx, my = params.offset[pi]
            sp = np.zeros((mb_h, mb_w, 2), dtype=np.int32)
            mo = np.zeros((mb_h, mb_w, 2), dtype=np.int32)
            mxs = mx << (3 - a)
            mys = my << (3 - a)
            for by in range(mb_h):
                for bx in range(mb_w):
                    sx = bx * B + (mx >> (a + 1))
                    sy = by * B + (my >> (a + 1))
                    emx, emy = mxs, mys
                    sx = max(-B, min(sx, w_))
                    if sx == w_:
                        emx = 0
                    sy = max(-B, min(sy, h_))
                    if sy == h_:
                        emy = 0
                    sp[by, bx] = (sx, sy)
                    mo[by, bx] = (emx, emy)
            dev = refs[0].device
            return torch.as_tensor(sp, device=dev), \
                torch.as_tensor(mo, device=dev)

        rounder = 128 - params.no_rounding
        spy, moy = grids(0, 16, W, H)
        spc, moc = grids(1, 8, W // 2, H // 2)
        return (_gmc1_plane(refs[0], spy, moy, True, rounder),
                _gmc1_plane(refs[1], spc, moc, False, rounder),
                _gmc1_plane(refs[2], spc, moc, False, rounder))
    # general affine
    rr = (1 << (2 * a + 1)) - params.no_rounding
    yplane = _gmc_affine_plane(
        refs[0], params.offset[0][0], params.offset[0][1],
        params.delta[0][0], params.delta[0][1],
        params.delta[1][0], params.delta[1][1],
        W, H, a + 1, rr)
    uplane = _gmc_affine_plane(
        refs[1], params.offset[1][0], params.offset[1][1],
        params.delta[0][0], params.delta[0][1],
        params.delta[1][0], params.delta[1][1],
        W // 2, H // 2, a + 1, rr)
    vplane = _gmc_affine_plane(
        refs[2], params.offset[1][0], params.offset[1][1],
        params.delta[0][0], params.delta[0][1],
        params.delta[1][0], params.delta[1][1],
        W // 2, H // 2, a + 1, rr)
    return yplane, uplane, vplane


def get_amv(params: GMCParams, quarter_sample: int, f_code: int,
            mb_x: int, mb_y: int, n: int) -> int:
    """mpeg4videodec.c get_amv — average GMC vector for MV prediction
    and B-direct colocated motion."""
    a = params.accuracy
    length = 1 << (f_code + 4)

    def rshift(v, b):
        # libavutil/common.h RSHIFT: asymmetric rounding, and v <= 0
        # shifts (v + half - 1) >> b (v - 1 at b == 0)
        half = (1 << b) >> 1
        return (v + half) >> b if v > 0 else (v + half - 1) >> b

    if params.real_points == 1:
        s = rshift(params.offset[0][n] << quarter_sample, a)
    else:
        dx = params.delta[n][0]
        dy = params.delta[n][1]
        shift = params.shift[0]
        if n:
            dy -= 1 << (shift + a + 1)
        else:
            dx -= 1 << (shift + a + 1)
        mb_v = params.offset[0][n] + dx * mb_x * 16 + dy * mb_y * 16
        xs = np.arange(16, dtype=np.int64)
        v = mb_v + np.arange(16, dtype=np.int64)[:, None] * dy + \
            xs[None, :] * dx
        total = int(np.sum(v >> shift))
        s = rshift(total, a + 8 - quarter_sample)
    return max(-length, min(s, length - 1))
