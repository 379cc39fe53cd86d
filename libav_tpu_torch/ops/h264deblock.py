"""H.264 in-loop deblocking (counterpart of `libav_tpu/ops/h264deblock.py`
filter_edge_qp, its Pallas kernel `_filter_edge_qp_pallas`, and
deblock_frame_exact_jit; spec ISO 14496-10 §8.7).

Kernel K1, the edge filter, is `csrc/h264_deblock.cu`, with two entry
points:

- `h264_edge_filter_lines`: K1's own contract, one thread per (B, 8)
  line [p3 p2 p1 p0 q0 q1 q2 q3] with a per-line qp and bS.
- `h264_deblock_wave`: what the frame deblock calls, once per x+2y
  macroblock wave. One block per wave slot keeps its macroblock's luma
  and chroma patches in shared memory and filters every edge of the
  macroblock in spec order, where the JAX package makes 16 filter calls
  per wave, each wrapped in gathers and scatters.

The same source holds kernel P2, `h264_edge_filter_pm`: the luma filter
in the position-major (8, B) layout of the timing tool's Pallas kernel
(`libav_tpu/tools/pallas_probe.py` `_build_deblock`), alpha and beta
both at clip(qp), no offsets.

Each has a plain PyTorch version beside it (`filter_edge_qp`,
`deblock_wave_plain`, `edge_filter_pm_plain`). A wrapper runs the plain
version for a tensor on the CPU, launches the kernel for a tensor on a
CUDA device, and raises for anything else: there is no fallback and no
size threshold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libav_tpu.codecs.h264.device import CHROMA_QP
from libav_tpu.ops.h264deblock import ALPHA, BETA, TC0
from libav_tpu_torch._kernels import (check_int32, library, ptr,
                                      raise_on, stream)

_N_QP = 52


@functools.lru_cache(maxsize=None)
def edge_table(device: torch.device) -> torch.Tensor:
    """Packed int32 [ALPHA (52) | BETA (52) | TC0 (52 x 3)] on device —
    the JAX package's tables, read by the plain filter and the kernel."""
    packed = np.concatenate([ALPHA, BETA, TC0.reshape(-1)]).astype(np.int32)
    return torch.as_tensor(packed).to(device)


@functools.lru_cache(maxsize=None)
def chroma_qp_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(CHROMA_QP).to(device)


# ---------------------------------------------------------------------- #
# K1, line contract
# ---------------------------------------------------------------------- #

def filter_edge_qp(lines: torch.Tensor, qp: torch.Tensor, bs: torch.Tensor,
                   chroma: bool = False, a_off: int = 0,
                   b_off: int = 0) -> torch.Tensor:
    """Plain batched edge filter. lines (B,8), qp (B,), bs (B,) -> (B,8)
    int32. a_off/b_off are the slice's alpha_c0/beta offsets (indexA for
    alpha and tc0, indexB for beta)."""
    tab = edge_table(lines.device)
    x = lines.to(torch.int32)
    p3, p2, p1, p0 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    q0, q1, q2, q3 = x[:, 4], x[:, 5], x[:, 6], x[:, 7]
    qpi = qp.long()
    qp_a = (qpi + a_off).clamp(0, 51)
    qp_b = (qpi + b_off).clamp(0, 51)
    alpha = tab[qp_a]
    beta = tab[_N_QP + qp_b]
    bs = bs.to(torch.int32)

    active = (bs > 0) & ((p0 - q0).abs() < alpha) & \
             ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)

    tc0 = tab[2 * _N_QP + 3 * qp_a + (bs.long() - 1).clamp(0, 2)]
    ap = (p2 - p0).abs()
    aq = (q2 - q0).abs()
    if chroma:
        tc = tc0 + 1
    else:
        tc = tc0 + (ap < beta).to(torch.int32) + (aq < beta).to(torch.int32)
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = (p0 + delta).clamp(0, 255)
    nq0 = (q0 - delta).clamp(0, 255)
    if chroma:
        np1, nq1 = p1, q1
    else:
        dp1 = torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                          -tc0, tc0)
        dq1 = torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                          -tc0, tc0)
        np1 = torch.where(ap < beta, p1 + dp1, p1)
        nq1 = torch.where(aq < beta, q1 + dq1, q1)

    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = strong & (ap < beta) & (not chroma)
    sq = strong & (aq < beta) & (not chroma)
    sp0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    op2 = torch.where(active & is4, sp2, p2)
    op1 = torch.where(active, torch.where(is4, sp1, np1), p1)
    op0 = torch.where(active, torch.where(is4, sp0, np0), p0)
    oq0 = torch.where(active, torch.where(is4, sq0, nq0), q0)
    oq1 = torch.where(active, torch.where(is4, sq1, nq1), q1)
    oq2 = torch.where(active & is4, sq2, q2)
    return torch.stack([p3, op2, op1, op0, oq0, oq1, oq2, q3], dim=1)


def h264_edge_filter_lines(lines: torch.Tensor, qp: torch.Tensor,
                           bs: torch.Tensor, chroma: bool = False,
                           a_off: int = 0, b_off: int = 0) -> torch.Tensor:
    """K1 on (B, 8) int32 lines with per-line qp and bS (int32).
    CPU tensors take `filter_edge_qp`; CUDA tensors launch the kernel."""
    if lines.device.type == "cpu":
        return filter_edge_qp(lines, qp, bs, chroma, a_off, b_off)
    if lines.device.type != "cuda":
        raise ValueError(f"h264_edge_filter_lines: no kernel for "
                         f"{lines.device}")
    dev = lines.device
    n = lines.shape[0]
    check_int32("lines", lines, dev, (n, 8))
    check_int32("qp", qp, dev, (n,))
    check_int32("bs", bs, dev, (n,))
    out = torch.empty_like(lines)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        err = lib.h264_edge_filter_lines(
            ptr(lines), ptr(out), ptr(qp), ptr(bs), n, a_off, b_off,
            int(chroma), ptr(edge_table(dev)), stream(dev))
    raise_on(err, "h264_edge_filter_lines")
    h264_edge_filter_lines.launches += 1
    return out


h264_edge_filter_lines.launches = 0


# ---------------------------------------------------------------------- #
# P2, position-major line contract
# ---------------------------------------------------------------------- #

def edge_filter_pm_plain(xT: torch.Tensor, qp: torch.Tensor,
                         bs: torch.Tensor) -> torch.Tensor:
    """(8, B) position-major lines -> (8, B) int32: filter_edge_qp (luma,
    no offsets) on the transpose."""
    return filter_edge_qp(xT.T, qp, bs).T.contiguous()


def h264_edge_filter_pm(xT: torch.Tensor, qp: torch.Tensor,
                        bs: torch.Tensor) -> torch.Tensor:
    """P2 on (8, B) int32, row k = pixel slot p3..q3 of every line, with
    per-line qp and bS (int32). CPU tensors take `edge_filter_pm_plain`;
    CUDA tensors launch the kernel."""
    if xT.device.type == "cpu":
        return edge_filter_pm_plain(xT, qp, bs)
    if xT.device.type != "cuda":
        raise ValueError(f"h264_edge_filter_pm: no kernel for {xT.device}")
    dev = xT.device
    n = xT.shape[1]
    check_int32("xT", xT, dev, (8, n))
    check_int32("qp", qp, dev, (n,))
    check_int32("bs", bs, dev, (n,))
    out = torch.empty_like(xT)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = library().h264_edge_filter_pm(
            ptr(xT), ptr(out), ptr(qp), ptr(bs), n, ptr(edge_table(dev)),
            stream(dev))
    raise_on(err, "h264_edge_filter_pm")
    h264_edge_filter_pm.launches += 1
    return out


h264_edge_filter_pm.launches = 0


# ---------------------------------------------------------------------- #
# Exact frame deblocking over x+2y macroblock waves (reference:
# h264_loopfilter.c ff_h264_filter_mb per MB in decode order). MB (x, y)
# depends on (x-1, y), (x, y-1) and (x+1, y-1), so the MBs of one wave
# x + 2y = w have column-disjoint read/write patches and filter together.
# ---------------------------------------------------------------------- #

# The wave step works on planes padded by 4 on the top and left, and on
# one (8, 4mb_h, 4mb_w) int32 tensor of per-4x4-block grids, in this
# order: bS and qp of the vertical / horizontal edges, then the U and V
# chroma qps of the same: bs_v, bs_h, qp_v, qp_h, qpu_v, qpu_h, qpv_v,
# qpv_h.


def n_waves(mb_w: int, mb_h: int) -> int:
    return mb_w + 2 * (mb_h - 1)


def wave_slots(mb_w: int, mb_h: int) -> int:
    """Most macroblocks any wave holds (the kernel's grid size)."""
    return min(mb_h, (mb_w + 1) // 2 + 1)


def build_bs(intra4, nnz4, m0, p0, m1, p1, field: bool = False):
    """(bs_v, bs_h) per 4x4 block, spec 8.7.2.1. bS=1 unless the two
    sides use the same reference pictures with all matched-list MV deltas
    under the limit, matched straight (L0/L0 + L1/L1) or swapped."""
    bh, bw = intra4.shape
    dev = intra4.device
    lim = torch.tensor([4, 2 if field else 4], dtype=torch.int32,
                       device=dev)

    def small(a, b):
        return ((a - b).abs() < lim).all(-1)

    def bs_dir(axis):
        ip = torch.roll(intra4, 1, axis)
        np_ = torch.roll(nnz4, 1, axis)
        m0r = torch.roll(m0, 1, axis)
        m1r = torch.roll(m1, 1, axis)
        p0r = torch.roll(p0, 1, axis)
        p1r = torch.roll(p1, 1, axis)
        idx = (torch.arange(bw, device=dev)[None, :] if axis == 1
               else torch.arange(bh, device=dev)[:, None])
        mbedge = (idx % 4) == 0
        either_intra = intra4 | ip
        coded = (nnz4 > 0) | (np_ > 0)
        straight = (p0 == p0r) & (p1 == p1r) & small(m0, m0r) & \
            small(m1, m1r)
        cross = (p0 == p1r) & (p1 == p0r) & small(m0, m1r) & small(m1, m0r)
        # field pictures never strong-filter horizontal MB edges
        strong = 3 if (field and axis == 0) else 4
        bs = torch.where(either_intra,
                         torch.where(mbedge, strong, 3),
                         torch.where(coded, 2,
                                     torch.where(straight | cross, 0, 1)))
        return torch.where(idx == 0, 0, bs)
    return bs_dir(1), bs_dir(0)


def deblock_wave_plain(ypad, upad, vpad, grids, wave: int, mb_w: int,
                       mb_h: int, a_off: int, b_off: int) -> None:
    """Plain version of one wave, in place on the padded int32 planes:
    gather each slot's 20x20 luma and 12x12 chroma patches, filter the
    4 vertical then 4 horizontal luma edges and the 2 + 2 chroma edges
    per plane, scatter back. Only the wave's real macroblocks are
    touched."""
    ylo = max(0, (wave - mb_w + 2) // 2)
    yhi = min(mb_h - 1, wave // 2)
    if yhi < ylo:
        return
    dev = ypad.device
    y = torch.arange(ylo, yhi + 1, device=dev)
    x = wave - 2 * y
    bs_v, bs_h, qp_v, qp_h, qpu_v, qpu_h, qpv_v, qpv_h = grids
    by0, bx0 = y * 4, x * 4
    a4 = torch.arange(4, device=dev)
    r20 = torch.arange(20, device=dev)
    r12 = torch.arange(12, device=dev)
    half8 = torch.arange(8, device=dev) // 2

    rows = (y * 16)[:, None, None] + r20[None, :, None]
    cols = (x * 16)[:, None, None] + r20[None, None, :]
    P = ypad[rows, cols]
    for k in range(4):
        c = 4 + 4 * k
        lines = P[:, 4:20, c - 4:c + 4].reshape(-1, 8)
        gr, gc = by0[:, None] + a4, (bx0 + k)[:, None]
        bs = bs_v[gr, gc].repeat_interleave(4, 1).reshape(-1)
        qq = qp_v[gr, gc].repeat_interleave(4, 1).reshape(-1)
        out = filter_edge_qp(lines, qq, bs, False, a_off, b_off)
        P[:, 4:20, c - 4:c + 4] = out.reshape(-1, 16, 8)
    for k in range(4):
        r = 4 + 4 * k
        lines = P[:, r - 4:r + 4, 4:20].transpose(1, 2).reshape(-1, 8)
        gr, gc = (by0 + k)[:, None], bx0[:, None] + a4
        bs = bs_h[gr, gc].repeat_interleave(4, 1).reshape(-1)
        qq = qp_h[gr, gc].repeat_interleave(4, 1).reshape(-1)
        out = filter_edge_qp(lines, qq, bs, False, a_off, b_off)
        P[:, r - 4:r + 4, 4:20] = out.reshape(-1, 16, 8).transpose(1, 2)
    ypad[rows, cols] = P

    rows = (y * 8)[:, None, None] + r12[None, :, None]
    cols = (x * 8)[:, None, None] + r12[None, None, :]
    for cpad, qv, qh in ((upad, qpu_v, qpu_h), (vpad, qpv_v, qpv_h)):
        C = cpad[rows, cols]
        for k in range(2):              # V edges at chroma x 0 and 4
            c = 4 + 4 * k
            lines = C[:, 4:12, c - 4:c + 4].reshape(-1, 8)
            gr, gc = by0[:, None] + half8, (bx0 + 2 * k)[:, None]
            out = filter_edge_qp(lines, qv[gr, gc].reshape(-1),
                                 bs_v[gr, gc].reshape(-1), True,
                                 a_off, b_off)
            C[:, 4:12, c - 4:c + 4] = out.reshape(-1, 8, 8)
        for k in range(2):              # H edges at chroma y 0 and 4
            r = 4 + 4 * k
            lines = C[:, r - 4:r + 4, 4:12].transpose(1, 2).reshape(-1, 8)
            gr, gc = (by0 + 2 * k)[:, None], bx0[:, None] + half8
            out = filter_edge_qp(lines, qh[gr, gc].reshape(-1),
                                 bs_h[gr, gc].reshape(-1), True,
                                 a_off, b_off)
            C[:, r - 4:r + 4, 4:12] = out.reshape(-1, 8, 8).transpose(1, 2)
        cpad[rows, cols] = C


def h264_deblock_wave(ypad, upad, vpad, grids, wave: int, mb_w: int,
                      mb_h: int, a_off: int, b_off: int) -> None:
    """One x+2y wave of the frame deblock, in place. ypad (16mb_h+4,
    16mb_w+4), upad/vpad (8mb_h+4, 8mb_w+4) and grids (8, 4mb_h, 4mb_w)
    are int32. CPU tensors take `deblock_wave_plain`; CUDA tensors launch
    the kernel."""
    if ypad.device.type == "cpu":
        return deblock_wave_plain(ypad, upad, vpad, grids, wave, mb_w,
                                  mb_h, a_off, b_off)
    if ypad.device.type != "cuda":
        raise ValueError(f"h264_deblock_wave: no kernel for {ypad.device}")
    dev = ypad.device
    check_int32("ypad", ypad, dev, (16 * mb_h + 4, 16 * mb_w + 4))
    check_int32("upad", upad, dev, (8 * mb_h + 4, 8 * mb_w + 4))
    check_int32("vpad", vpad, dev, (8 * mb_h + 4, 8 * mb_w + 4))
    check_int32("grids", grids, dev, (8, 4 * mb_h, 4 * mb_w))
    if not 0 <= wave < n_waves(mb_w, mb_h):
        raise ValueError(f"wave {wave} out of range")
    lib = library()
    with torch.cuda.device(dev):
        err = lib.h264_deblock_wave(
            ptr(ypad), ptr(upad), ptr(vpad), ptr(grids), mb_w, mb_h,
            wave, wave_slots(mb_w, mb_h), a_off, b_off,
            ptr(edge_table(dev)), stream(dev))
    raise_on(err, "h264_deblock_wave")
    h264_deblock_wave.launches += 1


h264_deblock_wave.launches = 0


@functools.lru_cache(maxsize=32)
def deblock_frame_exact(mb_w: int, mb_h: int, a_off: int = 0,
                        b_off: int = 0, part: bool = False, cqpo=(0, 0),
                        any_t8: bool = False, field: bool = False):
    """Same key and contract as the JAX package's deblock_frame_exact_jit:
    fn(yp, up, vp, intra_mb, qp_mb, nnz4, mv_mb[, pid0, mv4_1, pid1],
    t8=None, step=h264_deblock_wave) -> (yp, up, vp) int32, all tensors
    on one device. With part=True the motion inputs are the two lists'
    (4mb_h, 4mb_w, 2) MV grids and per-block picture ids (-1 = list
    unused). `step` runs one wave; pass `deblock_wave_plain` to hold the
    kernel against its plain version on the card."""
    bw, bh = 4 * mb_w, 4 * mb_h

    def grid4(a):
        return a.reshape(mb_h, mb_w, *a.shape[1:]) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)

    def fn(yp, up, vp, intra_mb, qp_mb, nnz4, mv_mb, pid0=None,
           mv4_1=None, pid1=None, t8=None, step=h264_deblock_wave):
        dev = yp.device
        intra4 = grid4(intra_mb.bool())
        qp4 = grid4(qp_mb.to(torch.int32).clamp(0, 51))
        if part:
            m0 = mv_mb.to(torch.int32)
            p0 = pid0.to(torch.int32)
            m1 = mv4_1.to(torch.int32)
            p1 = pid1.to(torch.int32)
        else:
            m0 = grid4(mv_mb.to(torch.int32))
            p0 = torch.zeros((bh, bw), dtype=torch.int32, device=dev)
            m1 = torch.zeros((bh, bw, 2), dtype=torch.int32, device=dev)
            p1 = torch.full((bh, bw), -1, dtype=torch.int32, device=dev)
        bs_v, bs_h = build_bs(intra4, nnz4.to(torch.int32), m0, p0, m1, p1,
                              field)
        if any_t8:
            # 8x8-transform MBs skip their 4x4-internal luma edges
            t84 = grid4(t8.bool())
            odd_col = torch.arange(bw, device=dev) % 2 == 1
            odd_row = torch.arange(bh, device=dev) % 2 == 1
            bs_v = torch.where(t84 & odd_col[None, :], 0, bs_v)
            bs_h = torch.where(t84 & odd_row[:, None], 0, bs_h)
        cqp = chroma_qp_table(dev)
        qp4u = cqp[(qp4 + cqpo[0]).clamp(0, 51).long()]
        qp4v = cqp[(qp4 + cqpo[1]).clamp(0, 51).long()]

        def avg(g, axis):
            return (g + torch.roll(g, 1, axis) + 1) >> 1
        grids = torch.stack([bs_v, bs_h, avg(qp4, 1), avg(qp4, 0),
                             avg(qp4u, 1), avg(qp4u, 0), avg(qp4v, 1),
                             avg(qp4v, 0)]).to(torch.int32).contiguous()

        def pad4(p):
            out = torch.zeros((p.shape[0] + 4, p.shape[1] + 4),
                              dtype=torch.int32, device=dev)
            out[4:, 4:] = p
            return out
        ypad, upad, vpad = pad4(yp), pad4(up), pad4(vp)
        for w in range(n_waves(mb_w, mb_h)):
            step(ypad, upad, vpad, grids, w, mb_w, mb_h, a_off, b_off)
        return ypad[4:, 4:], upad[4:, 4:], vpad[4:, 4:]

    return fn
