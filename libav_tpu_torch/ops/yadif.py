"""yadif deinterlace program (reference: libavfilter/vf_yadif.c), the
port's counterpart of `libav_tpu/ops/yadif.py` `_yadif_plane_jit`.

The reference filters one output field per call: lines of the missing
field (``(y ^ parity) & 1``) are synthesized from three temporally
adjacent frames with an edge-directed spatial predictor clamped by a
temporal envelope (``FILTER`` macro, vf_yadif.c:57-99); the other lines
are copied from the current frame (filter_slice, vf_yadif.c:192-231).
Here the whole plane is one torch program over int32 planes on their own
device: the per-pixel C loop becomes elementwise tensor algebra over
column-shifted views, and the sequential CHECK(-1)/CHECK(-2)/CHECK(1)/
CHECK(2) score chain becomes a ``where`` cascade (the nesting matters:
CHECK(+-2) only runs when CHECK(+-1) improved the score). Row and column
edges are index gathers: the JAX program's edge padding is a clamped
column index, and its row gathers clamp out-of-range rows (and wrap
negative ones) as XLA's gather does, which matters on planes of one row.
"""

from __future__ import annotations

import torch


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _min3(a, b, c):
    return torch.minimum(a, torch.minimum(b, c))


def _rows(idx: torch.Tensor, h: int) -> torch.Tensor:
    """Row indices as an XLA gather takes them: negative ones count from
    the end, then every index is clamped into the plane."""
    return torch.where(idx < 0, idx + h, idx).clamp(0, h - 1)


def yadif_plane(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                parity: int, tff: int, mode: int) -> torch.Tensor:
    """Deinterlace one uint8 plane (three (h, w) tensors on one device);
    returns the full output plane, uint8, on that device."""
    parity, tff, mode = int(parity) & 1, int(tff) & 1, int(mode)
    h, w = cur.shape
    dev = cur.device
    prev = prev.to(torch.int32)
    cur_ = cur.to(torch.int32)
    nxt = nxt.to(torch.int32)

    ys = torch.arange(h, device=dev)
    # mrefs/prefs row mirroring (filter_slice: y ? -refs : refs etc.)
    my = _rows(torch.where(ys > 0, ys - 1, 1), h)
    py = _rows(torch.where(ys < h - 1, ys + 1, h - 2), h)
    # 2*mrefs / 2*prefs rows for the temporal envelope; rows 1 and h-2
    # never take that branch (mode forced to 2 there), clamping keeps the
    # gather in bounds where the value is unused.
    m2 = torch.where(ys > 0, ys - 2, ys + 2).clamp(0, h - 1)
    p2 = torch.where(ys < h - 1, ys + 2, ys - 2).clamp(0, h - 1)

    par = parity ^ tff
    prev2 = prev if par else cur_
    next2 = cur_ if par else nxt

    c = cur_[my]            # cur[mrefs]
    e = cur_[py]            # cur[prefs]
    d = (prev2 + next2) >> 1
    td0 = (prev2 - next2).abs()
    td1 = ((prev[my] - c).abs() + (prev[py] - e).abs()) >> 1
    td2 = ((nxt[my] - c).abs() + (nxt[py] - e).abs()) >> 1
    diff = _max3(td0 >> 1, td1, td2)
    sp = (c + e) >> 1

    # Edge-directed spatial search over column shifts. cm/cp are the
    # mrefs/prefs rows edge-padded by 3 columns, so cur[mrefs + j] ==
    # cm[:, x+3+j].
    cols = torch.arange(-3, w + 3, device=dev).clamp(0, w - 1)
    cm = c[:, cols]
    cp = e[:, cols]

    def col(a, j):
        return a[:, 3 + j:3 + j + w]

    def score(j):
        return ((col(cm, -1 + j) - col(cp, -1 - j)).abs()
                + (col(cm, j) - col(cp, -j)).abs()
                + (col(cm, 1 + j) - col(cp, 1 - j)).abs())

    def pred(j):
        return (col(cm, j) + col(cp, -j)) >> 1

    ss = score(0) - 1
    sp_e = sp
    imp1 = score(-1) < ss
    ss = torch.where(imp1, score(-1), ss)
    sp_e = torch.where(imp1, pred(-1), sp_e)
    imp2 = imp1 & (score(-2) < ss)          # CHECK(-2) nested in CHECK(-1)
    ss = torch.where(imp2, score(-2), ss)
    sp_e = torch.where(imp2, pred(-2), sp_e)
    imp1 = score(1) < ss
    ss = torch.where(imp1, score(1), ss)
    sp_e = torch.where(imp1, pred(1), sp_e)
    imp2 = imp1 & (score(2) < ss)
    sp_e = torch.where(imp2, pred(2), sp_e)

    xs = torch.arange(w, device=dev)
    not_edge = (xs >= 3) & (xs < w - 3)
    sp = torch.where(not_edge[None, :], sp_e, sp)

    if mode < 2:
        b = (prev2[m2] + next2[m2]) >> 1
        f = (prev2[p2] + next2[p2]) >> 1
        mx = _max3(d - e, d - c, torch.minimum(b - c, f - e))
        mn = _min3(d - e, d - c, torch.maximum(b - c, f - e))
        diff2 = _max3(diff, mn, -mx)
        # rows 1 and h-2 run with mode forced to 2 (filter_slice:216)
        rmask = (ys != 1) & (ys != h - 2)
        diff = torch.where(rmask[:, None], diff2, diff)

    out = torch.minimum(torch.maximum(sp, d - diff), d + diff)
    keep = ((ys ^ parity) & 1) == 0
    out = torch.where(keep[:, None], cur_, out)
    return out.to(torch.uint8)
