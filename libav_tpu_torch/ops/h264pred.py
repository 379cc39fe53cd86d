"""H.264 intra prediction (counterpart of `libav_tpu/ops/h264pred.py`
pred16x16, pred8x8_chroma, pred4x4 and pred8x8_luma; spec ISO 14496-10
§8.3).

Each call predicts a batch of blocks from their neighbour vectors, with
the mode chosen per block by masks. The I_4x4 and I_8x8 modes are the
JAX package's table-driven 3-term gathers; the tables are imported, not
retyped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libav_tpu.ops.h264pred import (_P4_IDX, _P4_RND, _P4_SH, _P4_W,
                                    _P8_IDX, _P8_RND, _P8_SH, _P8_W)


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: torch.device):
    """(idx, w, rnd, sh) of the n-sample-per-block mode tables (n=16 for
    4x4, 64 for 8x8) on device."""
    src = (_P4_IDX, _P4_W, _P4_RND, _P4_SH) if n == 16 else \
        (_P8_IDX, _P8_W, _P8_RND, _P8_SH)
    idx, w, rnd, sh = (torch.as_tensor(np.ascontiguousarray(a))
                       .to(device) for a in src)
    return idx.long(), w, rnd, sh


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 with jnp indexing semantics: negative
    indices count from the end and the rest clamp into range (the JAX
    package indexes mode tables with per-MB modes it does not
    range-check)."""
    n = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return table[i]


def pred16x16(mode, top, left, topleft, avail_top, avail_left):
    """Modes 0=V 1=H 2=DC 3=Plane. top/left (B,16), topleft (B,).
    -> (B,16,16) int32."""
    B = top.shape[0]
    t = top.to(torch.int32)
    l = left.to(torch.int32)
    at = avail_top.bool()
    al = avail_left.bool()

    v = t[:, None, :].expand(B, 16, 16)
    h = l[:, :, None].expand(B, 16, 16)

    ts = t.sum(1, dtype=torch.int32)
    ls = l.sum(1, dtype=torch.int32)
    dc = torch.where(at & al, (ts + ls + 16) >> 5,
                     torch.where(at, (ts + 8) >> 4,
                                 torch.where(al, (ls + 8) >> 4, 128)))
    dcp = dc[:, None, None].expand(B, 16, 16)

    tl = topleft.to(torch.int32)
    tt = torch.cat([tl[:, None], t], 1)                  # (B, 17)
    ll = torch.cat([tl[:, None], l], 1)
    Hsum = sum(x * (tt[:, 8 + x] - tt[:, 8 - x]) for x in range(1, 9))
    Vsum = sum(y * (ll[:, 8 + y] - ll[:, 8 - y]) for y in range(1, 9))
    b = (5 * Hsum + 32) >> 6
    c = (5 * Vsum + 32) >> 6
    a = 16 * (t[:, 15] + l[:, 15])
    r = torch.arange(16, dtype=torch.int32, device=t.device)
    plane = ((a[:, None, None] + b[:, None, None] * (r[None, None, :] - 7)
              + c[:, None, None] * (r[None, :, None] - 7) + 16) >> 5
             ).clamp(0, 255)

    m = mode.long()[:, None, None]
    return torch.where(m == 0, v,
                       torch.where(m == 1, h,
                                   torch.where(m == 2, dcp, plane)))


def pred8x8_chroma(mode, top, left, topleft, avail_top, avail_left):
    """Modes 0=DC 1=H 2=V 3=Plane. top/left (B,8). -> (B,8,8) int32."""
    B = top.shape[0]
    t = top.to(torch.int32)
    l = left.to(torch.int32)
    at = avail_top.bool()
    al = avail_left.bool()

    hpred = l[:, :, None].expand(B, 8, 8)
    vpred = t[:, None, :].expand(B, 8, 8)

    ts = [t[:, 0:4].sum(1, dtype=torch.int32),
          t[:, 4:8].sum(1, dtype=torch.int32)]
    ls = [l[:, 0:4].sum(1, dtype=torch.int32),
          l[:, 4:8].sum(1, dtype=torch.int32)]

    def dc_both(qx, qy):
        return torch.where(at & al, (ts[qx] + ls[qy] + 4) >> 3,
                           torch.where(at, (ts[qx] + 2) >> 2,
                                       torch.where(al, (ls[qy] + 2) >> 2,
                                                   128)))

    def dc_top_pref(qx, qy):
        return torch.where(at, (ts[qx] + 2) >> 2,
                           torch.where(al, (ls[qy] + 2) >> 2, 128))

    def dc_left_pref(qx, qy):
        return torch.where(al, (ls[qy] + 2) >> 2,
                           torch.where(at, (ts[qx] + 2) >> 2, 128))

    q = torch.stack([torch.stack([dc_both(0, 0), dc_top_pref(1, 0)], 1),
                     torch.stack([dc_left_pref(0, 1), dc_both(1, 1)], 1)],
                    1)                                   # (B, qy, qx)
    dcp = q.repeat_interleave(4, 1).repeat_interleave(4, 2)

    tl = topleft.to(torch.int32)
    tt = torch.cat([tl[:, None], t], 1)
    ll = torch.cat([tl[:, None], l], 1)
    Hs = sum(x * (tt[:, 4 + x] - tt[:, 4 - x]) for x in range(1, 5))
    Vs = sum(y * (ll[:, 4 + y] - ll[:, 4 - y]) for y in range(1, 5))
    b = (17 * Hs + 16) >> 5
    c = (17 * Vs + 16) >> 5
    a = 16 * (t[:, 7] + l[:, 7])
    r = torch.arange(8, dtype=torch.int32, device=t.device)
    plane = ((a[:, None, None] + b[:, None, None] * (r[None, None, :] - 3)
              + c[:, None, None] * (r[None, :, None] - 3) + 16) >> 5
             ).clamp(0, 255)

    m = mode.long()[:, None, None]
    return torch.where(m == 1, hpred,
                       torch.where(m == 2, vpred,
                                   torch.where(m == 3, plane, dcp)))


def _table_pred(src: torch.Tensor, mode, n: int) -> torch.Tensor:
    """Weighted 3-term gather of the mode tables over the per-block
    sample vector src (B, K) -> (B, n) int32."""
    idx_t, w_t, rnd_t, sh_t = _tables(n, src.device)
    B = src.shape[0]
    g = torch.gather(src, 1, _take(idx_t, mode).reshape(B, -1))
    v = (g.reshape(B, n, 3) * _take(w_t, mode)).sum(2, dtype=torch.int32)
    return (v + _take(rnd_t, mode)) >> _take(sh_t, mode)


def pred4x4(mode, t8, l4, tl, avail_top, avail_left):
    """mode (B,), t8 (B,8) top+topright (topright already substituted
    when unavailable), l4 (B,4), tl (B,). -> (B,4,4) int32."""
    t8 = t8.to(torch.int32)
    l4 = l4.to(torch.int32)
    at = avail_top.bool()
    al = avail_left.bool()
    ts = t8[:, :4].sum(1, dtype=torch.int32)
    ls = l4.sum(1, dtype=torch.int32)
    dc = torch.where(at & al, (ts + ls + 4) >> 3,
                     torch.where(at, (ts + 2) >> 2,
                                 torch.where(al, (ls + 2) >> 2, 128)))
    src = torch.cat([t8, l4, tl.to(torch.int32)[:, None], dc[:, None]], 1)
    return _table_pred(src, mode, 16).reshape(-1, 4, 4)


def pred8x8_luma(mode, top16, left8, tl, at, al, atl, atr):
    """I_8x8 prediction with the spec 8.3.2.2.1 reference filtering.
    mode (B,), top16 (B,16) raw, left8 (B,8) raw, tl (B,), flags (B,)
    bool -> (B,8,8) int32."""
    top16 = top16.to(torch.int32)
    left8 = left8.to(torch.int32)
    tli = tl.to(torch.int32)
    at, al, atl, atr = at.bool(), al.bool(), atl.bool(), atr.bool()
    top16 = torch.where(atr[:, None], top16,
                        torch.cat([top16[:, :8],
                                   top16[:, 7:8].expand(-1, 8)], 1))
    tp = torch.cat([top16[:, :1], top16, top16[:, 15:]], 1)  # edge pad
    t = (tp[:, :-2] + 2 * tp[:, 1:-1] + tp[:, 2:] + 2) >> 2   # (B,16)
    t0 = (torch.where(atl, tli, top16[:, 0]) + 2 * top16[:, 0]
          + top16[:, 1] + 2) >> 2
    t15 = (top16[:, 14] + 3 * top16[:, 15] + 2) >> 2
    t = torch.cat([t0[:, None], t[:, 1:15], t15[:, None]], 1)
    lp = torch.cat([left8[:, :1], left8, left8[:, 7:]], 1)
    l = (lp[:, :-2] + 2 * lp[:, 1:-1] + lp[:, 2:] + 2) >> 2    # (B,8)
    l0 = (torch.where(atl, tli, left8[:, 0]) + 2 * left8[:, 0]
          + left8[:, 1] + 2) >> 2
    l7 = (left8[:, 6] + 3 * left8[:, 7] + 2) >> 2
    l = torch.cat([l0[:, None], l[:, 1:7], l7[:, None]], 1)
    lt = (left8[:, 0] + 2 * tli + top16[:, 0] + 2) >> 2
    ts = t[:, :8].sum(1, dtype=torch.int32)
    ls = l.sum(1, dtype=torch.int32)
    dc = torch.where(at & al, (ts + ls + 8) >> 4,
                     torch.where(at, (ts + 4) >> 3,
                                 torch.where(al, (ls + 4) >> 3, 128)))
    src = torch.cat([t, l, lt[:, None], dc[:, None]], 1)
    return _table_pred(src, mode, 64).reshape(-1, 8, 8)
