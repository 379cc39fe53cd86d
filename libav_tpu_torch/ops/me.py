"""Batched motion estimation: a full-pel log-step diamond search and a
half-pel refinement of every macroblock of a picture in lockstep
(counterpart of `libav_tpu/ops/me.py` _search_jit, _hpel_refine_jit,
motion_search, motion_search_ref and sad_ref; reference: motion_est.c
diamond search and me_cmp.c SAD).

Every step evaluates one candidate vector for all macroblocks at once:
one batched 16x16 gather from the padded reference and one SAD reduce.
The schedule is the JAX package's, so the vectors are the same: steps
8, 4, 2, 1 (for range 15), the eight `_DIAMOND` neighbours in order, a
strict `<`, so a tie keeps the earlier candidate; candidates clamped to
the search range, the patch origin clamped into the padded plane. The refinement tries the nine half-pel
vectors around twice the full-pel one through `mc_hpel` (rounding 1),
starting from a best SAD of 1 << 30.

With bounded=True (the MPEG-1/2 encoders) every candidate is clamped
after the clamp to the search range so that the 16x16 patch stays inside
the picture, [-x, W-16-x] x [-y, H-16-y] for the MB at (x, y), and the
refinement's half-pel candidates to twice those bounds: MPEG-1/2 forbid
vectors that reach outside the coded area.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.ops.mc import EDGE, gather_patches, mc_hpel


def sad_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Golden SAD (reference: me_cmp.h:40 pix_abs)."""
    return np.abs(a.astype(np.int32) - b.astype(np.int32)).sum(axis=(-1, -2))


# log-step diamond offsets (dx, dy)
_DIAMOND = np.array([(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
                     (1, 1), (1, -1), (-1, 1), (-1, -1)], dtype=np.int32)


def _sad(cur_mbs: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    return (cur_mbs - patches).abs().sum(dim=(1, 2), dtype=torch.int32)


class _Search(nn.Module):
    """Per-geometry constants of a search over mb_w x mb_h macroblocks:
    the MB origins and the diamond."""

    def __init__(self, mb_w: int, mb_h: int, bounded: bool = False,
                 scale: int = 1):
        super().__init__()
        self.nmb = mb_w * mb_h
        self.bounded = bounded
        xs = (np.arange(self.nmb) % mb_w) * 16
        ys = (np.arange(self.nmb) // mb_w) * 16
        self.register_buffer("xs", torch.as_tensor(xs.astype(np.int32)))
        self.register_buffer("ys", torch.as_tensor(ys.astype(np.int32)))
        self.register_buffer("offsets", torch.as_tensor(_DIAMOND))
        # the vectors that keep each MB's patch inside the picture, in
        # units of 1 / scale pel: (nmb, 2) lower and upper bounds
        lo = -scale * np.stack([xs, ys], 1)
        hi = scale * np.stack([mb_w * 16 - 16 - xs, mb_h * 16 - 16 - ys], 1)
        self.register_buffer("lo", torch.as_tensor(lo.astype(np.int32)))
        self.register_buffer("hi", torch.as_tensor(hi.astype(np.int32)))

    def bound(self, cand: torch.Tensor) -> torch.Tensor:
        """cand clamped into the picture where the search is bounded."""
        if not self.bounded:
            return cand
        return torch.maximum(torch.minimum(cand, self.hi), self.lo)


class FullPelSearch(_Search):
    """The JAX _search_jit program: (cur_mbs (nmb, 16, 16) int32, padded
    reference plane) -> (full-pel vectors (nmb, 2) int32, best SAD)."""

    def __init__(self, mb_w: int, mb_h: int, search_range: int,
                 bounded: bool = False):
        super().__init__(mb_w, mb_h, bounded)
        self.search_range = search_range
        s = 1
        while s * 2 <= search_range:
            s *= 2
        self.steps = []
        while s >= 1:
            self.steps.append(s)
            s //= 2

    def sad(self, cur_mbs, padded_ref, mv):
        hp, wp = padded_ref.shape
        cx = ((self.xs + mv[:, 0]).clamp(min=-EDGE) + EDGE).clamp(max=wp - 16)
        cy = ((self.ys + mv[:, 1]).clamp(min=-EDGE) + EDGE).clamp(max=hp - 16)
        return _sad(cur_mbs, gather_patches(padded_ref, cy, cx, 16))

    def forward(self, cur_mbs, padded_ref):
        mv = torch.zeros((self.nmb, 2), dtype=torch.int32,
                         device=cur_mbs.device)
        best = self.sad(cur_mbs, padded_ref, mv)
        r = self.search_range
        for step in self.steps:
            for k in range(1, len(_DIAMOND)):
                cand = self.bound((mv + self.offsets[k] * step)
                                  .clamp(-r, r))
                sad = self.sad(cur_mbs, padded_ref, cand)
                mv = torch.where((sad < best)[:, None], cand, mv)
                best = torch.minimum(sad, best)
        return mv, best


class HpelRefine(_Search):
    """The JAX _hpel_refine_jit program: (cur_mbs, padded reference,
    full-pel vectors) -> (half-pel vectors (nmb, 2) int32, their SAD)."""

    def __init__(self, mb_w: int, mb_h: int, bounded: bool = False):
        # half-pel bounds: an odd value below the (even) upper bound
        # still reads only up to the last sample of the picture
        super().__init__(mb_w, mb_h, bounded, scale=2)

    def forward(self, cur_mbs, padded_ref, fullpel_mv):
        mv = fullpel_mv * 2
        best = torch.full((self.nmb,), 1 << 30, dtype=torch.int32,
                          device=cur_mbs.device)
        out = mv
        for k in range(len(_DIAMOND)):
            cand = self.bound(mv + self.offsets[k])
            pred = mc_hpel(padded_ref, self.xs, self.ys, cand[:, 0],
                           cand[:, 1], 16)
            sad = _sad(cur_mbs, pred)
            out = torch.where((sad < best)[:, None], cand, out)
            best = torch.minimum(sad, best)
        return out, best


@functools.lru_cache(maxsize=16)
def search(mb_w: int, mb_h: int, search_range: int, bounded: bool = False,
           *, device: torch.device) -> FullPelSearch:
    return FullPelSearch(mb_w, mb_h, search_range, bounded).to(device)


@functools.lru_cache(maxsize=16)
def hpel_refine(mb_w: int, mb_h: int, bounded: bool = False, *,
                device: torch.device) -> HpelRefine:
    return HpelRefine(mb_w, mb_h, bounded).to(device)


def motion_search(cur_mbs, padded_ref, mb_w: int, mb_h: int,
                  search_range: int = 15):
    """Full-pel diamond search + half-pel refine.
    cur_mbs: (nmb, 16, 16) int32. Returns (mv_halfpel (nmb,2), sad (nmb,))."""
    dev = cur_mbs.device
    mv, _ = search(mb_w, mb_h, search_range, device=dev)(cur_mbs, padded_ref)
    return hpel_refine(mb_w, mb_h, device=dev)(cur_mbs, padded_ref, mv)


def motion_search_ref(cur_mbs: np.ndarray, padded_ref: np.ndarray,
                      mb_w: int, mb_h: int, search_range: int = 15):
    """Golden (slow) exhaustive full-pel search for small tests."""
    nmb = mb_w * mb_h
    mvs = np.zeros((nmb, 2), dtype=np.int32)
    sads = np.zeros(nmb, dtype=np.int32)
    for i in range(nmb):
        x0 = (i % mb_w) * 16 + EDGE
        y0 = (i // mb_w) * 16 + EDGE
        best, bmv = 1 << 30, (0, 0)
        for dy in range(-search_range, search_range + 1):
            for dx in range(-search_range, search_range + 1):
                p = padded_ref[y0 + dy:y0 + dy + 16, x0 + dx:x0 + dx + 16]
                s = sad_ref(cur_mbs[i], p)
                if s < best:
                    best, bmv = s, (dx, dy)
        mvs[i] = bmv
        sads[i] = best
    return mvs, sads
