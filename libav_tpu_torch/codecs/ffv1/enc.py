"""FFV1 encoder, version 0/1 (counterpart of `libav_tpu/codecs/ffv1/
enc.py`, host code copied and changed only in its imports and in taking
frames from any device: their planes come to the host once per frame;
reference: libavcodec/ffv1enc.c —
ffv1_encode_frame :925, encode_slice :860, encode_plane :253,
encode_line :163, write_header :373).

Byte-exactness contract: for the same options the produced stream is
accepted and decoded bit-identically by the reference binary (the
lossless codec makes this an exact oracle — asserted by the cross
tests).  Single slice, colorspace 0, 8-bit, both coders:

- coder 0: Golomb-Rice run mode (the reference's default)
- coder 1: range coder with the ver2 custom state-transition table
  (AC_RANGE_CUSTOM_TAB — the reference maps any coder_type > 0 to it,
  ffv1enc.c:584)

context 0/1 selects the 3- or 5-gradient built-in quant table set
(ffv1enc.c:683-706)."""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.ffv1.common import (
    CONTEXT_SIZE, VlcState, fold, put_symbol, put_vlc_symbol,
    write_quant_table)
from libav_tpu_torch.codecs.ffv1.rangecoder import (
    DEFAULT_ONE_STATE, RangeEncoder)
from libav_tpu_torch.codecs.ffv1.tables import (
    LOG2_RUN, VER2_STATE, build_quant_tables)

_SHIFTS_BY_FMT = {
    "yuv444p": (0, 0), "yuv440p": (0, 1), "yuv422p": (1, 0),
    "yuv420p": (1, 1), "yuv411p": (2, 0), "yuv410p": (2, 2),
    "gray": (0, 0),
}


class _Plane:
    __slots__ = ("state", "vlc_state")

    def __init__(self):
        self.state = []
        self.vlc_state = []


@register_codec
class FFV1Encoder(Encoder):
    NAME = "ffv1"
    TYPE = MediaType.VIDEO
    LONG_NAME = "FFV1 (FF Video Codec 1) lossless"

    OPTIONS = Encoder.OPTIONS + [
        Option("coder", "0=golomb-rice 1=range/default-tab "
               "2=range/custom-tab", "int", 0, 0, 2),
        Option("context", "context model: 0=3-gradient 1=5-gradient",
               "int", 0, 0, 1),
        Option("gop_size", "keyframe interval", "int", 12, 0, 600),
    ]

    def _init(self):
        fmt = self.pix_fmt or "yuv420p"
        if fmt not in _SHIFTS_BY_FMT:
            raise AVError(EINVAL, "ffv1 encoder: unsupported pix_fmt %s"
                          % fmt)
        self._chroma_planes = 0 if fmt == "gray" else 1
        self._chroma_h, self._chroma_v = _SHIFTS_BY_FMT[fmt]
        # the private -coder option maps directly to ac: 0 = golomb
        # rice, 1 = range/default tab, 2 = range/custom (ver2) tab
        # (ffv1enc.c:1073 AVOption "coder" OFFSET(ac), :680 ver2 init)
        self._ac = self.coder
        self._state_transition = list(VER2_STATE) if self._ac == 2 else None
        tables, counts = build_quant_tables(8)
        self._quant_table = tables[self.context]
        self._context_count = counts[self.context]
        self._planes = [_Plane(), _Plane()]
        self._pic_num = 0

    # ------------------------------------------------------------------ #

    def _write_header(self, c: RangeEncoder):
        """reference: ffv1enc.c:373 write_header (version < 2)."""
        state = [128] * CONTEXT_SIZE
        put_symbol(c, state, 0, False)          # version 0
        put_symbol(c, state, self._ac, False)
        if self._ac == 2:
            for i in range(1, 256):
                # raw signed delta vs the default adaptation (the two
                # uint8 values promote to int in C, so the range is
                # -255..255, NOT folded to int8 — ffv1enc.c:387)
                put_symbol(c, state,
                           self._state_transition[i] - DEFAULT_ONE_STATE[i],
                           True)
        put_symbol(c, state, 0, False)          # colorspace 0
        c.put(state, 0, self._chroma_planes)
        put_symbol(c, state, self._chroma_h, False)
        put_symbol(c, state, self._chroma_v, False)
        c.put(state, 0, 0)                      # transparency
        for t in self._quant_table:
            write_quant_table(c, t)

    def _clear_state(self):
        """reference: ffv1.c:248 ffv1_clear_slice_state."""
        for p in self._planes:
            if self._ac:
                p.state = [[128] * CONTEXT_SIZE
                           for _ in range(self._context_count)]
            else:
                p.vlc_state = [VlcState()
                               for _ in range(self._context_count)]

    # ------------------------------------------------------------------ #

    def _encode_line(self, coder, plane: _Plane, cur, up, up2, w: int,
                     run_state: list):
        """reference: ffv1enc.c:163 encode_line (bits == 8).  cur holds
        the source samples for this row; up/up2 the previous rows
        (padded lists, offset +3)."""
        qt = self._quant_table
        q0, q1, q2, q3, q4 = qt
        five = q3[127] != 0
        OFF = 3
        ac = self._ac
        if ac:
            states = plane.state
            rc = coder
        else:
            vlc = plane.vlc_state
            pb = coder
        run_index = run_state[0]
        run_count = 0
        run_mode = 0
        for x in range(w):
            xo = x + OFF
            L = cur[xo - 1]
            LT = up[xo - 1]
            T = up[xo]
            RT = up[xo + 1]
            context = (q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] +
                       q2[(T - RT) & 0xFF])
            if five:
                context += (q3[(cur[xo - 2] - L) & 0xFF] +
                            q4[(up2[xo] - T) & 0xFF])
            g = L + T - LT
            lo, hi = (T, L) if L > T else (L, T)
            pred = lo if g < lo else (hi if g > hi else g)
            diff = cur[xo] - pred
            if context < 0:
                context = -context
                diff = -diff
            diff = fold(diff, 8)

            if ac:
                put_symbol(rc, states[context], diff, True)
                continue

            if context == 0:
                run_mode = 1
            if run_mode:
                if diff:
                    while run_count >= (1 << LOG2_RUN[run_index]):
                        run_count -= 1 << LOG2_RUN[run_index]
                        run_index += 1
                        pb.put_bits(1, 1)
                    pb.put_bits(1 + LOG2_RUN[run_index], run_count)
                    if run_index:
                        run_index -= 1
                    run_count = 0
                    run_mode = 0
                    if diff > 0:
                        diff -= 1
                else:
                    run_count += 1
            if run_mode == 0:
                put_vlc_symbol(pb, vlc[context], diff, 8)

        if run_mode:
            while run_count >= (1 << LOG2_RUN[run_index]):
                run_count -= 1 << LOG2_RUN[run_index]
                run_index += 1
                pb.put_bits(1, 1)
            if run_count:
                pb.put_bits(1, 1)
        run_state[0] = run_index

    def _encode_plane(self, coder, plane: _Plane, src: np.ndarray,
                      w: int, h: int):
        """reference: ffv1enc.c:253 encode_plane — ring of 2 rows for
        the 3-gradient model, 3 rows when the 5-gradient needs TT."""
        ring = 3 if self.context else 2
        rows = [[0] * (w + 6) for _ in range(ring)]
        run_state = [0]
        OFF = 3
        for y in range(h):
            sample = [rows[(h + i - y) % ring] for i in range(ring)]
            cur, up = sample[0], sample[1]
            up2 = sample[2] if ring == 3 else up
            cur[OFF - 1] = up[OFF]
            up[OFF + w] = up[OFF + w - 1]
            row = src[y]
            for x in range(w):
                cur[x + OFF] = int(row[x])
            self._encode_line(coder, plane, cur, up, up2, w, run_state)

    # ------------------------------------------------------------------ #

    def _encode(self, frame) -> List[Packet]:
        w, h = frame.width, frame.height
        c = RangeEncoder()
        keystate = [128]
        key = (self.gop_size == 0 or
               self._pic_num % max(self.gop_size, 1) == 0)
        if key:
            c.put(keystate, 0, 1)
            self._write_header(c)
        else:
            c.put(keystate, 0, 0)

        if self._ac == 2:
            c.set_transition(self._state_transition)
        if key:
            self._clear_state()

        host = frame.to_host()
        if self._ac == 0:
            # terminate the range coder; Golomb bits continue at that
            # byte offset (encode_slice: ff_rac_terminate + init_put_bits)
            head = c.terminate()
            coder = PutBits()
        else:
            coder = c

        planes = [np.asarray(host.planes[0])]
        dims = [(w, h)]
        if self._chroma_planes:
            cw = -(-w >> self._chroma_h)
            ch = -(-h >> self._chroma_v)
            planes += [np.asarray(host.planes[1]),
                       np.asarray(host.planes[2])]
            dims += [(cw, ch), (cw, ch)]

        self._encode_plane(coder, self._planes[0], planes[0], w, h)
        if self._chroma_planes:
            # U and V share plane context 1 (encode_slice plane_index 1
            # for both chroma planes)
            self._encode_plane(coder, self._planes[1], planes[1], *dims[1])
            self._encode_plane(coder, self._planes[1], planes[2], *dims[2])

        if self._ac:
            # reference: put_rac(&fs->c, (uint8_t[]){129}, 0) then
            # ff_rac_terminate (ffv1_encode_frame :982)
            c.put([129], 0, 0)
            data = c.terminate()
        else:
            data = head + coder.flush()

        self._pic_num += 1
        pkt = Packet(data=data, pts=frame.pts, dts=frame.pts,
                     flags=PKT_FLAG_KEY if key else 0,
                     time_base=frame.time_base)
        return [pkt]
