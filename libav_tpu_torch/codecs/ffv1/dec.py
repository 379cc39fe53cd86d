"""FFV1 decoder, versions 0/1 (counterpart of `libav_tpu/codecs/ffv1/
dec.py`, its host code copied and changed only in its imports and in the
upload of the finished frame; reference: libavcodec/ffv1dec.c —
read_header :555, decode_slice :339, decode_line :96, decode_plane
:165; shared layer ffv1.c/ffv1.h).

Lossless intra codec: per-sample adaptive context modeling (gradient
quantization -> median predictor -> range-coded or Golomb-Rice
residual).  The coding loop is host-serial by construction — every
residual updates the context state the next one is coded with — which
is also why the reference keeps it scalar C with no SIMD.  Being
lossless, this codec is an exact cross-validation oracle in both
directions: reference-encoded streams must decode bit-identically, and
our streams must decode bit-identically in the reference binary.

Supported: colorspace 0 (planar YUV/gray), 8-bit, both coders
(AC_GOLOMB_RICE and the range coder with default or custom state
transition), version 0 and 1 headers.  Not yet: version 2/3 multi-
slice syntax, colorspace 1 (RGB), >8-bit depths.

The port's decoder takes its torch device as a keyword (`FFV1Decoder(
params, device="cuda")` by default): it decodes on the host and uploads
each finished frame's planes to that device, as the rawvideo decoder
does."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.ffv1.common import (
    CONTEXT_SIZE, VlcState, fold, get_symbol, get_vlc_symbol, predict,
    read_quant_tables)
from libav_tpu_torch.codecs.ffv1.rangecoder import (
    DEFAULT_ONE_STATE, RangeDecoder)
from libav_tpu_torch.codecs.ffv1.tables import LOG2_RUN

PIX_FMT_BY_SHIFTS = {
    (0, 0): "yuv444p", (0, 1): "yuv440p", (1, 0): "yuv422p",
    (1, 1): "yuv420p", (2, 0): "yuv411p", (2, 2): "yuv410p",
}


class _Plane:
    __slots__ = ("quant_table", "context_count", "state", "vlc_state")

    def __init__(self):
        self.quant_table = None
        self.context_count = 0
        self.state: List[List[int]] = []
        self.vlc_state: List[VlcState] = []


@register_codec
class FFV1Decoder(Decoder):
    NAME = "ffv1"
    TYPE = MediaType.VIDEO
    LONG_NAME = "FFV1 (FF Video Codec 1) lossless"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """FFV1Decoder(params, options, device=...) — the planes of the
        output frames are tensors on `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._have_header = False
        self._version = 0
        self._ac = 0
        self._colorspace = 0
        self._bits = 8
        self._chroma_planes = 1
        self._chroma_h = 1
        self._chroma_v = 1
        self._transparency = 0
        self._state_transition = None   # custom tab (ac == 2)
        self._quant_table = None
        self._context_count = 0
        self._planes = [_Plane(), _Plane(), _Plane()]
        self._pix_fmt = self.params.pix_fmt or "yuv420p"

    # ------------------------------------------------------------------ #

    def _read_header(self, c: RangeDecoder):
        """reference: ffv1dec.c:555 read_header (version < 2 branch)."""
        state = [128] * CONTEXT_SIZE
        v = get_symbol(c, state, False)
        if v > 1:
            raise AVError(INVALIDDATA, "ffv1: version %d needs extradata"
                          % v)
        self._version = v
        self._ac = get_symbol(c, state, False)
        if self._ac == 2:       # AC_RANGE_CUSTOM_TAB
            tab = [0] * 256
            for i in range(1, 256):
                tab[i] = (get_symbol(c, state, True) +
                          DEFAULT_ONE_STATE[i]) & 0xFF
            # NOTE: the custom table is installed only after the whole
            # header — the reference applies it in ffv1_init_slice_state
            # (ffv1.c:175), which runs at decode_slice time, so every
            # header symbol still uses the default adaptation
            self._state_transition = tab
        self._colorspace = get_symbol(c, state, False)
        if v > 0:
            self._bits = get_symbol(c, state, False) or 8
        self._chroma_planes = c.get(state, 0)
        self._chroma_h = get_symbol(c, state, False)
        self._chroma_v = get_symbol(c, state, False)
        self._transparency = c.get(state, 0)

        if self._colorspace != 0 or self._bits > 8 or self._transparency:
            raise AVError(INVALIDDATA,
                          "ffv1: only 8-bit planar YUV/gray supported")
        if not self._chroma_planes:
            self._pix_fmt = "gray"
        else:
            key = (self._chroma_h, self._chroma_v)
            if key not in PIX_FMT_BY_SHIFTS:
                raise AVError(INVALIDDATA, "ffv1: bad chroma shifts")
            self._pix_fmt = PIX_FMT_BY_SHIFTS[key]

        tables, count = read_quant_tables(c)
        if tables is None:
            raise AVError(INVALIDDATA, "ffv1: bad quant tables")
        self._quant_table = tables
        self._context_count = count
        for p in self._planes:
            p.quant_table = tables
            p.context_count = count
        self._have_header = True

    def _clear_state(self):
        """reference: ffv1.c:258 ffv1_clear_slice_state."""
        nplanes = 2 + self._transparency
        for p in self._planes[:nplanes]:
            if self._ac:
                p.state = [[128] * CONTEXT_SIZE
                           for _ in range(p.context_count)]
            else:
                p.vlc_state = [VlcState() for _ in range(p.context_count)]

    # ------------------------------------------------------------------ #

    def _decode_line(self, coder, plane: _Plane, cur, up, w: int,
                     run_state: list):
        """reference: ffv1dec.c:96 decode_line (bits == 8).  cur/up are
        padded Python lists (offset +3); writes decoded samples into
        cur.  run_state = [run_index] persisted across lines."""
        qt = plane.quant_table
        q0, q1, q2, q3, q4 = qt[0], qt[1], qt[2], qt[3], qt[4]
        five = q3[127] != 0
        OFF = 3
        ac = self._ac
        if ac:
            states = plane.state
            rd = coder
        else:
            vlc = plane.vlc_state
            gb = coder
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
                # 5-gradient model.  decode_line passes sample[1] (the
                # current-row buffer) as last2: its cell at x has not
                # been overwritten yet, so it still holds row y-2's
                # sample — TT without a third line buffer (ffv1.h:146)
                context += (q3[(cur[xo - 2] - L) & 0xFF] +
                            q4[(cur[xo] - T) & 0xFF])
            if context < 0:
                context = -context
                sign = 1
            else:
                sign = 0

            if ac:
                diff = get_symbol(rd, states[context], True)
            else:
                if context == 0 and run_mode == 0:
                    run_mode = 1
                if run_mode:
                    if run_count == 0 and run_mode == 1:
                        if gb.get_bit():
                            run_count = 1 << LOG2_RUN[run_index]
                            if x + run_count <= w:
                                run_index += 1
                        else:
                            if LOG2_RUN[run_index]:
                                run_count = gb.get_bits(
                                    LOG2_RUN[run_index])
                            else:
                                run_count = 0
                            if run_index:
                                run_index -= 1
                            run_mode = 2
                    run_count -= 1
                    if run_count < 0:
                        run_mode = 0
                        run_count = 0
                        diff = get_vlc_symbol(gb, vlc[context], 8)
                        if diff >= 0:
                            diff += 1
                    else:
                        diff = 0
                else:
                    diff = get_vlc_symbol(gb, vlc[context], 8)

            if sign:
                diff = -diff

            # median predict + residual, wrapped to 8 bits
            g = L + T - LT
            if L > T:
                lo, hi = T, L
            else:
                lo, hi = L, T
            pred = lo if g < lo else (hi if g > hi else g)
            cur[xo] = (pred + diff) & 0xFF
        run_state[0] = run_index

    def _decode_plane(self, coder, plane: _Plane, w: int, h: int):
        """reference: ffv1dec.c:165 decode_plane."""
        out = np.empty((h, w), np.uint8)
        up = [0] * (w + 6)
        cur = [0] * (w + 6)
        run_state = [0]
        OFF = 3
        for y in range(h):
            up, cur = cur, up
            # borders: cur[-1] = up[0]; up[w] = up[w-1]
            cur[OFF - 1] = up[OFF]
            up[OFF + w] = up[OFF + w - 1]
            self._decode_line(coder, plane, cur, up, w, run_state)
            out[y] = cur[OFF:OFF + w]
        return out

    # ------------------------------------------------------------------ #

    def _decode(self, pkt: Packet) -> List[Frame]:
        data = bytes(pkt.data)
        c = RangeDecoder(data)
        keystate = [128]
        key = c.get(keystate, 0)
        if key:
            self._read_header(c)
        elif not self._have_header:
            raise AVError(INVALIDDATA, "ffv1: first frame is not a keyframe")

        w, h = self.width, self.height
        if not w or not h:
            raise AVError(INVALIDDATA, "ffv1: no dimensions")

        if key:
            self._clear_state()
        if self._ac == 2 and self._state_transition is not None:
            # ffv1.c:175 ffv1_init_slice_state — custom adaptation for
            # the plane payload (header symbols used the default)
            c.set_transition(self._state_transition)

        if self._ac == 0:
            # golomb path: range coder used only for the header; its
            # consumed bytes minus the 1-byte decoder lookahead start
            # the bit-level stream (ffv1dec.c:371)
            ac_bytes = c.bytes_consumed() - 1
            coder = GetBits(data[ac_bytes:])
        else:
            coder = c

        f = Frame.alloc_video(w, h, self._pix_fmt)
        f.key_frame = True
        f.pict_type = PictureType.I
        f.pts = pkt.pts
        f.color_range = "tv"

        f.planes[0][...] = self._decode_plane(coder, self._planes[0], w, h)
        if self._chroma_planes and len(f.planes) >= 3:
            # both chroma planes share PlaneContext index 1 — the
            # adaptation state carries from U into V (ffv1dec.c:decode_
            # slice passes plane_index 1 for data[1] AND data[2])
            cw = -(-w >> self._chroma_h)
            ch = -(-h >> self._chroma_v)
            f.planes[1][...] = self._decode_plane(
                coder, self._planes[1], cw, ch)
            f.planes[2][...] = self._decode_plane(
                coder, self._planes[1], cw, ch)
        f.planes = [torch.tensor(p, device=self.device) for p in f.planes]
        return [f]
