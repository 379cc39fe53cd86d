"""AC-3 encoder (reference: libavcodec/ac3enc.c role; minimal compliant
subset for round-trip validation and transcode output).

Emits: mono/stereo, 48/44.1/32 kHz, fixed bitrate, D15 exponents in block
0 + REUSE in blocks 1-5 (exponents computed over the whole frame), no
coupling/LFE/dither/block-switch, shared bit allocation with a csnroffst
search to fill the frame.

Counterpart of `libav_tpu/codecs/ac3/enc.py`, copied: the six windowed
512-sample blocks of each frame and channel go through the port's
`ops/fftmdct.mdct` (a float32 `torch.matmul`) on the encoder's device,
one upload and one download per frame where the JAX encoder calls its
XLA dot; everything after the transform runs on the host, as there.
torch and XLA sum the float32 products in other orders (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.ac3 import bitalloc, tables as T
from libav_tpu_torch.codecs.ac3.dec import EXP_D15, EXP_REUSE, _sym
from libav_tpu_torch.ops import fftmdct as F
from libav_tpu_torch.ops.fftmdct import mdct

CHBWCOD = 48                        # endmant = 217 -> 72 exact D15 groups
ENDMANT = ((CHBWCOD + 12) * 3) + 37


def _quant_sym(v: float, levels: int) -> int:
    c = int(round((v * levels + levels - 1) / 2.0))
    return max(0, min(levels - 1, c))


def _quant_asym(v: float, bits: int) -> int:
    h = 1 << (bits - 1)
    c = int(round(v * h))
    return max(-h, min(h - 1, c))


@register_codec
class AC3Encoder(Encoder):
    NAME = "ac3"
    TYPE = MediaType.AUDIO
    LONG_NAME = "ATSC A/52 AC-3 (PyTorch device MDCT)"
    DEVICE_PART = True

    OPTIONS = Encoder.OPTIONS + [
        Option("bitrate_kbps", "bitrate in kbit/s", "int", 192, 32, 640),
    ]

    FRAME_SAMPLES = 1536

    # source (ffmpeg fltp layout) -> AC-3 channel order (A/52 table 5.9)
    _LAYOUTS = {
        1: (1, [0], None),                      # C
        2: (2, [0, 1], None),                   # L R
        5: (7, [0, 2, 1, 3, 4], None),          # L C R Ls Rs
        6: (7, [0, 2, 1, 4, 5], 3),             # 5.1 (LFE at src idx 3)
    }

    def __init__(self, params=None, options=None, *, device="cuda"):
        """AC3Encoder(params, options, device=...): the MDCT runs on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        if self.sample_rate not in T.SAMPLE_RATES:
            raise AVError(EINVAL, f"ac3: unsupported rate {self.sample_rate}")
        if self.channels not in self._LAYOUTS:
            raise AVError(EINVAL, f"ac3 encoder: {self.channels} channels "
                                  "unsupported (1/2/5/6)")
        self.fscod = T.SAMPLE_RATES.index(self.sample_rate)
        if self.channels >= 5 and self.bitrate_kbps < 256:
            self.bitrate_kbps = 384      # 192k default cannot fit 5.1
        try:
            ridx = T.BITRATES.index(self.bitrate_kbps)
        except ValueError:
            raise AVError(EINVAL, f"ac3: bitrate {self.bitrate_kbps} invalid")
        self.frmsizecod = ridx * 2
        self.frame_bytes = int(T.FRAME_SIZE[self.frmsizecod][self.fscod]) * 2
        self.acmod, self.ch_map, self.lfe_src = self._LAYOUTS[self.channels]
        self.lfe = self.lfe_src is not None
        self.nfchans = len(self.ch_map)
        self._buf = np.zeros((self.channels, 0), dtype=np.float64)
        self._prev_tail = np.zeros((self.channels, 256), dtype=np.float64)
        self._pts = 0

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        x = self._to_planar(frame)
        self._buf = np.concatenate([self._buf, x], axis=1)
        pkts = []
        while self._buf.shape[1] >= self.FRAME_SAMPLES:
            chunk = self._buf[:, :self.FRAME_SAMPLES]
            self._buf = self._buf[:, self.FRAME_SAMPLES:]
            pkts.append(self._encode_frame(chunk, frame))
        return pkts

    def _drain(self) -> List[Packet]:
        if self._buf.shape[1] == 0:
            return []
        pad = self.FRAME_SAMPLES - self._buf.shape[1]
        chunk = np.pad(self._buf, ((0, 0), (0, pad)))
        self._buf = self._buf[:, :0]
        return [self._encode_frame(chunk, None)]

    def _to_planar(self, frame: Frame) -> np.ndarray:
        from libav_tpu_torch.avutil.samplefmt import is_planar, np_dtype
        if is_planar(frame.format):
            x = np.stack([np.asarray(p) for p in frame.planes]).astype(np.float64)
        else:
            arr = np.asarray(frame.planes[0]).reshape(-1, frame.channels)
            x = arr.T.astype(np.float64)
        dt = np_dtype(frame.format)
        if np.issubdtype(dt, np.integer):
            x = x / (np.iinfo(dt).max + 1)
        return x

    # ------------------------------------------------------------------ #

    def _encode_frame(self, pcm: np.ndarray, src) -> Packet:
        # reorder into AC-3 channel order: fchans then the LFE row last
        order = list(self.ch_map) + ([self.lfe_src] if self.lfe else [])
        pcm = pcm[order]
        nch = self.nfchans + (1 if self.lfe else 0)
        endm = [ENDMANT] * self.nfchans + ([7] if self.lfe else [])
        win = F.kbd_window(512, alpha=5.0)
        # 6 blocks with 256-sample hop; block b covers
        # [prev_tail | pcm] slice starting at b*256
        ext = np.concatenate([self._prev_tail, pcm], axis=1)  # (nch, 1792)
        blocks = np.stack([ext[:, b * 256:b * 256 + 512] * win
                           for b in range(6)])                # (6,nch,512)
        self._prev_tail = pcm[:, -256:].copy()
        x = torch.from_numpy(blocks.reshape(6 * nch, 512)
                             .astype(np.float32)).to(self.device)
        spec = mdct(x).cpu().numpy().astype(np.float64)
        # A/52 coefficients are fractions: fold the 2/N forward
        # normalization here, negated — ops/fftmdct's transform has the
        # opposite sign of the reference's MDCT convention (calibrated
        # against the reference decoder; the decoder mirrors this with
        # its own negative IMDCT scale)
        spec = spec.reshape(6, nch, 256) * (-2.0 / 512.0)

        # exponents: one D15 set per channel for the whole frame
        exps = np.zeros((nch, 256), dtype=np.int32)
        for ch in range(nch):
            em = endm[ch]
            mag = np.abs(spec[:, ch, :em]).max(axis=0)
            e = np.where(mag > 0, np.floor(-np.log2(np.maximum(mag, 1e-10))),
                         24).astype(np.int32)
            e = np.clip(e, 0, 24)
            # D15 differential constraint: |diff| <= 2; absexp is a
            # 4-bit field, so the first exponent caps at 15
            e[0] = min(e[0], 15)
            for i in range(1, em):
                e[i] = min(e[i], e[i - 1] + 2)
            for i in range(em - 2, -1, -1):
                e[i] = min(e[i], e[i + 1] + 2)
            e[0] = min(e[0], 15)
            exps[ch, :em] = e

        # bit allocation: search csnroffst that fits the frame
        budget = self.frame_bytes * 8 - 600 - nch * 6 * 8
        exp_bits = sum(6 + 4 + 2 + ((endm[ch] - 1) // 3) * 7 + 2
                       for ch in range(nch)) + 200
        budget -= exp_bits
        best_cs = 1
        for cs in range(63, 0, -1):
            total = 0
            for ch in range(nch):
                bap = bitalloc.run_bit_alloc(exps[ch], 0, endm[ch],
                                             self.fscod, csnroffst=cs)
                total += T.mantissa_bits(bap) * 6
            if total <= budget:
                best_cs = cs
                break
        self._csnroffst = best_cs
        baps = [bitalloc.run_bit_alloc(exps[ch], 0, endm[ch], self.fscod,
                                       csnroffst=best_cs)
                for ch in range(nch)]

        data = self._pack(spec, exps, baps)
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=self.FRAME_SAMPLES, flags=PKT_FLAG_KEY)
        if src is not None:
            pkt.time_base = src.time_base
        self._pts += self.FRAME_SAMPLES
        return pkt

    # ------------------------------------------------------------------ #

    def _pack(self, spec, exps, baps) -> bytes:
        nf = self.nfchans
        nch = nf + (1 if self.lfe else 0)
        endm = [ENDMANT] * nf + ([7] if self.lfe else [])
        pb = PutBits()
        pb.put_bits(16, 0x0B77)
        pb.put_bits(16, 0)               # crc1 (not computed; round 2)
        pb.put_bits(2, self.fscod)
        pb.put_bits(6, self.frmsizecod)
        pb.put_bits(5, 8)                # bsid
        pb.put_bits(3, 0)                # bsmod
        pb.put_bits(3, self.acmod)
        if self.acmod & 1 and self.acmod != 1:
            pb.put_bits(2, 1)            # cmixlev -4.5dB
        if self.acmod & 4:
            pb.put_bits(2, 1)            # surmixlev -6dB
        if self.acmod == 2:
            pb.put_bits(2, 0)            # dsurmod
        pb.put_bits(1, 1 if self.lfe else 0)   # lfeon
        pb.put_bits(5, 31)               # dialnorm
        pb.put_bits(1, 0)                # compre
        pb.put_bits(1, 0)                # langcode
        pb.put_bits(1, 0)                # audprodie
        pb.put_bits(2, 0)                # copyrightb + origbs
        pb.put_bits(1, 0)                # timecod1e
        pb.put_bits(1, 0)                # timecod2e
        pb.put_bits(1, 0)                # addbsie

        for blk in range(6):
            for _ in range(nf):
                pb.put_bits(1, 0)        # blksw
            for _ in range(nf):
                pb.put_bits(1, 0)        # dithflag
            pb.put_bits(1, 0)            # dynrnge
            if blk == 0:
                pb.put_bits(1, 1)        # cplstre (mandatory in block 0)
                pb.put_bits(1, 0)        # cplinu = 0
            else:
                pb.put_bits(1, 0)        # cplstre
            if self.acmod == 2:
                if blk == 0:
                    pb.put_bits(1, 1)    # rematstr
                    for _ in range(4):
                        pb.put_bits(1, 0)
                else:
                    pb.put_bits(1, 0)
            for ch in range(nf):
                pb.put_bits(2, EXP_D15 if blk == 0 else EXP_REUSE)
            if self.lfe:
                pb.put_bits(1, 1 if blk == 0 else 0)   # lfeexpstr
            if blk == 0:
                # A/52 block syntax: ALL chbwcod fields first, then the
                # per-channel exponent sets (reference: ac3dec.c
                # decode_audio_block 'channel bandwidth' loop precedes
                # the 'decode exponents' loop)
                for ch in range(nf):
                    pb.put_bits(6, CHBWCOD)
                for ch in range(nf):
                    self._pack_exponents(pb, exps[ch], ENDMANT)
                    pb.put_bits(2, 0)    # gainrng
                if self.lfe:
                    # lfeexps: absexp + 2 D15 groups over 6 diffs
                    self._pack_exponents(pb, exps[nf], 7)
            if blk == 0:
                pb.put_bits(1, 1)        # baie
                pb.put_bits(2, 2)        # sdcycod
                pb.put_bits(2, 1)        # fdcycod
                pb.put_bits(2, 1)        # sgaincod
                pb.put_bits(2, 2)        # dbpbcod
                pb.put_bits(3, 7)        # floorcod
                pb.put_bits(1, 1)        # snroffste
                pb.put_bits(6, self._csnroffst)
                for ch in range(nf):
                    pb.put_bits(4, 0)    # fsnroffst
                    pb.put_bits(3, 4)    # fgaincod
                if self.lfe:
                    pb.put_bits(4, 0)    # lfefsnroffst
                    pb.put_bits(3, 4)    # lfefgaincod
            else:
                pb.put_bits(1, 0)        # baie
                pb.put_bits(1, 0)        # snroffste
            pb.put_bits(1, 0)            # deltbaie
            pb.put_bits(1, 0)            # skiple
            self._pack_mantissas(pb, spec[blk], exps, baps, endm)

        pb.put_bits(16, 0)               # crc2 placeholder
        data = bytearray(pb.flush())
        if len(data) > self.frame_bytes:
            raise AVError(EINVAL, f"ac3: frame overflow {len(data)} > "
                                  f"{self.frame_bytes}")
        data += b"\x00" * (self.frame_bytes - len(data))
        return bytes(data)

    def _pack_exponents(self, pb, exps, endmant):
        pb.put_bits(4, int(exps[0]))
        prev = int(exps[0])
        diffs = []
        for i in range(1, endmant):
            d = int(exps[i]) - prev
            d = max(-2, min(2, d))
            diffs.append(d + 2)
            prev = prev + d
        while len(diffs) % 3:
            diffs.append(2)
        for g in range(0, len(diffs), 3):
            pb.put_bits(7, diffs[g] * 25 + diffs[g + 1] * 5 + diffs[g + 2])

    def _pack_mantissas(self, pb, spec_blk, exps, baps, endm=None):
        """Grouped mantissas (bap 1/2/4) are transmitted at the position
        of the FIRST member of each group (the decoder reads the group
        code lazily there), so we build a token list with group slots and
        serialize afterwards."""
        nch = len(baps)
        if endm is None:
            endm = [ENDMANT] * nch
        tokens = []           # ('bits', n, value) or ('grp', kind, list)
        groups = {1: None, 2: None, 4: None}

        def add_grouped(kind, code):
            g = groups[kind]
            size = 2 if kind == 4 else 3
            if g is None or len(g) >= size:
                g = [code]
                groups[kind] = g
                tokens.append(("grp", kind, g))
            else:
                g.append(code)

        for ch in range(nch):
            for i in range(endm[ch]):
                b = int(baps[ch][i])
                if b == 0:
                    continue
                v = spec_blk[ch][i] * (2.0 ** int(exps[ch][i]))
                v = max(-0.999999, min(0.999999, v))
                if b == 1:
                    add_grouped(1, _quant_sym(v, 3))
                elif b == 2:
                    add_grouped(2, _quant_sym(v, 5))
                elif b == 3:
                    tokens.append(("bits", 3, _quant_sym(v, 7)))
                elif b == 4:
                    add_grouped(4, _quant_sym(v, 11))
                elif b == 5:
                    tokens.append(("bits", 4, _quant_sym(v, 15)))
                else:
                    bits = T.BAP_BITS[b]
                    raw = _quant_asym(v, bits)
                    tokens.append(("bits", bits, raw & ((1 << bits) - 1)))

        for kind, tok in ((1, None), (2, None), (4, None)):
            g = groups[kind]
            if g is not None:
                size = 2 if kind == 4 else 3
                mid = {1: 1, 2: 2, 4: 5}[kind]
                while len(g) < size:
                    g.append(mid)

        for t in tokens:
            if t[0] == "bits":
                pb.put_bits(t[1], t[2])
            else:
                kind, g = t[1], t[2]
                if kind == 1:
                    pb.put_bits(5, g[0] * 9 + g[1] * 3 + g[2])
                elif kind == 2:
                    pb.put_bits(7, g[0] * 25 + g[1] * 5 + g[2])
                else:
                    pb.put_bits(7, g[0] * 11 + g[1])
