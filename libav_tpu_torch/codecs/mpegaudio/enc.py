"""MPEG audio encoders.

MP2 (Layer II): role of the reference's mpegaudioenc.c — analysis
filterbank + scalefactors + fixed bit allocation; output validated by
decoding with BOTH our decoder and the reference and comparing PCM.

MP3 (Layer III): a minimal-but-legal encoder (long blocks,
main_data_begin=0, one Huffman table, no scalefactors) whose purpose is
generating Layer III conformance streams — the reference has no native
MP3 encoder, so our-encode -> both-decoders-agree is the validation
path for the Layer III decoder.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpegaudio import tables as T

_SBLIMIT = 32


def _analysis_kernel():
    """512-tap analysis window + 32-band matrixing (ISO 11172-3 C.1.3;
    window = ENWINDOW with the encoder's sign handling,
    mpegaudioenc.c:135-147 filter()): returns (win512, M[32, 64])."""
    w = np.zeros(512)
    half = T.ENWINDOW.copy()
    for i in range(257):
        v = half[i]
        w[i] = v
        if (i & 63) != 0:
            v = -v
        if i != 0:
            w[512 - i] = v
    # spec analysis: z[n]=x[n]*C[n]; y[k]=sum z[k+64j]; s[i]=sum M[i][k] y[k]
    i = np.arange(32)[:, None]
    k = np.arange(64)[None, :]
    M = np.cos(np.pi / 64.0 * (2 * i + 1) * (k - 16))
    # C = D/32 (D = ENWINDOW/2^16, synth.py); calibrated for unit gain
    # through the synthesis bank
    return w / 65536.0 / 32.0, M


_AWIN, _AMAT = None, None

# layer 2 scalefactor table: sf[i] = 2^(1 - i/3), chosen as the smallest
# index with sf >= max|sample| (ISO table 3-B.1)
_SF_TAB = 2.0 ** (1.0 - np.arange(64) / 3.0)


def _analysis(x512_slots: np.ndarray) -> np.ndarray:
    """x512_slots: (n_slots, 512) newest-last sliding windows ->
    (n_slots, 32) subband samples."""
    global _AWIN, _AMAT
    if _AWIN is None:
        _AWIN, _AMAT = _analysis_kernel()
    z = x512_slots[:, ::-1] * _AWIN          # x[0] newest per spec order
    y = z.reshape(z.shape[0], 8, 64).sum(axis=1)
    return y @ _AMAT.T


class _MpaEncBase(Encoder):
    TYPE = MediaType.AUDIO
    FRAME_SAMPLES = 1152

    OPTIONS = Encoder.OPTIONS + [
        Option("bit_rate_kbps", "bitrate in kbps (0 = pick default)",
               "int", 0, 0, 448),
    ]

    def _init(self):
        if self.channels not in (1, 2):
            raise AVError(EINVAL, "mpeg audio: mono/stereo only")
        if self.sample_rate not in (32000, 44100, 48000):
            raise AVError(EINVAL, "mpeg audio encoder: MPEG-1 rates only")
        self.sr_index = T.FREQ_TAB.index(self.sample_rate)
        kbps = self.bit_rate_kbps or (self.bit_rate // 1000 if
                                      self.bit_rate else 0)
        if not kbps:
            kbps = 192 if self.channels == 2 else 128
        tab = T.BITRATE_TAB[0][self._LAYER - 1]
        if kbps not in tab:
            raise AVError(EINVAL, f"unsupported bitrate {kbps}")
        self.bitrate_index = tab.index(kbps)
        self.kbps = kbps
        self._hist = np.zeros((self.channels, 512))
        self._buf = np.zeros((self.channels, 0))
        self._pts = 0

    def _encode(self, frame: Frame) -> List[Packet]:
        from libav_tpu_torch.codecs.ac3.enc import AC3Encoder
        x = AC3Encoder._to_planar(self, frame)
        self._buf = np.concatenate([self._buf, x], axis=1)
        pkts = []
        while self._buf.shape[1] >= self.FRAME_SAMPLES:
            chunk = self._buf[:, :self.FRAME_SAMPLES]
            self._buf = self._buf[:, self.FRAME_SAMPLES:]
            pkts.append(self._encode_frame(chunk, frame))
        return pkts

    def _drain(self) -> List[Packet]:
        if not self._buf.shape[1]:
            return []
        pad = self.FRAME_SAMPLES - self._buf.shape[1]
        chunk = np.pad(self._buf, ((0, 0), (0, pad)))
        self._buf = self._buf[:, :0]
        return [self._encode_frame(chunk, None)]

    def _subbands(self, chunk: np.ndarray) -> np.ndarray:
        """(nch, n_samples) -> (nch, n_slots, 32) via the analysis bank."""
        nch = self.channels
        n_slots = chunk.shape[1] // 32
        out = np.zeros((nch, n_slots, 32))
        for ch in range(nch):
            x = np.concatenate([self._hist[ch], chunk[ch]])
            idx = (512 + 32 * np.arange(n_slots))[:, None] - 512 + \
                np.arange(512)[None, :]
            out[ch] = _analysis(x[idx])
            self._hist[ch] = x[-512:]
        return out

    def _header(self, pb: PutBits, padding=0, mode=None, mode_ext=0):
        pb.put_bits(12, 0xFFF)
        pb.put_bits(1, 1)                   # MPEG-1
        pb.put_bits(2, 4 - self._LAYER)
        pb.put_bits(1, 1)                   # no crc
        pb.put_bits(4, self.bitrate_index)
        pb.put_bits(2, self.sr_index)
        pb.put_bits(1, padding)
        pb.put_bits(1, 0)                   # private
        if mode is None:
            mode = 0 if self.channels == 2 else 3
        pb.put_bits(2, mode)
        pb.put_bits(2, mode_ext)
        pb.put_bits(4, 0)                   # copyright/original/emphasis

    def _finish(self, pb: PutBits, src) -> Packet:
        body = pb.flush()
        frame_size = self.kbps * 1000 * \
            (12 if self._LAYER == 1 else 144) // self.sample_rate * \
            (4 if self._LAYER == 1 else 1)
        if len(body) > frame_size:
            raise AVError(EINVAL,
                          f"mpa frame overflow {len(body)}>{frame_size}")
        data = body + b"\x00" * (frame_size - len(body))
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=self.FRAME_SAMPLES, flags=PKT_FLAG_KEY)
        if src is not None:
            pkt.time_base = src.time_base
        self._pts += self.FRAME_SAMPLES
        return pkt


@register_codec
class Mp2Encoder(_MpaEncBase):
    NAME = "mp2"
    LONG_NAME = "MP2 (MPEG audio layer 2)"
    _LAYER = 2
    FRAME_SAMPLES = 1152

    def _encode_frame(self, chunk, src) -> Packet:
        nch = self.channels
        sb = self._subbands(chunk)            # (nch, 36, 32)
        table = 0 if (self.sample_rate == 48000 and
                      self.kbps // nch >= 56) or \
            (56 <= self.kbps // nch <= 80) else \
            (1 if self.sample_rate != 48000 and self.kbps // nch >= 96
             else (2 if self.sample_rate != 32000 and
                   self.kbps // nch <= 48 else 3))
        sblimit = T.SBLIMIT_TABLE[table]
        at = T.ALLOC_TABLES[table]

        # scale factors: per (ch, sb, third): smallest index covering max
        sf = np.zeros((nch, sblimit, 3), dtype=np.int64)
        for ch in range(nch):
            for i in range(sblimit):
                for k in range(3):
                    mx = np.abs(sb[ch, 12 * k:12 * k + 12, i]).max()
                    idx = np.searchsorted(-_SF_TAB, -mx)
                    sf[ch][i][k] = min(int(idx), 62)

        # fixed allocation: spend the frame budget uniformly from the
        # bottom subband up (greedy rounds), like a crude static psy
        frame_bits = self.kbps * 1000 * 1152 // self.sample_rate
        header_bits = 32
        # alloc index per (ch, sb)
        alloc = np.zeros((nch, sblimit), dtype=np.int64)
        alloc_bits_tab = []
        j = 0
        for i in range(sblimit):
            nb = at[j]
            alloc_bits_tab.append((j, nb, (1 << nb) - 1))
            j += 1 << nb

        def used_bits():
            bits = header_bits
            for ch in range(nch):
                for i in range(sblimit):
                    bits += alloc_bits_tab[i][1]
                    b = alloc[ch][i]
                    if b:
                        bits += 2 + 18          # scale_code + 3 sfs
                        qindex = at[alloc_bits_tab[i][0] + b]
                        qb = T.QUANT_BITS[qindex]
                        inc = -qb * 12 if qb < 0 else qb * 36
                        bits += inc
            return bits

        # greedy: raise allocation where it fits, bottom-up
        improved = True
        while improved:
            improved = False
            for i in range(sblimit):
                for ch in range(nch):
                    b = alloc[ch][i]
                    if b >= alloc_bits_tab[i][2]:
                        continue
                    alloc[ch][i] = b + 1
                    if used_bits() <= frame_bits - 16:
                        improved = True
                    else:
                        alloc[ch][i] = b
        pb = PutBits()
        self._header(pb)
        j = 0
        for i in range(sblimit):
            nb = at[j]
            for ch in range(nch):
                pb.put_bits(nb, int(alloc[ch][i]))
            j += 1 << nb
        for i in range(sblimit):
            for ch in range(nch):
                if alloc[ch][i]:
                    pb.put_bits(2, 0)          # scale_code: all three
        for i in range(sblimit):
            for ch in range(nch):
                if alloc[ch][i]:
                    for k in range(3):
                        pb.put_bits(6, int(sf[ch][i][k]))
        # samples
        for k in range(3):
            for l in range(0, 12, 3):
                j = 0
                for i in range(sblimit):
                    nb = at[j]
                    for ch in range(nch):
                        b = alloc[ch][i]
                        if b:
                            qindex = at[j + b]
                            qbits = T.QUANT_BITS[qindex]
                            steps = T.QUANT_STEPS[qindex]
                            scale = int(sf[ch][i][k])
                            svals = [sb[ch, k * 12 + l + m, i]
                                     for m in range(3)]
                            if qbits < 0:
                                gidx = []
                                for v in svals:
                                    gidx.append(self._qgroup(v, steps,
                                                             scale))
                                code = gidx[0] + steps * \
                                    (gidx[1] + steps * gidx[2])
                                pb.put_bits(-qbits, code)
                            else:
                                for v in svals:
                                    pb.put_bits(qbits, self._qlin(
                                        v, qbits, scale))
                    j += 1 << nb
        return self._finish(pb, src)

    @staticmethod
    def _qgroup(v, steps, scale):
        """invert l2_unscale_group: v = (m - steps//2) * C * 2^(-sf/3)"""
        c = {3: 4.0 / 3.0, 5: 4.0 / 5.0, 9: 4.0 / 9.0}[steps]
        m = int(np.round(v / (c * _SF_TAB[scale] / 2.0) + (steps >> 1)))
        return int(np.clip(m, 0, steps - 1))

    @staticmethod
    def _qlin(v, nbits, scale):
        """invert l1_unscale: v = (m - 2^n + 1)*norm*2*2^(-sf/3)/2^n,
        n = nbits - 1"""
        n = nbits - 1
        norm = float(1 << (n + 1)) / ((1 << (n + 1)) - 1)
        m = int(np.round(v * (1 << n) /
                         (norm * 2.0 * (_SF_TAB[scale] / 2.0)) +
                         (1 << n) - 1))
        return int(np.clip(m, 0, (1 << (n + 1)) - 2))


@register_codec
class Mp3Encoder(_MpaEncBase):
    NAME = "mp3"
    LONG_NAME = "MP3 (MPEG audio layer 3, conformance-stream subset)"
    _LAYER = 3
    FRAME_SAMPLES = 1152

    OPTIONS = _MpaEncBase.OPTIONS + [
        Option("js", "joint (mid/side) stereo", "int", 0, 0, 1),
    ]

    _TABLE_SELECT = 24       # 16x16 with linbits (HUFF_DATA[24])

    def _init(self):
        super()._init()
        self._mdct_overlap = np.zeros((self.channels, 32, 18))
        n = np.arange(36)[:, None]
        k = np.arange(18)[None, :]
        # forward MDCT matrix paired with the decoder's IMDCT (x0.5
        # gives perfect TDAC reconstruction for the sine window chain)
        self._fm = np.cos(np.pi / 72.0 * (2 * n + 1 + 18) *
                          (2 * k + 1)).T
        self._win = np.sin(np.pi / 36.0 * (np.arange(36) + 0.5))

    def _encode_frame(self, chunk, src) -> Packet:
        nch = self.channels
        sb = self._subbands(chunk)            # (nch, 36, 32)
        ms = self.js and nch == 2
        # per granule forward MDCT (1/9 gives perfect TDAC through the
        # decoder's direct-spec IMDCT; calibrated numerically).  Odd
        # subbands are pre-inverted on odd slots because the decoder
        # applies frequency inversion after its IMDCT.
        inv = np.where(np.arange(36) % 2 == 1, -1.0, 1.0)
        spec = np.zeros((nch, 2, 576))
        for ch in range(nch):
            for gr in range(2):
                slots = sb[ch, 18 * gr:18 * gr + 18]   # (18, 32)
                for b in range(32):
                    x = np.concatenate([self._mdct_overlap[ch][b],
                                        slots[:, b]])
                    self._mdct_overlap[ch][b] = slots[:, b]
                    if b & 1:
                        x = x * inv
                    spec[ch][gr][18 * b:18 * b + 18] = \
                        (self._fm @ (x * self._win)) / 9.0

        gg_adjust = 0
        if ms:
            m = (spec[0] + spec[1]) * (0.5 ** 0.5)
            s = (spec[0] - spec[1]) * (0.5 ** 0.5)
            spec = np.stack([m, s])
            gg_adjust = 2     # decoder subtracts 2 when MS-only signalled

        pb = PutBits()
        self._header(pb, mode=(1 if ms else (0 if nch == 2 else 3)),
                     mode_ext=(2 if ms else 0))
        frame_bits = (self.kbps * 1000 * 144 // self.sample_rate) * 8
        side_bits = 256 if nch == 2 else 136
        budget = frame_bits - 32 - side_bits - 16
        per_gran = budget // (2 * nch)

        payload = PutBits()
        sides = []
        for gr in range(2):
            for ch in range(nch):
                bits, gg = self._code_granule(payload, spec[ch][gr],
                                              per_gran)
                sides.append((bits, gg + gg_adjust))
        pb.put_bits(9, 0)                     # main_data_begin
        pb.put_bits(3 if nch == 2 else 5, 0)  # private
        for ch in range(nch):
            pb.put_bits(4, 0)                 # scfsi
        for (bits, gg) in sides:
            pb.put_bits(12, bits)             # part2_3_length
            pb.put_bits(9, 288)               # big_values (all pairs)
            pb.put_bits(8, gg)
            pb.put_bits(4, 0)                 # scalefac_compress
            pb.put_bits(1, 0)                 # blocksplit off
            for _ in range(3):
                pb.put_bits(5, self._TABLE_SELECT)
            pb.put_bits(4, 8)                 # region_address1
            pb.put_bits(3, 7)                 # region_address2
            pb.put_bits(1, 0)                 # preflag
            pb.put_bits(1, 0)                 # scalefac_scale
            pb.put_bits(1, 0)                 # count1table_select
        # main data (byte-aligned after side info by construction)
        for byte in payload.flush():
            pb.put_bits(8, byte)
        return self._finish(pb, src)

    def _code_granule(self, pb: PutBits, xr: np.ndarray, max_bits: int):
        """Quantize + huffman-code one granule; returns (bits, gg)."""
        _, linbits = T.HUFF_DATA[self._TABLE_SELECT]
        vmax = 15 + (1 << linbits) - 1
        xsize, hbits, hcodes = T.HUFF_PAIR[
            T.HUFF_INDEX[T.HUFF_DATA[self._TABLE_SELECT][0]]]
        gg0 = 210 - 30            # moderate precision start
        for gg in range(gg0, 256, 4):
            step = 2.0 ** (-(gg - 210.0) * 3.0 / 16.0)
            ix = np.rint(np.abs(xr) ** 0.75 * step).astype(np.int64)
            if ix.max() > vmax:
                continue
            bits = self._count_bits(ix, hbits, xsize, linbits)
            if bits <= max_bits:
                start = pb.bits_written()
                self._emit(pb, ix, xr, hbits, hcodes, xsize, linbits)
                return pb.bits_written() - start, gg
        raise AVError(EINVAL, "mp3: granule does not fit")

    @staticmethod
    def _count_bits(ix, hbits, xsize, linbits):
        bits = 0
        for i in range(0, 576, 2):
            x, y = int(ix[i]), int(ix[i + 1])
            cx, cy = min(x, 15), min(y, 15)
            bits += hbits[cx * xsize + cy]
            if cx == 15:
                bits += linbits
            if x:
                bits += 1
            if cy == 15:
                bits += linbits
            if y:
                bits += 1
        return bits

    @staticmethod
    def _emit(pb, ix, xr, hbits, hcodes, xsize, linbits):
        for i in range(0, 576, 2):
            x, y = int(ix[i]), int(ix[i + 1])
            cx, cy = min(x, 15), min(y, 15)
            idx = cx * xsize + cy
            pb.put_bits(hbits[idx], hcodes[idx])
            if cx == 15:
                pb.put_bits(linbits, x - 15)
            if x:
                pb.put_bits(1, 1 if xr[i] < 0 else 0)
            if cy == 15:
                pb.put_bits(linbits, y - 15)
            if y:
                pb.put_bits(1, 1 if xr[i + 1] < 0 else 0)


@register_codec
class Mp1Encoder(_MpaEncBase):
    NAME = "mp1"
    LONG_NAME = "MP1 (MPEG audio layer 1)"
    _LAYER = 1
    FRAME_SAMPLES = 384

    def _encode_frame(self, chunk, src) -> Packet:
        nch = self.channels
        sb = self._subbands(chunk)            # (nch, 12, 32)
        frame_bits = self.kbps * 1000 * 384 // self.sample_rate
        # scale factors
        sf = np.zeros((nch, 32), dtype=np.int64)
        for ch in range(nch):
            for i in range(32):
                mx = np.abs(sb[ch, :, i]).max()
                sf[ch][i] = min(int(np.searchsorted(-_SF_TAB, -mx)), 62)
        # uniform allocation fitting the budget: alloc n -> n+1 bits/sample
        alloc = np.zeros((nch, 32), dtype=np.int64)

        def used():
            b = 32 + 4 * 32 * nch
            for ch in range(nch):
                for i in range(32):
                    if alloc[ch][i]:
                        b += 6 + 12 * (alloc[ch][i] + 1)
            return b

        improved = True
        while improved:
            improved = False
            for i in range(32):
                for ch in range(nch):
                    if alloc[ch][i] >= 14:
                        continue
                    alloc[ch][i] += 1
                    if used() <= frame_bits - 16:
                        improved = True
                    else:
                        alloc[ch][i] -= 1
        pb = PutBits()
        self._header(pb)
        for i in range(32):
            for ch in range(nch):
                pb.put_bits(4, int(alloc[ch][i]))
        for i in range(32):
            for ch in range(nch):
                if alloc[ch][i]:
                    pb.put_bits(6, int(sf[ch][i]))
        for j in range(12):
            for i in range(32):
                for ch in range(nch):
                    n = int(alloc[ch][i])
                    if n:
                        pb.put_bits(n + 1, Mp2Encoder._qlin(
                            sb[ch, j, i], n + 1, int(sf[ch][i])))
        return self._finish(pb, src)
