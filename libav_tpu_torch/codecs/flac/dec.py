"""FLAC decoder (reference: libavcodec/flacdec.c — frame header parse
decode_frame_header, subframe dispatch decode_subframe, rice residual
decode_residuals, fixed/LPC reconstruction flacdsp.c).

Host: bitstream (rice/unary are serially dependent); the LPC/fixed
integer IIR reconstruction is exact int64 numpy (a lax.scan device
variant is not worth the transfer for audio-rate data).  Lossless: the
output must be bit-identical to any conforming decoder, which the FATE
cross tests assert against the reference binary.

Counterpart of `libav_tpu/codecs/flac/dec.py`, copied: all of it runs on
the host in both packages. The decoder takes a device like every decoder
of the port.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec

BLOCK_SIZES = [0, 192, 576, 1152, 2304, 4608, 0, 0,
               256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
SAMPLE_RATES = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                32000, 44100, 48000, 96000, 0, 0, 0, 0]

# fixed predictor coefficients per order (flacdsp: s[i] = r[i] +
# k-th order finite difference of previous outputs)
FIXED_COEFS = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


def crc8(data: bytes) -> int:
    """poly x^8+x^2+x+1 (reference av_crc AV_CRC_8_ATM)."""
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def crc16(data: bytes) -> int:
    """poly x^16+x^15+x^2+1 (AV_CRC_16_ANSI, big-endian feed)."""
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                else (c << 1) & 0xFFFF
    return c


def _utf8_num(gb: GetBits) -> int:
    """FLAC's UTF-8-style coded frame/sample number."""
    b0 = gb.get_bits(8)
    if b0 < 0x80:
        return b0
    n = 0
    while b0 & (0x40 >> n):
        n += 1
    val = b0 & (0x3F >> n)
    for _ in range(n):
        val = (val << 6) | (gb.get_bits(8) & 0x3F)
    return val


def _rice_residual(gb: GetBits, n: int, pred_order: int) -> np.ndarray:
    """reference: flacdec.c decode_residuals — partitioned rice."""
    method = gb.get_bits(2)
    if method > 1:
        raise AVError(INVALIDDATA, "flac: bad residual method")
    plen = 4 + method
    porder = gb.get_bits(4)
    parts = 1 << porder
    if n % parts:
        raise AVError(INVALIDDATA, "flac: bad partition order")
    psize = n >> porder
    out = np.zeros(n, np.int64)
    idx = pred_order
    for p in range(parts):
        cnt = psize - (pred_order if p == 0 else 0)
        k = gb.get_bits(plen)
        if k == (1 << plen) - 1:            # escape: raw bits
            bits = gb.get_bits(5)
            for _ in range(cnt):
                out[idx] = gb.get_sbits(bits) if bits else 0
                idx += 1
            continue
        for _ in range(cnt):
            q = 0
            while not gb.get_bits(1):
                q += 1
            v = (q << k) | (gb.get_bits(k) if k else 0)
            out[idx] = (v >> 1) ^ -(v & 1)  # zigzag
            idx += 1
    return out


def _lpc_recon(sig: np.ndarray, coefs, shift: int, order: int):
    """Exact integer IIR (flacdsp.c lpc_ functions)."""
    c = np.asarray(coefs, np.int64)
    for i in range(order, len(sig)):
        acc = int(np.dot(c, sig[i - 1::-1][:order]))
        sig[i] += acc >> shift
    return sig


@register_codec
class FLACDecoder(Decoder):
    NAME = "flac"
    TYPE = MediaType.AUDIO
    LONG_NAME = "FLAC (Free Lossless Audio Codec)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """FLACDecoder(params, options, device=...): the decode runs on the
        host; the device is taken like every decoder of the port's."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._buf = b""
        self._streaminfo_parsed = False
        self._bps = 16
        self._next_pts = 0

    def _parse_streaminfo(self, data: bytes):
        gb = GetBits(data)
        gb.skip_bits(16 + 16 + 24 + 24)
        self.sample_rate = gb.get_bits(20)
        self.channels = gb.get_bits(3) + 1
        self._bps = gb.get_bits(5) + 1
        if self._bps not in (16,):
            raise AVError(INVALIDDATA,
                          f"flac: only 16-bit supported ({self._bps})")
        self._streaminfo_parsed = True

    def _decode(self, pkt: Packet) -> List[Frame]:
        self._buf += bytes(pkt.data)
        return self._drain_frames(final=False)

    def _drain(self):
        return self._drain_frames(final=True)

    def _drain_frames(self, final: bool) -> List[Frame]:
        out = []
        while True:
            buf = self._buf
            if buf.startswith(b"fLaC"):
                # metadata blocks (reference flacdec parse via demuxer)
                pos = 4
                last = False
                while not last and pos + 4 <= len(buf):
                    hdr = buf[pos]
                    last = bool(hdr & 0x80)
                    btype = hdr & 0x7F
                    size = int.from_bytes(buf[pos + 1:pos + 4], "big")
                    if pos + 4 + size > len(buf):
                        return out       # wait for more data
                    if btype == 0:
                        self._parse_streaminfo(buf[pos + 4:pos + 4 + size])
                    pos += 4 + size
                if not last:
                    return out
                self._buf = buf[pos:]
                continue
            if not self._streaminfo_parsed and self.extradata:
                ed = self.extradata
                if ed.startswith(b"fLaC"):
                    ed = ed[8:]
                self._parse_streaminfo(ed)
            if len(buf) < 16:
                return out
            try:
                frame, consumed = self._decode_one(buf)
            except AVError as e:
                if e.code == INVALIDDATA and not final and \
                        len(buf) < (1 << 20):
                    return out           # probably a truncated frame
                if final:
                    return out
                raise
            if frame is None:
                return out
            self._buf = buf[consumed:]
            out.append(frame)

    def _decode_one(self, buf: bytes):
        gb = GetBits(buf)
        if gb.get_bits(14) != 0x3FFE:
            raise AVError(INVALIDDATA, "flac: lost sync")
        gb.skip_bits(1)                       # reserved
        gb.get_bits(1)                        # blocking strategy
        bs_code = gb.get_bits(4)
        sr_code = gb.get_bits(4)
        chmode = gb.get_bits(4)
        bps_code = gb.get_bits(3)
        gb.skip_bits(1)
        _num = _utf8_num(gb)
        if bs_code == 6:
            blocksize = gb.get_bits(8) + 1
        elif bs_code == 7:
            blocksize = gb.get_bits(16) + 1
        else:
            blocksize = BLOCK_SIZES[bs_code]
        if sr_code == 12:
            gb.get_bits(8)
        elif sr_code in (13, 14):
            gb.get_bits(16)
        hdr_end = (gb.pos + 7) >> 3
        if crc8(buf[:hdr_end]) != gb.get_bits(8):
            raise AVError(INVALIDDATA, "flac: header crc mismatch")
        if blocksize <= 0:
            raise AVError(INVALIDDATA, "flac: bad blocksize")

        bps = {0: self._bps, 1: 8, 2: 12, 4: 16, 5: 20,
       6: 24}.get(bps_code, self._bps)
        if chmode <= 7:
            nch = chmode + 1
            modes = [0] * nch
        else:
            nch = 2
            modes = {8: "ls", 9: "rs", 10: "ms"}[chmode]
        chans = []
        for ch in range(nch if chmode <= 7 else 2):
            cbps = bps
            # side channel carries one extra bit (flacdec.c:472)
            if chmode == 8 and ch == 1 or \
                    chmode == 9 and ch == 0 or \
                    chmode == 10 and ch == 1:
                cbps += 1
            chans.append(self._subframe(gb, blocksize, cbps))
        gb.align()
        gb.get_bits(16)                       # frame crc16
        consumed = gb.pos >> 3

        if chmode == 8:                       # left/side
            l = chans[0]
            r = l - chans[1]
            pcm = [l, r]
        elif chmode == 9:                     # side/right
            r = chans[1]
            l = chans[0] + r
            pcm = [l, r]
        elif chmode == 10:                    # mid/side
            s = chans[1]
            m = (chans[0] << 1) | (s & 1)
            pcm = [(m + s) >> 1, (m - s) >> 1]
        else:
            pcm = chans
        # packed s16 layout: one interleaved plane (codec convention
        # shared with the pcm codecs)
        data = np.stack(pcm, axis=-1).ravel().astype(np.int16)
        f = Frame(format="s16", nb_samples=blocksize,
                  sample_rate=self.sample_rate or 44100,
                  channels=len(pcm), pts=self._next_pts)
        self._next_pts += blocksize
        f.planes = [data]
        return f, consumed

    def _subframe(self, gb: GetBits, n: int, bps: int) -> np.ndarray:
        if gb.get_bits(1):
            raise AVError(INVALIDDATA, "flac: subframe padding bit")
        stype = gb.get_bits(6)
        wasted = 0
        if gb.get_bits(1):                    # wasted bits
            wasted = 1
            while not gb.get_bits(1):
                wasted += 1
            bps -= wasted
        if stype == 0:                        # CONSTANT
            v = gb.get_sbits(bps)
            sig = np.full(n, v, np.int64)
        elif stype == 1:                      # VERBATIM
            sig = np.array([gb.get_sbits(bps) for _ in range(n)],
                           np.int64)
        elif 8 <= stype <= 12:                # FIXED order 0-4
            order = stype & 7
            sig = np.zeros(n, np.int64)
            for i in range(order):
                sig[i] = gb.get_sbits(bps)
            sig += _rice_residual(gb, n, order)
            if order:
                sig = _lpc_recon(sig, FIXED_COEFS[order], 0, order)
        elif stype >= 32:                     # LPC
            order = (stype & 31) + 1
            sig = np.zeros(n, np.int64)
            for i in range(order):
                sig[i] = gb.get_sbits(bps)
            prec = gb.get_bits(4) + 1
            if prec == 16:
                raise AVError(INVALIDDATA, "flac: bad qlp precision")
            shift = gb.get_sbits(5)
            if shift < 0:
                raise AVError(INVALIDDATA, "flac: negative lpc shift")
            coefs = [gb.get_sbits(prec) for _ in range(order)]
            sig += _rice_residual(gb, n, order)
            sig = _lpc_recon(sig, coefs, shift, order)
        else:
            raise AVError(INVALIDDATA, f"flac: subframe type {stype}")
        if wasted:
            sig <<= wasted
        return sig
