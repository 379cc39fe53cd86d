"""FLAC encoder (reference: libavcodec/flacenc.c — frame/subframe
writers write_frame_header/write_subframes, rice parameter search
find_optimal_param; flacdsp fixed predictors).

Emits fixed-order predictors (the order minimizing the residual sum,
flacenc.c guess semantics) with one rice partition per subframe and
independent channels — a compact, fully conforming subset; the FATE
cross test decodes it with the reference binary and asserts the PCM is
bit-identical to the input."""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.flac.dec import FIXED_COEFS, crc8, crc16

BLOCK = 4096


def _utf8_put(pb: PutBits, val: int):
    if val < 0x80:
        pb.put_bits(8, val)
        return
    tmp = []
    n = 1
    v = val
    while True:
        tmp.append(0x80 | (v & 0x3F))
        v >>= 6
        n += 1
        if v < (1 << (7 - n)) or n == 7:
            break
    pb.put_bits(8, (0xFF00 >> n) & 0xFF | v)
    for b in reversed(tmp):
        pb.put_bits(8, b)


def _rice_write(pb: PutBits, res: np.ndarray, k: int):
    for r in res:
        v = (int(r) << 1) ^ (int(r) >> 63)    # zigzag
        q = v >> k
        pb.put_bits(q + 1, 1)                 # q zeros + stop 1
        if k:
            pb.put_bits(k, v & ((1 << k) - 1))


def _best_k(res: np.ndarray) -> int:
    s = int(np.abs(res).sum())
    n = max(1, len(res))
    k = 0
    while (n << (k + 1)) < s and k < 14:
        k += 1
    return k


@register_codec
class FLACEncoder(Encoder):
    NAME = "flac"
    TYPE = MediaType.AUDIO
    LONG_NAME = "FLAC (fixed predictors)"
    SAMPLE_FMTS = ("s16",)

    OPTIONS = Encoder.OPTIONS + [
        Option("frame_size", "samples per frame", "int", BLOCK, 192,
               32768),
    ]

    def _init(self):
        if self.params.sample_fmt not in ("s16", ""):
            raise AVError(EINVAL, "flac: s16 input only")
        self._fifo = np.zeros((self.params.channels or 2, 0), np.int16)
        self._frame_idx = 0
        self._md5 = hashlib.md5()
        self._nsamples = 0
        self.frame_size_out = self.frame_size
        self.params.frame_size = self.frame_size

    def _streaminfo(self) -> bytes:
        pb = PutBits()
        bs = self.frame_size
        pb.put_bits(16, bs)
        pb.put_bits(16, bs)
        pb.put_bits(24, 0)
        pb.put_bits(24, 0)
        pb.put_bits(20, self.params.sample_rate)
        pb.put_bits(3, (self.params.channels or 2) - 1)
        pb.put_bits(5, 15)                    # bps-1 = 16-bit
        total = self._nsamples
        pb.put_bits(4, (total >> 32) & 0xF)
        pb.put_bits(32, total & 0xFFFFFFFF)
        digest = self._md5.digest()
        for b in digest:
            pb.put_bits(8, b)
        return pb.flush()

    def header_bytes(self) -> bytes:
        return b"fLaC" + bytes([0x80]) + \
            len(self._streaminfo()).to_bytes(3, "big") + \
            self._streaminfo()

    def _encode(self, frame: Frame) -> List[Packet]:
        pcm = np.asarray(frame.planes[0]).astype(np.int16)
        if pcm.ndim == 1:
            # packed interleaved plane -> (ch, n)
            ch = max(self.params.channels or 1, 1)
            pcm = np.ascontiguousarray(pcm.reshape(-1, ch).T)
        self._md5.update(np.ascontiguousarray(
            pcm.T.astype("<i2")).tobytes())
        self._nsamples += pcm.shape[1]
        self._fifo = np.concatenate([self._fifo[:pcm.shape[0]], pcm],
                                    axis=1) if self._fifo.size else pcm
        out = []
        while self._fifo.shape[1] >= self.frame_size:
            blk = self._fifo[:, :self.frame_size]
            self._fifo = self._fifo[:, self.frame_size:]
            out.append(self._frame(blk))
        return out

    def _drain(self) -> List[Packet]:
        if self._fifo.shape[1] == 0:
            return []
        blk, self._fifo = self._fifo, self._fifo[:, :0]
        return [self._frame(blk)]

    def _frame(self, blk: np.ndarray) -> Packet:
        n = blk.shape[1]
        pb = PutBits()
        pb.put_bits(14, 0x3FFE)
        pb.put_bits(1, 0)
        pb.put_bits(1, 0)                     # fixed blocksize strategy
        pb.put_bits(4, 7)                     # 16-bit blocksize-1 field
        sr_codes = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                    22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                    96000: 11}
        pb.put_bits(4, sr_codes.get(self.params.sample_rate, 0))
        pb.put_bits(4, blk.shape[0] - 1)      # independent channels
        pb.put_bits(3, 4)                     # 16 bps
        pb.put_bits(1, 0)
        _utf8_put(pb, self._frame_idx)
        pb.put_bits(16, n - 1)
        assert pb._nbits == 0        # header is byte-aligned here
        pb.put_bits(8, crc8(bytes(pb._buf)))
        for ch in range(blk.shape[0]):
            self._subframe(pb, blk[ch].astype(np.int64), n)
        pb.align(0)
        body = pb.flush()
        pb2 = PutBits()
        for b in body:
            pb2.put_bits(8, b)
        pb2.put_bits(16, crc16(body))
        data = pb2.flush()
        pkt = Packet(data=data, pts=self._frame_idx * self.frame_size,
                     duration=n, flags=PKT_FLAG_KEY)
        self._frame_idx += 1
        return pkt

    def _subframe(self, pb: PutBits, sig: np.ndarray, n: int):
        if np.all(sig == sig[0]):
            pb.put_bits(1, 0)
            pb.put_bits(6, 0)                 # CONSTANT
            pb.put_bits(1, 0)
            pb.put_sbits(16, int(sig[0]))
            return
        # pick the fixed order with the smallest residual magnitude
        # (flacenc.c guess_fixed semantics)
        best, bestres = 0, None
        cur = sig
        score_prev = None
        for order in range(0, min(5, n)):
            res = cur if order == 0 else None
            if order:
                cur = cur[1:] - cur[:-1]      # finite difference
                res = cur
            score = int(np.abs(res[order:] if order == 0 else res)
                        .sum())
            if score_prev is None or score < score_prev:
                score_prev = score
                best = order
                bestres = res
        order = best
        # residual in coding order: r[i] = sig[i] - pred
        resid = sig.copy()
        for _ in range(order):
            resid = np.concatenate([[0], resid[1:] - resid[:-1]])
        res = resid[order:]
        pb.put_bits(1, 0)
        pb.put_bits(6, 8 | order)             # FIXED
        pb.put_bits(1, 0)                     # no wasted bits
        for i in range(order):
            pb.put_sbits(16, int(sig[i]))
        pb.put_bits(2, 0)                     # rice method 4-bit
        pb.put_bits(4, 0)                     # partition order 0
        k = _best_k(res)
        pb.put_bits(4, k)
        _rice_write(pb, res, k)
