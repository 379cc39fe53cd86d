"""WAV demuxer/muxer (reference: libavformat/wavdec.c / wavenc.c, RIFF
helpers riff.c)."""

from __future__ import annotations

import struct

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

_TAG_TO_CODEC = {1: None, 3: None, 0x2000: "ac3", 0x55: "mp3",
                 0x50: "mp2", 0xFF: "aac"}
_PCM_FMT = {(1, 8): ("pcm_u8", "u8"), (1, 16): ("pcm_s16le", "s16"),
            (1, 24): ("pcm_s24le", "s32"), (1, 32): ("pcm_s32le", "s32"),
            (3, 32): ("pcm_f32le", "flt"), (3, 64): ("pcm_f64le", "dbl")}


@register_input
class WavDemuxer(InputFormat):
    NAME = "wav"
    EXTENSIONS = ("wav",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
            return 100
        return 0

    def read_header(self, pb):
        self.pb = pb
        if pb.read(4) != b"RIFF":
            raise AVError(INVALIDDATA, "no RIFF header")
        pb.read(4)
        if pb.read(4) != b"WAVE":
            raise AVError(INVALIDDATA, "no WAVE header")
        codec_id = None
        fmt = "s16"
        ch = rate = 1
        block_align = 0
        bits = 16
        self._data_left = 0
        while True:
            hdr = pb.read(8)
            if len(hdr) < 8:
                raise AVError(INVALIDDATA, "no data chunk")
            tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if tag == b"fmt ":
                body = pb.read(size)
                wtag, ch, rate, _, block_align, bits = struct.unpack(
                    "<HHIIHH", body[:16])
                if wtag in (1, 3):
                    codec_id, fmt = _PCM_FMT.get((wtag, bits), ("pcm_s16le", "s16"))
                else:
                    codec_id = _TAG_TO_CODEC.get(wtag, f"wtag{wtag}")
            elif tag == b"data":
                self._data_left = size
                break
            else:
                pb.read(size + (size & 1))
        par = CodecParameters(codec_type=MediaType.AUDIO, codec_id=codec_id,
                              sample_fmt=fmt, sample_rate=rate, channels=ch,
                              block_align=block_align or ch * bits // 8)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]
        self._pts = 0
        self._bps = par.block_align

    def read_packet(self) -> Packet:
        if self._data_left <= 0:
            raise AVError(EOF_)
        n = min(self._data_left, 4096 * self._bps)
        data = self.pb.read(n)
        if not data:
            raise AVError(EOF_)
        self._data_left -= len(data)
        nsamples = len(data) // self._bps
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=nsamples, stream_index=0, flags=PKT_FLAG_KEY)
        self._pts += nsamples
        return pkt


@register_output
class WavMuxer(OutputFormat):
    NAME = "wav"
    EXTENSIONS = ("wav",)
    AUDIO_CODEC = "pcm_s16le"

    _FMT = {"pcm_u8": (1, 8), "pcm_s16le": (1, 16), "pcm_s32le": (1, 32),
            "pcm_f32le": (3, 32), "pcm_f64le": (3, 64)}

    def write_header(self, pb):
        self.pb = pb
        par = self.streams[0].codecpar
        wtag, bits = self._FMT.get(par.codec_id, (1, 16))
        ch, rate = par.channels, par.sample_rate
        ba = ch * bits // 8
        pb.write(b"RIFF\x00\x00\x00\x00WAVE")
        pb.write(b"fmt " + struct.pack("<IHHIIHH", 16, wtag, ch, rate,
                                       rate * ba, ba, bits))
        pb.write(b"data\x00\x00\x00\x00")
        self._data_start = pb.tell() if pb.seekable else -1
        self._written = 0

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
        self._written += len(pkt.data)

    def write_trailer(self):
        if getattr(self, "_data_start", -1) >= 0 and self.pb.seekable:
            end = self.pb.tell()
            self.pb.seek(4)
            self.pb.write(struct.pack("<I", end - 8))
            self.pb.seek(self._data_start - 4)
            self.pb.write(struct.pack("<I", self._written))
            self.pb.seek(end)
