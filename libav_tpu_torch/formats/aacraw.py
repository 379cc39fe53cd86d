"""ADTS AAC elementary stream (.aac) demuxer/muxer (reference:
libavformat/aacdec.c + adtsenc.c)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)


@register_input
class ADTSDemuxer(InputFormat):
    NAME = "aac,adts"
    EXTENSIONS = ("aac", "adts")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if len(data) > 2 and data[0] == 0xFF and (data[1] & 0xF6) == 0xF0:
            return 60
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        return 50 if ext in cls.EXTENSIONS else 0

    def read_header(self, pb):
        from libav_tpu_torch.codecs.aac.dec import parse_adts_header
        self.pb = pb
        self._data = pb.read_all()
        self._pos = 0
        self._pts = 0
        hdr = parse_adts_header(self._data)
        rate, ch = (hdr[0], hdr[1]) if hdr else (44100, 2)
        par = CodecParameters(codec_type=MediaType.AUDIO, codec_id="aac",
                              sample_rate=rate, channels=ch,
                              sample_fmt="fltp", frame_size=1024)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]

    def read_packet(self) -> Packet:
        from libav_tpu_torch.codecs.aac.dec import parse_adts_header
        d = self._data
        while self._pos + 7 < len(d):
            if d[self._pos] == 0xFF and (d[self._pos + 1] & 0xF6) == 0xF0:
                hdr = parse_adts_header(d[self._pos:])
                if hdr:
                    flen = hdr[2]
                    chunk = d[self._pos:self._pos + flen]
                    if len(chunk) < flen:
                        break
                    self._pos += flen
                    pkt = Packet(data=chunk, pts=self._pts, dts=self._pts,
                                 duration=1024, stream_index=0,
                                 flags=PKT_FLAG_KEY)
                    self._pts += 1024
                    return pkt
            self._pos += 1
        raise AVError(EOF_)


@register_output
class ADTSMuxer(OutputFormat):
    NAME = "adts,aac"
    EXTENSIONS = ("aac", "adts")
    AUDIO_CODEC = "aac"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
