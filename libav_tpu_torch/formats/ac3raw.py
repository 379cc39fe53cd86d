"""Raw AC-3 / E-AC-3 elementary stream (.ac3/.eac3) demuxer/muxer
(reference: libavformat/ac3dec.c raw demuxer + rawenc.c; frame sizing
via ac3_parser.c ff_ac3_parse_header for both bsid ranges)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.ac3.eac3 import parse_frame_info
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)


@register_input
class AC3Demuxer(InputFormat):
    NAME = "ac3"
    EXTENSIONS = ("ac3", "eac3", "ec3")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if data[:2] == b"\x0b\x77" and parse_frame_info(data):
            return 75
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        return 50 if ext in cls.EXTENSIONS else 0

    def read_header(self, pb):
        self.pb = pb
        self._data = pb.read_all()
        self._pos = 0
        self._pts = 0
        # peek first frame header for stream parameters
        i = self._data.find(b"\x0b\x77")
        rate, ch, fsz, codec = 48000, 2, 1536, "ac3"
        while i >= 0:
            hdr = parse_frame_info(self._data, i)
            if hdr:
                rate, ch = hdr["sample_rate"], hdr["channels"]
                fsz = 256 * hdr["num_blocks"]
                codec = "eac3" if hdr["eac3"] else "ac3"
                break
            i = self._data.find(b"\x0b\x77", i + 2)
        par = CodecParameters(codec_type=MediaType.AUDIO, codec_id=codec,
                              sample_rate=rate, channels=ch,
                              sample_fmt="fltp", frame_size=fsz)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]

    def read_packet(self) -> Packet:
        pos = self._pos
        while True:
            i = self._data.find(b"\x0b\x77", pos)
            if i < 0 or i + 8 > len(self._data):
                raise AVError(EOF_)
            hdr = parse_frame_info(self._data, i)
            if hdr is None:
                pos = i + 2
                continue
            size = hdr["frame_bytes"]
            chunk = self._data[i:i + size]
            if len(chunk) < size:
                raise AVError(EOF_)
            self._pos = i + size
            dur = 256 * hdr["num_blocks"]
            pkt = Packet(data=chunk, pts=self._pts, dts=self._pts,
                         duration=dur, stream_index=0, flags=PKT_FLAG_KEY)
            self._pts += dur
            return pkt


@register_output
class AC3Muxer(OutputFormat):
    NAME = "ac3"
    EXTENSIONS = ("ac3",)
    AUDIO_CODEC = "ac3"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)


@register_output
class EAC3Muxer(OutputFormat):
    NAME = "eac3"
    EXTENSIONS = ("eac3", "ec3")
    AUDIO_CODEC = "eac3"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
