"""Raw MPEG audio elementary stream (.mp3/.mp2/.mp1) demuxer/muxer
(reference: libavformat/mp3dec.c + mp3enc.c minus ID3/Xing tags; frame
sizing via mpegaudiodecheader.c avpriv_mpegaudio_decode_header)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.mpegaudio.dec import parse_header
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

_CODEC_BY_LAYER = {1: "mp1", 2: "mp2", 3: "mp3"}


def _hdr_at(data: bytes, i: int):
    if i + 4 > len(data):
        return None
    return parse_header(int.from_bytes(data[i:i + 4], "big"))


def _find_frame(data: bytes, pos: int):
    """Next position with a header followed by a consistent next header
    (mp3dec.c mp3_read_probe resync rule, simplified)."""
    while pos + 4 <= len(data):
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            hdr = _hdr_at(data, pos)
            if hdr is not None:
                nxt = pos + hdr["frame_size"]
                if nxt + 4 > len(data) or _hdr_at(data, nxt) is not None:
                    return pos, hdr
        pos += 1
    return -1, None


def _skip_id3(data: bytes) -> int:
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) | \
            ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        return 10 + size
    return 0


@register_input
class Mp3Demuxer(InputFormat):
    NAME = "mp3"
    EXTENSIONS = ("mp3", "mp2", "mp1", "mpa")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if data[:3] == b"ID3":
            return 80
        pos, hdr = _find_frame(data[:4096], 0)
        if pos == 0 and hdr is not None:
            return 60
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        if ext in cls.EXTENSIONS and hdr is not None:
            return 50
        return 0

    def read_header(self, pb):
        self.pb = pb
        self._data = pb.read_all()
        self._pos = _skip_id3(self._data)
        self._pts = 0
        pos, hdr = _find_frame(self._data, self._pos)
        if hdr is None:
            raise AVError(EOF_, "no mpeg audio frame found")
        par = CodecParameters(
            codec_type=MediaType.AUDIO,
            codec_id=_CODEC_BY_LAYER[hdr["layer"]],
            sample_rate=hdr["sample_rate"], channels=hdr["channels"],
            sample_fmt="fltp", frame_size=hdr["samples"],
            bit_rate=hdr["bit_rate"])
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, hdr["sample_rate"]))]

    def read_packet(self) -> Packet:
        pos, hdr = _find_frame(self._data, self._pos)
        if hdr is None:
            raise AVError(EOF_)
        size = hdr["frame_size"]
        chunk = self._data[pos:pos + size]
        if len(chunk) < size:
            raise AVError(EOF_)
        self._pos = pos + size
        pkt = Packet(data=chunk, pts=self._pts, dts=self._pts,
                     duration=hdr["samples"], stream_index=0,
                     flags=PKT_FLAG_KEY)
        self._pts += hdr["samples"]
        return pkt


@register_output
class Mp3Muxer(OutputFormat):
    NAME = "mp3"
    EXTENSIONS = ("mp3",)
    AUDIO_CODEC = "mp3"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)


@register_output
class Mp2Muxer(OutputFormat):
    NAME = "mp2"
    EXTENSIONS = ("mp2", "mpa", "m2a")
    AUDIO_CODEC = "mp2"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
