"""Raw H.263 elementary stream (.h263) demuxer/muxer (counterpart of
`libav_tpu/formats/h263raw.py`, copied; reference:
libavformat/h263dec.c probe + rawdec.c; frames split on the 22-bit
picture start code 0000 0000 0000 0000 1 00000)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat,
                                         Stream, register_input,
                                         register_output)


def _psc_positions(data: bytes):
    """Byte-aligned picture start codes: 00 00 8x (top 22 bits 0x20)."""
    pos = 0
    out = []
    while True:
        i = data.find(b"\x00\x00", pos)
        if i < 0 or i + 2 >= len(data):
            return out
        if (data[i + 2] & 0xFC) == 0x80:
            out.append(i)
            pos = i + 3
        else:
            pos = i + 1


@register_input
class H263Demuxer(InputFormat):
    NAME = "h263"
    EXTENSIONS = ("h263", "263")

    OPTIONS = [
        Option("framerate", "frame rate", "rational",
               Rational(30000, 1001)),
    ]

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        ps = _psc_positions(data[:2048])
        if ps and ps[0] == 0:
            return 55
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        return 50 if ext in cls.EXTENSIONS and ps else 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="h263", pix_fmt="yuv420p")
        fr = self.framerate
        self.streams = [Stream(index=0, codecpar=par, time_base=fr.inv(),
                               avg_frame_rate=fr)]
        starts = _psc_positions(data)
        self._chunks = [data[s:starts[k + 1] if k + 1 < len(starts)
                             else len(data)]
                        for k, s in enumerate(starts)]
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._chunks):
            raise AVError(EOF_)
        chunk = self._chunks[self._idx]
        # I picture: PTYPE bit 9 after TR... cheap check: bit 12 of the
        # 4th/5th byte region — mark all as key-capable; the decoder
        # sets the real type
        pkt = Packet(data=chunk, pts=self._idx, dts=self._idx,
                     duration=1, stream_index=0, flags=PKT_FLAG_KEY)
        self._idx += 1
        return pkt


@register_output
class H263Muxer(OutputFormat):
    NAME = "h263"
    EXTENSIONS = ("h263", "263")
    VIDEO_CODEC = "h263"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
