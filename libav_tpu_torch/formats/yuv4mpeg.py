"""YUV4MPEG2 (.y4m) demuxer/muxer (reference: libavformat/yuv4mpeg.c)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.imgutils import image_get_buffer_size
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

_CS_TO_FMT = {
    b"420jpeg": "yuv420p", b"420mpeg2": "yuv420p", b"420paldv": "yuv420p",
    b"420": "yuv420p", b"422": "yuv422p", b"444": "yuv444p",
    b"mono": "gray", b"411": "yuv411p",
}
_FMT_TO_CS = {"yuv420p": "420mpeg2", "yuvj420p": "420jpeg",
              "yuv422p": "422", "yuvj422p": "422",
              "yuv444p": "444", "yuvj444p": "444",
              "gray": "mono", "yuv411p": "411"}

MAGIC = b"YUV4MPEG2"


@register_input
class Y4MDemuxer(InputFormat):
    NAME = "yuv4mpegpipe,y4m"
    EXTENSIONS = ("y4m",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if data.startswith(MAGIC) else 0

    def read_header(self, pb):
        self.pb = pb
        header = bytearray()
        while True:
            c = pb.read(1)
            if not c or c == b"\n":
                break
            header += c
        if not header.startswith(MAGIC):
            raise AVError(INVALIDDATA, "not a YUV4MPEG2 stream")
        w = h = 0
        fr = Rational(25, 1)
        fmt = "yuv420p"
        sar = Rational(0, 1)
        for tok in bytes(header).split(b" ")[1:]:
            if not tok:
                continue
            t, v = tok[:1], tok[1:]
            if t == b"W":
                w = int(v)
            elif t == b"H":
                h = int(v)
            elif t == b"F":
                n, d = v.split(b":")
                fr = Rational(int(n), int(d))
            elif t == b"C":
                fmt = _CS_TO_FMT.get(v, "yuv420p")
            elif t == b"A":
                n, d = v.split(b":")
                sar = Rational(int(n), int(d))
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="rawvideo",
                              width=w, height=h, pix_fmt=fmt,
                              sample_aspect_ratio=sar)
        self.streams = [Stream(index=0, codecpar=par, time_base=fr.inv(),
                               avg_frame_rate=fr)]
        self._frame_size = image_get_buffer_size(fmt, w, h)
        self._idx = 0

    def read_packet(self) -> Packet:
        line = bytearray()
        while True:
            c = self.pb.read(1)
            if not c:
                raise AVError(EOF_)
            if c == b"\n":
                break
            line += c
        if not line.startswith(b"FRAME"):
            raise AVError(INVALIDDATA, "missing FRAME header")
        data = self.pb.read(self._frame_size)
        if len(data) < self._frame_size:
            raise AVError(EOF_)
        pkt = Packet(data=data, pts=self._idx, dts=self._idx, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY)
        self._idx += 1
        return pkt


@register_output
class Y4MMuxer(OutputFormat):
    NAME = "yuv4mpegpipe,y4m"
    EXTENSIONS = ("y4m",)
    VIDEO_CODEC = "rawvideo"

    def write_header(self, pb):
        self.pb = pb
        st = self.streams[0]
        par = st.codecpar
        fr = st.avg_frame_rate if st.avg_frame_rate else st.time_base.inv()
        cs = _FMT_TO_CS.get(par.pix_fmt, "420mpeg2")
        hdr = f"YUV4MPEG2 W{par.width} H{par.height} F{fr.num}:{fr.den} Ip A0:0 C{cs}\n"
        pb.write(hdr.encode())

    def write_packet(self, pkt: Packet):
        self.pb.write(b"FRAME\n")
        self.pb.write(pkt.data)
