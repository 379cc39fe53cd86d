"""FLV container (counterpart of `libav_tpu/formats/flv.py`, copied;
reference: libavformat/flvdec.c / flvenc.c — 'FLV' header, prev-size
framed tags; video codec id 2 = Sorenson H.263, audio format 2 = MP3)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat,
                                         Stream, register_input,
                                         register_output)

_VCODEC = {2: "flv1", 7: "h264"}
_ACODEC = {2: "mp3", 0: "pcm_s16le", 10: "aac"}
_ARATE = (5512, 11025, 22050, 44100)


@register_input
class FlvDemuxer(InputFormat):
    NAME = "flv"
    EXTENSIONS = ("flv",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if data[:3] == b"FLV" else 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        if data[:3] != b"FLV":
            raise AVError(INVALIDDATA, "flv: bad magic")
        off = int.from_bytes(data[5:9], "big")
        self._data = data
        self._pos = off + 4                   # skip PreviousTagSize0
        self._streams_by_type = {}
        self.streams = []
        # scan tags up front: stream set + per-tag index
        self._tags = []
        pos = self._pos
        while pos + 11 <= len(data):
            ttype = data[pos]
            size = int.from_bytes(data[pos + 1:pos + 4], "big")
            ts = int.from_bytes(data[pos + 4:pos + 7], "big") | \
                (data[pos + 7] << 24)
            body = pos + 11
            if body + size > len(data):
                break
            if ttype == 9 and size >= 1:      # video
                codec = data[body] & 0x0F
                key = (data[body] >> 4) == 1
                cid = _VCODEC.get(codec)
                if cid and "v" not in self._streams_by_type:
                    par = CodecParameters(codec_type=MediaType.VIDEO,
                                          codec_id=cid,
                                          pix_fmt="yuv420p")
                    st = Stream(index=len(self.streams), codecpar=par,
                                time_base=Rational(1, 1000))
                    self._streams_by_type["v"] = st.index
                    self.streams.append(st)
                if cid:
                    self._tags.append((self._streams_by_type["v"], ts,
                                       body + 1, size - 1, key))
            elif ttype == 8 and size >= 1:    # audio
                fmt = data[body] >> 4
                cid = _ACODEC.get(fmt)
                if cid and "a" not in self._streams_by_type:
                    rate = _ARATE[(data[body] >> 2) & 3]
                    ch = (data[body] & 1) + 1
                    par = CodecParameters(codec_type=MediaType.AUDIO,
                                          codec_id=cid,
                                          sample_rate=rate, channels=ch,
                                          sample_fmt="fltp")
                    st = Stream(index=len(self.streams), codecpar=par,
                                time_base=Rational(1, 1000))
                    self._streams_by_type["a"] = st.index
                    self.streams.append(st)
                if cid:
                    self._tags.append((self._streams_by_type["a"], ts,
                                       body + 1, size - 1, True))
            pos = body + size + 4             # + PreviousTagSize
        self._idx = 0

    def read_packet(self) -> Packet:
        if self._idx >= len(self._tags):
            raise AVError(EOF_)
        sidx, ts, off, size, key = self._tags[self._idx]
        self._idx += 1
        return Packet(data=self._data[off:off + size], pts=ts, dts=ts,
                      duration=0, stream_index=sidx,
                      flags=PKT_FLAG_KEY if key else 0)


@register_output
class FlvMuxer(OutputFormat):
    NAME = "flv"
    EXTENSIONS = ("flv",)
    VIDEO_CODEC = "flv1"
    AUDIO_CODEC = "mp3"

    def write_header(self, pb):
        self.pb = pb
        has_v = any(s.codecpar.codec_type == MediaType.VIDEO
                    for s in self.streams)
        has_a = any(s.codecpar.codec_type == MediaType.AUDIO
                    for s in self.streams)
        flags = (1 if has_v else 0) | (4 if has_a else 0)
        pb.write(b"FLV\x01" + bytes([flags]) +
                 (9).to_bytes(4, "big") + (0).to_bytes(4, "big"))

    def _tag(self, ttype: int, ts: int, body: bytes):
        hdr = bytes([ttype]) + len(body).to_bytes(3, "big") + \
            (ts & 0xFFFFFF).to_bytes(3, "big") + \
            bytes([(ts >> 24) & 0xFF]) + (0).to_bytes(3, "big")
        self.pb.write(hdr + body + (11 + len(body)).to_bytes(4, "big"))

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        tb = pkt.time_base or st.time_base
        ts = pkt.pts if pkt.pts is not None else (pkt.dts or 0)
        if tb and tb.den:
            ts = int(ts * 1000 * tb.num / tb.den)
        if st.codecpar.codec_type == MediaType.VIDEO:
            ft = 1 if pkt.is_key else 2
            self._tag(9, ts, bytes([(ft << 4) | 2]) + bytes(pkt.data))
        else:
            rate_idx = min(range(4),
                           key=lambda i: abs(_ARATE[i] -
                                             st.codecpar.sample_rate))
            b0 = (2 << 4) | (rate_idx << 2) | 0x02 | \
                (1 if st.codecpar.channels > 1 else 0)
            self._tag(8, ts, bytes([b0]) + bytes(pkt.data))
