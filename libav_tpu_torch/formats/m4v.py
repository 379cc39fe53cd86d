"""Raw MPEG-4 part 2 elementary stream (.m4v) demuxer/muxer (reference:
libavformat/m4vdec.c / rawenc.c m4v muxer)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

VOP = b"\x00\x00\x01\xB6"


def split_vops(data: bytes):
    """One chunk per VOP, with preceding config headers attached."""
    positions = []
    pos = 0
    while True:
        i = data.find(b"\x00\x00\x01", pos)
        if i < 0 or i + 3 >= len(data):
            break
        positions.append((i, data[i + 3]))
        pos = i + 3
    vop_idx = [k for k, (_, c) in enumerate(positions) if c == 0xB6]
    if not vop_idx:
        if data:
            yield data
        return
    starts = []
    for vi in vop_idx:
        j = vi
        while j > 0 and positions[j - 1][1] != 0xB6:
            j -= 1
        starts.append(positions[j][0])
    starts = sorted(set(starts))
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else len(data)
        yield data[s:e]


@register_input
class M4VDemuxer(InputFormat):
    NAME = "m4v"
    EXTENSIONS = ("m4v",)

    OPTIONS = [
        Option("framerate", "frame rate", "rational", Rational(25, 1)),
    ]

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if data[:4] in (b"\x00\x00\x01\xB0", b"\x00\x00\x01\xB5") or \
                data[:3] == b"\x00\x00\x01" and data[3:4] == b"\x20":
            return 70
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        return 55 if ext in cls.EXTENSIONS else 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg4",
                              pix_fmt="yuv420p")
        fr = self.framerate
        self.streams = [Stream(index=0, codecpar=par, time_base=fr.inv(),
                               avg_frame_rate=fr)]
        self._chunks = list(split_vops(data))
        self._idx = 0
        self._pts, self._dts = self._infer_timestamps(self._chunks)

    @staticmethod
    def _vop_type(chunk: bytes) -> int:
        """vop_coding_type (2 bits after the VOP start code):
        0=I 1=P 2=B 3=S; -1 if no VOP."""
        i = chunk.find(VOP)
        if i < 0 or i + 4 >= len(chunk):
            return -1
        return chunk[i + 4] >> 6

    @classmethod
    def _infer_timestamps(cls, chunks):
        """Reconstruct the display-order pts the reference's demux core
        derives for raw MPEG-4 (compute_pkt_fields, utils.c:641): each
        B-VOP displays at its own decode slot minus the one-anchor
        delay (pts = dts), while an anchor displays just before the
        NEXT anchor decodes; the anchor's dts is the previous anchor's
        pts (the first anchor is backdated one frame by
        update_initial_timestamps).  Streams without B-VOPs have no
        presentation delay: pts = dts = decode index."""
        types = [cls._vop_type(c) for c in chunks]
        n = len(chunks)
        if not any(t == 2 for t in types):
            return list(range(n)), list(range(n))
        pts = [0] * n
        anchors = [k for k, t in enumerate(types) if t in (0, 1, 3, -1)]
        for a_i, k in enumerate(anchors):
            nxt = anchors[a_i + 1] if a_i + 1 < len(anchors) else n
            pts[k] = nxt - 1
        for k, t in enumerate(types):
            if t == 2:
                pts[k] = k - 1
        dts = [0] * n
        prev_anchor_pts = None
        for k, t in enumerate(types):
            if t == 2:
                dts[k] = pts[k]
            else:
                dts[k] = (prev_anchor_pts if prev_anchor_pts is not None
                          else pts[k] - 1)
                prev_anchor_pts = pts[k]
        return pts, dts

    def read_packet(self) -> Packet:
        if self._idx >= len(self._chunks):
            raise AVError(EOF_)
        chunk = self._chunks[self._idx]
        is_key = b"\x00\x00\x01\xB0" in chunk[:64] or \
                 b"\x00\x00\x01\x20" in chunk[:128]
        pkt = Packet(data=chunk, pts=self._pts[self._idx],
                     dts=self._dts[self._idx], duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY if is_key else 0)
        self._idx += 1
        return pkt


@register_output
class M4VMuxer(OutputFormat):
    NAME = "m4v"
    EXTENSIONS = ("m4v",)
    VIDEO_CODEC = "mpeg4"

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
