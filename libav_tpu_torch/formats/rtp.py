"""RTP packetization/depacketization + SDP (reference:
libavformat/rtpenc.c / rtpdec.c, rtpenc_h264_hevc.c nal_send,
rtpdec_h264.c (single NAL / STAP-A / FU-A), RFC 2250 MPEG video
(rtpenc_mpv / rtpdec_mpeg12), MPEG-TS payload 33, sdp.c av_sdp_create.

The RTP clock is 90 kHz for video; the marker bit closes an access
unit.  Depacketizers reassemble per-timestamp access units and detect
sequence gaps (dropped datagrams raise INVALIDDATA rather than
emitting torn frames)."""

from __future__ import annotations

import socket
from typing import Dict, List, Optional
from urllib.parse import urlparse, parse_qs

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA, EINVAL
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)
from libav_tpu_torch.formats.io import IOContext

RTP_VERSION = 2
RTP_PT_MPV = 32      # RFC 2250 MPEG-1/2 video elementary stream
RTP_PT_TS = 33       # RFC 2250 MPEG-2 transport stream
RTP_PT_DYNAMIC = 96  # first dynamic payload type (h264 etc.)
VIDEO_CLOCK = 90000


def build_rtp(pt: int, seq: int, ts: int, ssrc: int, payload: bytes,
              marker: bool = False) -> bytes:
    hdr = bytes([RTP_VERSION << 6,
                 (0x80 if marker else 0) | (pt & 0x7F)])
    return (hdr + (seq & 0xFFFF).to_bytes(2, "big")
            + (ts & 0xFFFFFFFF).to_bytes(4, "big")
            + (ssrc & 0xFFFFFFFF).to_bytes(4, "big") + payload)


def parse_rtp(data: bytes):
    """Returns (pt, seq, ts, ssrc, marker, payload) or None for
    non-RTP/RTCP datagrams."""
    if len(data) < 12 or (data[0] >> 6) != RTP_VERSION:
        return None
    pt = data[1] & 0x7F
    if 72 <= pt <= 76:          # RTCP range (rtpdec.c rtcp check)
        return None
    cc = data[0] & 0x0F
    off = 12 + cc * 4
    if data[0] & 0x10:          # extension header
        if len(data) < off + 4:
            return None
        ext_len = int.from_bytes(data[off + 2:off + 4], "big")
        off += 4 + ext_len * 4
    payload = data[off:]
    if data[0] & 0x20 and payload:        # padding
        payload = payload[:-payload[-1]]
    return (pt, int.from_bytes(data[2:4], "big"),
            int.from_bytes(data[4:8], "big"),
            int.from_bytes(data[8:12], "big"),
            bool(data[1] & 0x80), payload)


# ---------------------------------------------------------------------- #
# Depacketizers (reference: rtpdec_h264.c, rtpdec_mpeg12.c)
# ---------------------------------------------------------------------- #

class Depacketizer:
    codec_id = "none"

    def __init__(self):
        self._au: List[bytes] = []
        self._ts: Optional[int] = None
        self._fu: List[bytes] = []
        self._fu_type = 0

    def packet(self, seq, ts, marker, payload, gap: bool):
        """Feed one RTP payload; returns a finished access-unit bytes
        object or None."""
        raise NotImplementedError


class H264Depacketizer(Depacketizer):
    """RFC 6184: single NAL units, STAP-A aggregates, FU-A fragments
    -> Annex-B access units split on the marker bit (rtpdec_h264.c)."""
    codec_id = "h264"

    def packet(self, seq, ts, marker, payload, gap):
        if not payload:
            return None
        if gap:
            self._au, self._fu = [], []
        nal_type = payload[0] & 0x1F
        if nal_type == 24:                    # STAP-A
            pos = 1
            while pos + 2 <= len(payload):
                sz = int.from_bytes(payload[pos:pos + 2], "big")
                pos += 2
                self._au.append(b"\x00\x00\x00\x01"
                                + payload[pos:pos + sz])
                pos += sz
        elif nal_type == 28:                  # FU-A
            if len(payload) < 2:
                raise AVError(INVALIDDATA, "short FU-A")
            fu_hdr = payload[1]
            if fu_hdr & 0x80:                 # start
                nal_hdr = (payload[0] & 0xE0) | (fu_hdr & 0x1F)
                self._fu = [bytes([nal_hdr]), payload[2:]]
            elif self._fu:
                self._fu.append(payload[2:])
            if fu_hdr & 0x40 and self._fu:    # end
                self._au.append(b"\x00\x00\x00\x01" + b"".join(self._fu))
                self._fu = []
        elif 1 <= nal_type <= 23:             # single NAL unit
            self._au.append(b"\x00\x00\x00\x01" + payload)
        if marker and self._au:
            out = b"".join(self._au)
            self._au = []
            return out
        return None


class MPVDepacketizer(Depacketizer):
    """RFC 2250 §3.4: 4-byte MPEG video header then ES bytes
    (rtpdec_mpeg12.c mpegvideo handler)."""
    codec_id = "mpeg2video"

    def packet(self, seq, ts, marker, payload, gap):
        if len(payload) < 4:
            return None
        if gap:
            self._au = []
        if payload[0] & 0x04:     # MPEG-2 specific extension header
            payload = payload[8:]
        else:
            payload = payload[4:]
        self._au.append(payload)
        if marker and self._au:
            out = b"".join(self._au)
            self._au = []
            return out
        return None


class TSDepacketizer(Depacketizer):
    """Payload type 33: raw transport-stream packets."""
    codec_id = "mpegts"          # container, handled by RTPDemuxer

    def packet(self, seq, ts, marker, payload, gap):
        return payload or None


DEPACKETIZERS = {"h264": H264Depacketizer,
                 "mpeg2video": MPVDepacketizer,
                 "mp2t": TSDepacketizer}
ENCODING_NAMES = {"H264": "h264", "MPV": "mpeg2video", "MP2T": "mp2t"}


# ---------------------------------------------------------------------- #
# Muxer (reference: rtpenc.c ff_rtp_send_data + per-codec packetizers)
# ---------------------------------------------------------------------- #

@register_output
class RTPMuxer(OutputFormat):
    NAME = "rtp"
    LONG_NAME = "RTP output (RFC 3550)"
    VIDEO_CODEC = "h264"
    OPTIONS = ()

    def __init__(self, options=None):
        super().__init__(options)
        self.pt = RTP_PT_DYNAMIC
        self.seq = 0
        self.ssrc = 0x4156      # deterministic like -bitexact rtpenc
        self.max_payload = 1460 - 12
        self._sent_aud = False

    def write_header(self, pb: IOContext):
        self.pb = pb
        if len(self.streams) != 1:
            raise AVError(EINVAL, "rtp muxer takes exactly one stream")
        cid = self.streams[0].codecpar.codec_id
        if cid == "mpeg2video":
            self.pt = RTP_PT_MPV
        elif cid == "mpegts":
            self.pt = RTP_PT_TS
        elif cid != "h264":
            raise AVError(EINVAL, f"rtp: unsupported codec {cid}")

    def _send(self, payload: bytes, ts: int, marker: bool):
        self.pb.write(build_rtp(self.pt, self.seq, ts, self.ssrc,
                                payload, marker))
        self.seq = (self.seq + 1) & 0xFFFF

    def _ts90k(self, pkt: Packet) -> int:
        t = pkt.pts if pkt.pts is not None else pkt.dts
        if t is None or pkt.time_base is None:
            return 0
        return (t * VIDEO_CLOCK * pkt.time_base.num) // pkt.time_base.den

    def write_packet(self, pkt: Packet):
        data = bytes(pkt.data)
        ts = self._ts90k(pkt)
        cid = self.streams[0].codecpar.codec_id
        if cid == "mpeg2video":
            # RFC 2250: 4-byte video header (sequence numbers of the
            # picture are not tracked -> zeros, like rtpenc_mpv's
            # begin/end-of-slice bits are the load-bearing fields)
            room = self.max_payload - 4
            for i in range(0, len(data), room):
                chunk = data[i:i + room]
                b = (0x10 if i == 0 else 0) | \
                    (0x08 if i + room >= len(data) else 0)
                self._send(bytes([0, b, 0, 0]) + chunk, ts,
                           i + room >= len(data))
            return
        if cid == "mpegts":
            for i in range(0, len(data), 188 * 7):
                self._send(data[i:i + 188 * 7], ts, False)
            return
        # h264: split access unit into NALs (Annex B), pack per
        # rtpenc_h264_hevc.c nal_send: single / STAP-A aggregate / FU-A
        nals = _split_annexb(data)
        agg: List[bytes] = []
        agg_size = 1

        def flush_agg(last):
            nonlocal agg, agg_size
            if not agg:
                return
            if len(agg) == 1:
                self._send(agg[0], ts, last)
            else:
                pl = bytes([(agg[0][0] & 0x60) | 24]) + b"".join(
                    len(n).to_bytes(2, "big") + n for n in agg)
                self._send(pl, ts, last)
            agg, agg_size = [], 1

        for k, nal in enumerate(nals):
            last = k == len(nals) - 1
            if len(nal) <= self.max_payload:
                if agg_size + 2 + len(nal) > self.max_payload:
                    flush_agg(False)
                agg.append(nal)
                agg_size += 2 + len(nal)
                if last:
                    flush_agg(True)
            else:
                flush_agg(False)
                ind = (nal[0] & 0xE0) | 28
                hdr, body = nal[0] & 0x1F, nal[1:]
                room = self.max_payload - 2
                for i in range(0, len(body), room):
                    chunk = body[i:i + room]
                    fu = hdr | (0x80 if i == 0 else 0) | \
                        (0x40 if i + room >= len(body) else 0)
                    self._send(bytes([ind, fu]) + chunk, ts,
                               last and i + room >= len(body))


def _split_annexb(data: bytes) -> List[bytes]:
    nals = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        j = data.find(b"\x00\x00\x01", i + 3)
        end = j if j >= 0 else len(data)
        nal = data[i + 3:end]
        while nal.endswith(b"\x00"):
            nal = nal[:-1]
        if nal:
            nals.append(nal)
        i = j
    return nals


def sdp_create(host: str, port: int, codec_id: str,
               extradata: bytes = b"") -> str:
    """Minimal av_sdp_create analogue for one video stream."""
    pt = {"mpeg2video": RTP_PT_MPV, "mpegts": RTP_PT_TS}.get(
        codec_id, RTP_PT_DYNAMIC)
    name = {"h264": "H264", "mpeg2video": "MPV", "mpegts": "MP2T"}[codec_id]
    sdp = ["v=0", "o=- 0 0 IN IP4 127.0.0.1", "s=No Name",
           f"c=IN IP4 {host}", "t=0 0",
           f"m=video {port} RTP/AVP {pt}"]
    if pt >= RTP_PT_DYNAMIC:
        sdp.append(f"a=rtpmap:{pt} {name}/{VIDEO_CLOCK}")
    return "\r\n".join(sdp) + "\r\n"


# ---------------------------------------------------------------------- #
# Demuxers: rtp:// reader and SDP session (reference: rtpdec.c, rtsp.c
# sdp_parse)
# ---------------------------------------------------------------------- #

class _RTPReader:
    """Shared depacketize loop: datagram source -> access units."""

    def __init__(self, recv, codec_id: str):
        self.recv = recv
        self.codec_id = codec_id
        self.depay = DEPACKETIZERS[
            "mp2t" if codec_id == "mpegts" else codec_id]()
        self.last_seq: Optional[int] = None
        self.base_ts: Optional[int] = None

    def next_au(self):
        """Returns (au_bytes, pts90k) or raises EOF_."""
        while True:
            data = self.recv()
            if data is None:
                raise AVError(EOF_, "rtp: end of stream")
            p = parse_rtp(data)
            if p is None:
                continue
            pt, seq, ts, ssrc, marker, payload = p
            gap = (self.last_seq is not None
                   and seq != ((self.last_seq + 1) & 0xFFFF))
            self.last_seq = seq
            au = self.depay.packet(seq, ts, marker, payload, gap)
            if au is not None:
                if self.base_ts is None:
                    self.base_ts = ts
                return au, (ts - self.base_ts) & 0xFFFFFFFF


@register_input
class RTPDemuxer(InputFormat):
    """rtp://host:port?codec=h264 — single-stream RTP session receiver.
    For payload 33 (MPEG-TS) the reassembled datagrams feed the TS
    demuxer. Dynamic payload types need the ?codec= hint (an SDP-less
    rtp:// URL has no rtpmap, same restriction as the reference)."""
    NAME = "rtp"
    FLAG_NOFILE = True

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if url.startswith("rtp:") else 0

    def read_header(self, pb: IOContext):
        u = urlparse(self.url.replace("rtp:", "udp:", 1))
        opts = {k: v[-1] for k, v in parse_qs(u.query).items()}
        codec = opts.get("codec", "h264")
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((u.hostname or "0.0.0.0", u.port or 0))
        sock.settimeout(float(opts.get("timeout", 5e6)) / 1e6)
        self._sock = sock
        self.port = sock.getsockname()[1]

        def recv():
            try:
                return self._sock.recv(65536)
            except socket.timeout:
                return None
        self._setup_stream(recv, codec)

    def _setup_stream(self, recv, codec):
        self._reader = _RTPReader(recv, codec)
        if codec == "mpegts":
            from libav_tpu_torch.formats.mpegts import MpegTSDemuxer
            self._ts_buf = b""

            class _TSIO:
                def __init__(s):
                    s.pos = 0

                def read(s, n=-1):
                    out = b""
                    while n < 0 or len(out) < n:
                        if not self._ts_buf:
                            try:
                                au, _ = self._reader.next_au()
                            except AVError:
                                break
                            self._ts_buf = au
                        take = len(self._ts_buf) if n < 0 \
                            else n - len(out)
                        out += self._ts_buf[:take]
                        self._ts_buf = self._ts_buf[take:]
                    s.pos += len(out)
                    return out

                def tell(s):
                    return s.pos

                def close(s):
                    pass
            self._inner = MpegTSDemuxer()
            self._inner.read_header(IOContext(_TSIO(), seekable=False,
                                              url=self.url))
            self.streams = self._inner.streams
            return
        st = Stream(index=0)
        st.codecpar = CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id=codec)
        st.time_base = Rational(1, VIDEO_CLOCK)
        st.need_parsing = False
        self._inner = None
        self.streams = [st]

    def read_packet(self) -> Packet:
        if self._inner is not None:
            return self._inner.read_packet()
        au, ts = self._reader.next_au()
        pkt = Packet(data=au, stream_index=0,
                     time_base=Rational(1, VIDEO_CLOCK))
        pkt.pts = pkt.dts = ts
        if self._reader.codec_id == "h264":
            if any((n[0] & 0x1F) == 5 for n in _split_annexb(au)):
                pkt.flags |= PKT_FLAG_KEY
        else:
            pkt.flags |= PKT_FLAG_KEY
        return pkt

    def close(self):
        if getattr(self, "_sock", None) is not None:
            self._sock.close()


@register_input
class SDPDemuxer(RTPDemuxer):
    """SDP session files (reference: rtsp.c ff_sdp_demuxer /
    sdp_parse_line): opens the announced UDP port and depacketizes the
    mapped payload."""
    NAME = "sdp"
    FLAG_NOFILE = False
    EXTENSIONS = ("sdp",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        head = data[:256]
        if head.startswith(b"v=0") and b"m=" in data:
            return 60
        return 0

    def read_header(self, pb: IOContext):
        text = pb.read_all().decode("utf-8", "replace")
        port, pt, codec = None, None, None
        rtpmap: Dict[int, str] = {}
        for ln in text.splitlines():
            ln = ln.strip()
            if ln.startswith("m=video") or ln.startswith("m=audio"):
                f = ln.split()
                port, pt = int(f[1]), int(f[3])
            elif ln.startswith("a=rtpmap:"):
                body = ln[len("a=rtpmap:"):]
                num, enc = body.split(" ", 1)
                rtpmap[int(num)] = enc.split("/")[0]
        if port is None:
            raise AVError(INVALIDDATA, "sdp: no media line")
        if pt == RTP_PT_MPV:
            codec = "mpeg2video"
        elif pt == RTP_PT_TS:
            codec = "mpegts"
        else:
            enc = rtpmap.get(pt, "")
            codec = ENCODING_NAMES.get(enc)
            if codec is None:
                raise AVError(INVALIDDATA, f"sdp: unsupported map {enc}")
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", port))
        sock.settimeout(5.0)
        self._sock = sock
        self.port = port

        def recv():
            try:
                return self._sock.recv(65536)
            except socket.timeout:
                return None
        self._setup_stream(recv, codec)


# ---------------------------------------------------------------------- #
# RTSP client (reference: rtsp.c / rtspdec.c ff_rtsp_connect:
# DESCRIBE -> SDP -> SETUP (RTP/AVP;unicast;client_port) -> PLAY)
# ---------------------------------------------------------------------- #

@register_input
class RTSPDemuxer(RTPDemuxer):
    NAME = "rtsp"
    FLAG_NOFILE = True

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if url.startswith("rtsp:") else 0

    def _request(self, method: str, url: str, extra: str = "") -> dict:
        self._cseq += 1
        req = (f"{method} {url} RTSP/1.0\r\nCSeq: {self._cseq}\r\n"
               f"{extra}\r\n")
        self._ctrl.sendall(req.encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self._ctrl.recv(4096)
            if not chunk:
                raise AVError(INVALIDDATA, "rtsp: connection closed")
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        lines = head.decode("utf-8", "replace").split("\r\n")
        status = int(lines[0].split()[1])
        if status != 200:
            raise AVError(INVALIDDATA, f"rtsp: {lines[0]}")
        hdrs = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                hdrs[k.strip().lower()] = v.strip()
        clen = int(hdrs.get("content-length", 0))
        while len(rest) < clen:
            rest += self._ctrl.recv(4096)
        hdrs["_body"] = rest[:clen].decode("utf-8", "replace")
        return hdrs

    def read_header(self, pb: IOContext):
        u = urlparse(self.url)
        self._ctrl = socket.create_connection((u.hostname, u.port or 554),
                                              timeout=5)
        self._cseq = 0
        self._request("OPTIONS", self.url)
        desc = self._request("DESCRIBE", self.url,
                             "Accept: application/sdp\r\n")
        sdp = desc["_body"]
        # parse the one media section
        pt, codec, control = None, None, self.url
        rtpmap: Dict[int, str] = {}
        for ln in sdp.splitlines():
            ln = ln.strip()
            if ln.startswith("m=video") or ln.startswith("m=audio"):
                pt = int(ln.split()[3])
            elif ln.startswith("a=rtpmap:"):
                num, enc = ln[len("a=rtpmap:"):].split(" ", 1)
                rtpmap[int(num)] = enc.split("/")[0]
            elif ln.startswith("a=control:") and pt is not None:
                c = ln[len("a=control:"):]
                control = c if "://" in c else f"{self.url}/{c}"
        if pt is None:
            raise AVError(INVALIDDATA, "rtsp: no media in SDP")
        if pt == RTP_PT_MPV:
            codec = "mpeg2video"
        elif pt == RTP_PT_TS:
            codec = "mpegts"
        else:
            codec = ENCODING_NAMES.get(rtpmap.get(pt, ""))
            if codec is None:
                raise AVError(INVALIDDATA, "rtsp: unsupported rtpmap")
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", 0))
        sock.settimeout(5.0)
        self._sock = sock
        port = sock.getsockname()[1]
        setup = self._request(
            "SETUP", control,
            f"Transport: RTP/AVP;unicast;client_port={port}-{port + 1}"
            "\r\n")
        self._session = setup.get("session", "").split(";")[0]
        self._request("PLAY", self.url,
                      f"Session: {self._session}\r\n")

        def recv():
            try:
                return self._sock.recv(65536)
            except socket.timeout:
                return None
        self._setup_stream(recv, codec)

    def close(self):
        try:
            self._request("TEARDOWN", self.url,
                          f"Session: {self._session}\r\n")
        except Exception:
            pass
        self._ctrl.close()
        super().close()
