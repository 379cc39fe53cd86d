"""The port's protocol containers against the JAX package's, on the CPU:
HLS (a VOD media playlist of MPEG-TS segments, a live window, the
media-sequence refresh, a master playlist over http), RTP (the H.264
single-NAL / STAP-A / FU-A, MPEG video and MPEG-TS packetizers and
depacketizers, the rtp:// receiver over UDP loopback), SDP and RTSP.

Inputs: a 64x48 MPEG-2 stream (GOP 2) from the JAX encoder, muxed to
MPEG-TS by the JAX muxer and split into segments as
tests/test_demux_core.py splits it, and the committed 64x64 H.264 file.
Both packages demux, packetize and depacketize the same bytes: packets,
datagrams and access units must be equal bytes, and the port's frames
(decoded at device="cpu") np.array_equal to the JAX decoder's. Sockets
are loopback only; every port is taken by binding port 0 first.
"""

import http.server
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from libav_tpu.avutil.rational import Rational as JRational
from libav_tpu.codecs.api import CodecParameters as JParams
from libav_tpu.formats import FormatContext as JFormatContext
from libav_tpu.formats import hls as jhls
from libav_tpu.formats import rtp as jrtp
from libav_tpu.formats.api import Stream as JStream
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_decoder)
from libav_tpu_torch.formats import FormatContext, Stream
from libav_tpu_torch.formats import hls, rtp
from libav_tpu_torch.formats.h264raw import split_access_units
from libav_tpu_torch.formats.io import url_open
from tools.gen_torch_smoke_stream import decode_reference, encode

NFRAMES = 6


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def m2v():
    """6 frames of the pattern, 64x48, through the JAX MPEG-2 encoder at
    GOP 2: packet bytes."""
    return encode(64, 48, NFRAMES, "mpeg2video",
                  {"qscale": 6, "gop_size": 2})


@pytest.fixture(scope="module")
def h264_aus():
    with open(testdata.SMALL_H264, "rb") as f:
        return list(split_access_units(f.read()))


def free_port(kind=socket.SOCK_DGRAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_playlist(directory, datas, nseg=3, endlist=True):
    """The JAX muxer's MPEG-TS of the packets, cut at 188-byte packet
    boundaries into nseg segments, and a media playlist over them."""
    ts = directory / "all.ts"
    oc = JFormatContext.open_output(str(ts), "mpegts")
    st = oc.new_stream(JParams(codec_type="video", codec_id="mpeg2video",
                               width=64, height=48, pix_fmt="yuv420p"),
                       time_base=JRational(1, 25))
    st.avg_frame_rate = JRational(25, 1)
    oc.write_header()
    for i, d in enumerate(datas):
        oc.write_packet(JPacket(data=d, pts=i, dts=i, duration=1,
                                stream_index=0))
    oc.write_trailer()
    data = ts.read_bytes()
    per = (len(data) // 188 // nseg) * 188
    names = []
    for k in range(nseg):
        hi = (k + 1) * per if k < nseg - 1 else len(data)
        (directory / f"seg{k}.ts").write_bytes(data[k * per:hi])
        names.append(f"seg{k}.ts")
    pl = directory / "media.m3u8"
    pl.write_text("#EXTM3U\n#EXT-X-VERSION:3\n#EXT-X-TARGETDURATION:1\n" +
                  "".join(f"#EXTINF:0.24,\n{n}\n" for n in names) +
                  ("#EXT-X-ENDLIST\n" if endlist else ""))
    return pl


def demux(fc, url):
    """(format name, [(data, pts, dts, flags, stream)]) of url."""
    ic = fc.open_input(url)
    try:
        pkts = [(bytes(p.data), p.pts, p.dts, p.flags, p.stream_index)
                for p in ic.packets()]
    finally:
        ic.close()
    return ic.iformat.NAME, pkts


def decode_port(codec, datas):
    dec = find_decoder(codec)(CodecParameters(codec_type=MediaType.VIDEO,
                                              codec_id=codec), device="cpu")
    frames = dec.decode_all(Packet(data=d, pts=i) for i, d in
                            enumerate(datas))
    return [f.to_host().planes for f in frames]


def assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# HLS
# ---------------------------------------------------------------------- #

def test_hls_media_playlist_file(m2v, tmp_path):
    """A VOD media playlist of TS segments: both demuxers give the same
    packets, and the port decodes them to the JAX decoder's frames."""
    pl = make_playlist(tmp_path, m2v)
    name, got = demux(FormatContext, str(pl))
    assert (name, got) == demux(JFormatContext, str(pl))
    assert name == "hls" and len(got) == NFRAMES
    datas = [p[0] for p in got]
    assert_frames_equal(decode_port("mpeg2video", datas),
                        decode_reference(datas, "mpeg2video"))


@pytest.mark.parametrize("endlist", [True, False])
def test_hls_master_playlist_http(endlist, m2v, tmp_path):
    """Master playlist -> the highest-BANDWIDTH variant -> segments, all
    over a loopback http:// server with relative URIs, VOD and live:
    both demuxers give the same packets."""
    make_playlist(tmp_path, m2v, endlist=endlist)
    (tmp_path / "master.m3u8").write_text(
        "#EXTM3U\n"
        "#EXT-X-STREAM-INF:BANDWIDTH=100000\nmedia.m3u8\n"
        "#EXT-X-STREAM-INF:BANDWIDTH=50000\nmissing.m3u8\n")
    root = str(tmp_path)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=root, **kw)

        def log_message(self, *a):
            pass

    os.environ.setdefault("no_proxy", "127.0.0.1,localhost")
    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/master.m3u8"
        name, got = demux(FormatContext, url)
        assert (name, got) == demux(JFormatContext, url)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert name == "hls" and len(got) == NFRAMES


def test_hls_live_playlist_plays_window(m2v, tmp_path):
    """A playlist without ENDLIST (live) still demuxes its whole current
    window, as the JAX demuxer does."""
    pl = make_playlist(tmp_path, m2v, endlist=False)
    name, got = demux(FormatContext, str(pl))
    assert (name, got) == demux(JFormatContext, str(pl))
    assert len(got) == NFRAMES


def test_hls_media_sequence_refresh(tmp_path):
    """_reload_playlist returns only the segments past the consumed
    media-sequence high-water mark, then nothing once ENDLIST lands: the
    port's demuxer walks the sliding window as the JAX one does."""
    pl = tmp_path / "live.m3u8"
    for k in range(5):
        (tmp_path / f"s{k}.ts").write_bytes(b"\x47" + bytes(187))
    window = "".join(f"#EXTINF:1,\ns{k}.ts\n" for k in (1, 2, 3, 4))
    steps = []
    for cls in (hls.HLSDemuxer, jhls.HLSDemuxer):
        pl.write_text("#EXTM3U\n#EXT-X-MEDIA-SEQUENCE:0\n"
                      "#EXTINF:1,\ns0.ts\n#EXTINF:1,\ns1.ts\n")
        d = cls()
        d._media_url = str(pl)
        d._next_seq = 2                  # consumed s0, s1
        pl.write_text("#EXTM3U\n#EXT-X-MEDIA-SEQUENCE:1\n" + window)
        fresh, more = d._reload_playlist()
        seq = d._next_seq
        pl.write_text("#EXTM3U\n#EXT-X-MEDIA-SEQUENCE:1\n" + window +
                      "#EXT-X-ENDLIST\n")
        steps.append(([u.rsplit("/", 1)[-1] for u in fresh], more, seq,
                      d._reload_playlist()))
    assert steps[0] == steps[1]
    assert steps[0] == (["s2.ts", "s3.ts", "s4.ts"], True, 5, ([], False))


@pytest.mark.parametrize("base,uri", [
    ("http://h/a/b/p.m3u8", "/seg.ts"),
    ("http://h/a/p.m3u8", "s.ts"),
    ("/dir/p.m3u8", "s.ts"),
    ("/dir/p.m3u8", "http://x/s.ts"),
    ("p.m3u8", "s.ts"),
])
def test_hls_resolve(base, uri):
    assert hls._resolve(base, uri) == jhls._resolve(base, uri)


@pytest.mark.parametrize("text", [
    "#EXTM3U\n#EXT-X-MEDIA-SEQUENCE:7\n#EXT-X-TARGETDURATION:2\n"
    "#EXT-X-MAP:URI=\"init.mp4\"\n#EXTINF:2,\na.m4s\n#EXTINF:2,\nb.m4s\n"
    "#EXT-X-ENDLIST\n",
    "#EXTM3U\n#EXT-X-STREAM-INF:BANDWIDTH=1,RESOLUTION=2x2\nlo.m3u8\n"
    "#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=9\nhi/x.m3u8\n",
    "not a playlist\n",
])
def test_hls_parse_playlist(text):
    def run(mod):
        try:
            return mod.parse_playlist(text, "http://h/live/p.m3u8")
        except Exception as e:          # the two must raise alike
            return type(e).__name__, str(e)
    assert run(hls) == run(jhls)


# ---------------------------------------------------------------------- #
# RTP packetization (no sockets: the datagrams are captured)
# ---------------------------------------------------------------------- #

class Capture:
    """A muxer's pb: keeps each datagram."""

    def __init__(self):
        self.datagrams = []

    def write(self, data):
        self.datagrams.append(bytes(data))
        return len(data)


def packetize(mod, pkg_stream, pkg_params, pkg_packet, codec, datas,
              max_payload=None, w=64, h=48):
    """The datagrams of one package's RTPMuxer for the packets."""
    mux = mod.RTPMuxer()
    if max_payload:
        mux.max_payload = max_payload
    mux.streams = [pkg_stream(index=0, codecpar=pkg_params(
        codec_type="video", codec_id=codec, width=w, height=h))]
    cap = Capture()
    mux.write_header(cap)
    tb = (Rational if mod is rtp else JRational)(1, 25)
    for i, d in enumerate(datas):
        mux.write_packet(pkg_packet(data=d, pts=i, dts=i, time_base=tb))
    return cap.datagrams


def depacketize(mod, codec, datagrams):
    """[(access unit, 90 kHz pts)] of one package's depacketize loop."""
    it = iter(datagrams)
    reader = mod._RTPReader(lambda: next(it, None), codec)
    out = []
    while True:
        try:
            out.append(reader.next_au())
        except Exception as e:
            assert "end of stream" in str(e)
            return out


PORT = (rtp, Stream, CodecParameters, Packet)
JAX = (jrtp, JStream, JParams, JPacket)


@pytest.mark.parametrize("max_payload", [None, 200, 40])
def test_rtp_h264_packetizer(max_payload, h264_aus):
    """RFC 6184 packetization of the committed H.264 AUs (single NAL /
    STAP-A aggregates; FU-A fragments for the NALs past the payload, at
    40 bytes at least):
    the same datagrams, the same reassembled AUs at k * 3600 (90 kHz),
    decoded by the port to the frames of the original AUs."""
    got = packetize(*PORT, "h264", h264_aus, max_payload, 64, 64)
    assert got == packetize(*JAX, "h264", h264_aus, max_payload, 64, 64)
    types = {d[12] & 0x1F for d in got}
    biggest = max(len(n) for a in h264_aus for n in rtp._split_annexb(a))
    assert (28 in types) == (biggest > (max_payload or 1448))
    assert 24 in types and (28 in types or max_payload != 40)
    aus = depacketize(rtp, "h264", got)
    assert aus == depacketize(jrtp, "h264", got)
    assert [ts for _, ts in aus] == [k * 3600 for k in range(len(h264_aus))]
    assert_frames_equal(decode_port("h264", [a for a, _ in aus]),
                        decode_port("h264", h264_aus))


@pytest.mark.parametrize("codec", ["mpeg2video", "mpegts"])
def test_rtp_mpv_and_ts_packetizers(codec, m2v, tmp_path):
    """RFC 2250 MPEG video (payload 32) and MPEG-TS (payload 33): the
    same datagrams and the same depacketized payloads."""
    if codec == "mpegts":
        datas = [make_playlist(tmp_path, m2v).parent.joinpath(
            "all.ts").read_bytes()]
    else:
        datas = m2v
    got = packetize(*PORT, codec, datas, 300)
    assert got == packetize(*JAX, codec, datas, 300)
    assert {d[1] & 0x7F for d in got} == {32 if codec != "mpegts" else 33}
    aus = depacketize(rtp, codec, got)
    assert aus == depacketize(jrtp, codec, got)
    assert b"".join(a for a, _ in aus) == b"".join(datas)


@pytest.mark.parametrize("drop", [1, 5])
def test_rtp_sequence_gap(drop, h264_aus):
    """A lost datagram: both depacketizers drop the torn access unit
    alike (the sequence gap resets the partial AU)."""
    got = packetize(*PORT, "h264", h264_aus, 200, 64, 64)
    lossy = got[:drop] + got[drop + 1:]
    aus = depacketize(rtp, "h264", lossy)
    assert aus == depacketize(jrtp, "h264", lossy)
    assert len(aus) == len(h264_aus) - 1


def test_sdp_create_and_probe():
    for codec in ("h264", "mpeg2video", "mpegts"):
        text = rtp.sdp_create("127.0.0.1", 5004, codec)
        assert text == jrtp.sdp_create("127.0.0.1", 5004, codec)
        data = text.encode()
        assert rtp.SDPDemuxer.probe(data) == jrtp.SDPDemuxer.probe(data) \
            == 60
    for url in ("rtp://127.0.0.1:5004", "rtsp://h/s", "x.sdp"):
        for name in ("RTPDemuxer", "RTSPDemuxer"):
            assert getattr(rtp, name).probe(b"", url) == \
                getattr(jrtp, name).probe(b"", url)


# ---------------------------------------------------------------------- #
# RTP, SDP and RTSP over UDP loopback
# ---------------------------------------------------------------------- #

def send_rtp(port, codec, datas, w, h):
    """The port's RTPMuxer to udp://127.0.0.1:port, paced a datagram at a
    time so a loopback burst does not overrun the receive buffer."""
    mux = rtp.RTPMuxer()
    mux.streams = [Stream(index=0, codecpar=CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=w, height=h),
        time_base=Rational(1, 25))]
    sock = url_open(f"udp://127.0.0.1:{port}", "w")

    class Paced:
        def write(self, data):
            time.sleep(0.002)
            return sock.write(data)
    try:
        mux.write_header(Paced())
        for i, d in enumerate(datas):
            mux.write_packet(Packet(data=d, pts=i, dts=i,
                                    time_base=Rational(1, 25)))
    finally:
        sock.close()


def test_rtp_h264_loopback(h264_aus):
    """The port's RTP muxer -> UDP -> the port's rtp:// demuxer: the
    access units the JAX depacketizer gives for the same datagrams, at
    90 kHz timestamps k * 3600, key flags on the IDR, and the port
    decodes them to the frames of the original AUs."""
    ready, got, errors = threading.Event(), [], []

    def rx(state):
        try:
            ic = FormatContext.open_input("rtp://127.0.0.1:0?codec=h264")
            state["port"] = ic.iformat.port
            ready.set()
            for _ in range(len(h264_aus)):
                got.append(ic.read_frame())
            ic.close()
        except Exception as e:  # surfaced by the asserts below
            errors.append(e)
            ready.set()
    state = {}
    t = threading.Thread(target=rx, args=(state,), daemon=True)
    t.start()
    assert ready.wait(10) and not errors, errors
    send_rtp(state["port"], "h264", h264_aus, 64, 64)
    t.join(timeout=20)
    assert not t.is_alive() and not errors, errors
    want = depacketize(jrtp, "h264", packetize(*JAX, "h264", h264_aus,
                                               None, 64, 64))
    assert [(bytes(p.data), p.pts) for p in got] == want
    assert [bool(p.flags & 1) for p in got] == \
        [any((n[0] & 0x1F) == 5 for n in rtp._split_annexb(a))
         for a, _ in want]
    assert_frames_equal(decode_port("h264", [p.data for p in got]),
                        decode_port("h264", h264_aus))


def test_sdp_session_mpv(m2v, tmp_path):
    """An RFC 2250 MPEG-2 RTP session announced by an SDP file: the port's
    sdp demuxer gives back the elementary stream, which the port decodes
    to the JAX decoder's frames."""
    port = free_port()
    sdpf = tmp_path / "s.sdp"
    sdpf.write_text(rtp.sdp_create("127.0.0.1", port, "mpeg2video"))
    got, errors, opened = [], [], threading.Event()

    def rx():
        try:
            ic = FormatContext.open_input(str(sdpf))
            assert ic.iformat.NAME == "sdp"
            opened.set()
            for _ in range(len(m2v)):
                got.append(ic.read_frame())
            ic.close()
        except Exception as e:
            errors.append(e)
            opened.set()
    t = threading.Thread(target=rx, daemon=True)
    t.start()
    assert opened.wait(10) and not errors, errors
    send_rtp(port, "mpeg2video", m2v, 64, 48)
    t.join(timeout=20)
    assert not t.is_alive() and not errors, errors
    es = [bytes(p.data) for p in got]
    assert b"".join(es) == b"".join(m2v)
    assert_frames_equal(decode_port("mpeg2video", es),
                        decode_reference(m2v, "mpeg2video"))


def test_rtsp_session(h264_aus):
    """rtsp:// client handshake (OPTIONS/DESCRIBE/SETUP/PLAY/TEARDOWN)
    against a minimal loopback RTSP server, then RTP H.264 of the played
    stream: the port's demuxer gives the JAX depacketizer's AUs and the
    frames of the original AUs."""
    ctrl = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ctrl.bind(("127.0.0.1", 0))
    ctrl.listen(1)
    rtsp_port = ctrl.getsockname()[1]
    state = {"methods": []}

    def serve():
        conn, _ = ctrl.accept()
        buf = b""
        with conn:
            while True:
                while b"\r\n\r\n" not in buf:
                    chunk = conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                head, buf = buf.split(b"\r\n\r\n", 1)
                lines = head.decode().split("\r\n")
                method = lines[0].split()[0]
                state["methods"].append(method)
                cseq = next(ln.split(":")[1].strip() for ln in lines
                            if ln.lower().startswith("cseq"))
                body, extra = "", ""
                if method == "OPTIONS":
                    extra = "Public: DESCRIBE, SETUP, PLAY, TEARDOWN\r\n"
                elif method == "DESCRIBE":
                    body = rtp.sdp_create("127.0.0.1", 0, "h264")
                    extra = ("Content-Type: application/sdp\r\n"
                             f"Content-Length: {len(body)}\r\n")
                elif method == "SETUP":
                    tr = next(ln for ln in lines
                              if ln.startswith("Transport:"))
                    state["client_port"] = int(
                        tr.split("client_port=")[1].split("-")[0])
                    extra = f"Session: 12345678\r\n{tr}\r\n"
                elif method == "PLAY":
                    extra = "Session: 12345678\r\n"
                    threading.Thread(target=send_rtp, daemon=True, args=(
                        state["client_port"], "h264", h264_aus, 64,
                        64)).start()
                conn.sendall(f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n{extra}"
                             f"\r\n{body}".encode())
                if method == "TEARDOWN":
                    return

    srv = threading.Thread(target=serve, daemon=True)
    srv.start()
    try:
        ic = FormatContext.open_input(f"rtsp://127.0.0.1:{rtsp_port}/s")
        assert ic.iformat.NAME == "rtsp"
        got = [ic.read_frame() for _ in range(len(h264_aus))]
        ic.close()
        srv.join(timeout=10)
    finally:
        ctrl.close()
    assert not srv.is_alive()
    assert state["methods"] == ["OPTIONS", "DESCRIBE", "SETUP", "PLAY",
                                "TEARDOWN"]
    want = depacketize(jrtp, "h264", packetize(*JAX, "h264", h264_aus,
                                               None, 64, 64))
    assert [(bytes(p.data), p.pts) for p in got] == want
    assert_frames_equal(decode_port("h264", [p.data for p in got]),
                        decode_port("h264", h264_aus))
