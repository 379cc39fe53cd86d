"""The port's containers against the JAX package's, on the CPU: MOV/MP4,
Matroska/WebM and MPEG-TS (with the bitstream filters they use), and the
raw MP1/2/3 and FLAC containers. The same packets, from the JAX
encoders on frames made from a seed, go to both packages' muxers; the
files must be the same bytes, and both demuxers must give the same
packets (data, pts, dts, duration, flags, stream) and the same stream
parameters. The codecs are those the JAX container tests use
(tests/test_mov.py, test_matroska.py, test_containers.py), with the
audio codecs each muxer carries.
"""

import types

import pytest
import torch

from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.avutil.rational import Rational as JRational
from libav_tpu.codecs import bsf as jbsf
from libav_tpu.codecs.api import CodecParameters as JParams
from libav_tpu.codecs import api as jax_api
from libav_tpu.codecs.api import find_encoder as jax_find_encoder
from libav_tpu.formats import FormatContext as JFormatContext
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs import bsf
from libav_tpu_torch.codecs.api import CodecParameters, find_decoder
from libav_tpu_torch.formats import FormatContext
from libav_tpu_torch.formats.api import find_input_format, guess_format
from libav_tpu_torch.testdata import containers as C
from tools.gen_torch_smoke_stream import audio_signal, pattern

JAX = types.SimpleNamespace(FormatContext=JFormatContext, Params=JParams,
                            Packet=JPacket, Rational=JRational)
PORT = types.SimpleNamespace(FormatContext=FormatContext,
                             Params=CodecParameters, Packet=Packet,
                             Rational=Rational)


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


VIDEO = {"mpeg4": {}, "h264": {"qp": 22}, "mjpeg": {},
         "mpeg1video": {}, "mpeg2video": {"b_frames": 2}}
AUDIO = {"aac": ("fltp", 1024), "ac3": ("fltp", 1536)}


def _video(codec, nframes=3, w=64, h=48):
    """(params dict, [(data, pts, dts, duration, flags)], time base) of
    nframes of the test pattern through the JAX encoder, timestamps as
    the JAX container tests set them."""
    par = dict(codec_type="video", codec_id=codec, width=w, height=h,
               pix_fmt="yuvj420p" if codec == "mjpeg" else "yuv420p")
    enc = jax_find_encoder(codec)(JParams(**par, framerate=JRational(25, 1)))
    for k, v in VIDEO[codec].items():
        enc.set_opt(k, v)
    pkts = enc.encode_all([pattern(w, h, t, par["pix_fmt"])
                           for t in range(nframes)])
    return par, [(p.data, i, i, 1, p.flags) for i, p in enumerate(pkts)], \
        (1, 25)


def _audio(codec, nframes=3, channels=2):
    """The same for nframes of a seeded signal through the JAX audio
    encoder, pts in samples."""
    fmt, size = AUDIO[codec]
    par = dict(codec_type="audio", codec_id=codec, sample_rate=48000,
               channels=channels, sample_fmt=fmt)
    enc = jax_find_encoder(codec)(JParams(**par))
    x = audio_signal(nframes * size / 48000, channels, 11)
    f = JFrame(nb_samples=x.shape[1], sample_rate=48000, format="fltp",
               channels=channels)
    f.planes = list(x)
    pkts = enc.encode_all([f])
    return par, [(p.data, i * size, i * size, size, p.flags)
                 for i, p in enumerate(pkts)], (1, 48000)


def mux(P, path, fmt, streams):
    """streams [(params, packets, time base)] through package P's muxer
    into path, packets interleaved stream by stream in turn."""
    oc = P.FormatContext.open_output(str(path), fmt)
    for par, _, tb in streams:
        oc.new_stream(P.Params(**par), time_base=P.Rational(*tb))
    oc.write_header()
    n = max(len(pk) for _, pk, _ in streams)
    for i in range(n):
        for si, (_, pk, tb) in enumerate(streams):
            if i < len(pk):
                data, pts, dts, dur, flags = pk[i]
                p = P.Packet(data=data, pts=pts, dts=dts, duration=dur,
                             flags=flags)
                p.stream_index = si
                p.time_base = P.Rational(*tb)
                oc.write_packet(p)
    oc.write_trailer()
    return path.read_bytes()


def demux(P, path, fmt=None):
    """(demuxer name, stream records, packet records) of a file through
    P's demuxer (probed, or fmt)."""
    ic = P.FormatContext.open_input(str(path), fmt)
    try:
        pkts = [(bytes(p.data), p.pts, p.dts, p.duration, p.flags,
                 p.stream_index, str(p.time_base)) for p in ic.packets()]
        streams = [(s.codecpar.codec_type, s.codecpar.codec_id,
                    bytes(s.codecpar.extradata), s.codecpar.width,
                    s.codecpar.height, s.codecpar.sample_rate,
                    s.codecpar.channels, str(s.time_base))
                   for s in ic.streams]
        name = ic.iformat.NAME
    finally:
        ic.close()
    return name, streams, pkts


def _both(tmp_path, ext, fmt, streams):
    """Mux with both packages (same bytes), then demux the file with
    both (same streams and packets): -> the port's demux."""
    want = mux(JAX, tmp_path / f"jax.{ext}", fmt, streams)
    got = mux(PORT, tmp_path / f"port.{ext}", fmt, streams)
    assert got == want
    jd = demux(JAX, tmp_path / f"jax.{ext}")
    pd = demux(PORT, tmp_path / f"jax.{ext}")
    assert pd == jd
    return pd


CASES = [("mp4", "mp4", c) for c in ("mpeg4", "h264", "mjpeg", "aac",
                                     "mpeg4+aac", "h264+aac")] + \
    [("mkv", "matroska", c) for c in ("mpeg4", "h264", "mpeg1video", "mjpeg",
                                      "ac3", "aac", "h264+ac3",
                                      "mpeg4+aac")] + \
    [("ts", "mpegts", c) for c in ("mpeg2video", "h264", "mpeg4", "ac3",
                                   "aac", "h264+ac3", "mpeg2video+aac")]


@pytest.mark.parametrize("ext,fmt,codecs", CASES)
def test_mux_demux_matches_jax(ext, fmt, codecs, tmp_path):
    streams = [_video(c) if c in VIDEO else _audio(c)
               for c in codecs.split("+")]
    name, pstreams, pkts = _both(tmp_path, ext, fmt, streams)
    assert [s[1] for s in pstreams] == codecs.split("+")
    for si, (_, sent, _) in enumerate(streams):
        assert len([p for p in pkts if p[5] == si]) == len(sent)


@pytest.mark.parametrize("ext,fmt,codec", [("mp4", "mp4", "h264"),
                                           ("mkv", "matroska", "h264"),
                                           ("ts", "mpegts", "mpeg2video"),
                                           ("mp4", "mp4", "mpeg4")])
def test_demuxed_video_decodes_on_port(ext, fmt, codec, tmp_path):
    """The port's demux of a JAX-muxed file through the port's decoder:
    H.264 out of MP4 and Matroska reaches the decoder as Annex B with
    the avcC parameter sets before the first IDR, as the JAX demuxer
    gives it."""
    _both(tmp_path, ext, fmt, [_video(codec)])
    ic = FormatContext.open_input(str(tmp_path / f"jax.{ext}"))
    st = ic.streams[0]
    pkts = list(ic.packets())
    if codec == "h264":
        assert pkts[0].data[:4] == b"\x00\x00\x00\x01"
        assert pkts[0].data[4] & 0x1F == 7          # SPS first
    dec = find_decoder(codec)(st.codecpar, device="cpu").open()
    assert len(dec.decode_all(pkts)) == 3


def test_webm_demuxer_matches_jax(tmp_path):
    """A Matroska file opened as webm: the same packets from both
    packages' WebM demuxers."""
    path = tmp_path / "jax.webm"
    mux(JAX, path, "matroska", [_video("mpeg4")])
    got = demux(PORT, path, "webm")
    assert got == demux(JAX, path, "webm")
    assert got[0] == "webm" and len(got[2]) == 3


def test_mpegts_cc_gap_flagged_like_jax(tmp_path):
    """A TS packet dropped from the middle of the file: both demuxers
    see the continuity-counter gap and flag the same packets corrupt."""
    _both(tmp_path, "ts", "mpegts", [_video("mpeg2video", nframes=6)])
    data = (tmp_path / "jax.ts").read_bytes()
    cut = tmp_path / "cut.ts"
    mid = (len(data) // 188 // 2) * 188
    cut.write_bytes(data[:mid] + data[mid + 188:])
    assert demux(PORT, cut) == demux(JAX, cut)


@pytest.mark.parametrize("codec,fmt,ext", [("mp2", "mp2", "mp2"),
                                           ("mp3", "mp3", "mp3"),
                                           ("mp1", "mp2", "mp2"),
                                           ("flac", "flac", "flac")])
def test_raw_audio_containers_match_jax(codec, fmt, ext, tmp_path):
    """mp3raw and flacfmt: the JAX encoder's packets muxed by both (the
    same bytes) and demuxed by both (the same packets); probing picks the
    same demuxer."""
    par = dict(codec_type="audio", codec_id=codec, sample_rate=48000,
               channels=2, sample_fmt="s16" if codec == "flac" else "fltp")
    x = audio_signal(0.1, 2, 12)
    datas = C.encode(jax_api, JFrame, codec,
                     {"bit_rate_kbps": 320} if codec == "mp3" else {}, x)
    if codec == "flac":
        par["extradata"] = datas.pop(0)[8:]
    streams = [(par, [(d, i, i, 0, PKT_FLAG_KEY) for i, d in
                      enumerate(datas)], (1, 48000))]
    name, pstreams, pkts = _both(tmp_path, ext, fmt, streams)
    assert b"".join(p[0] for p in pkts) == b"".join(datas)


def test_probe_and_guess_match_jax(tmp_path):
    """Each new container resolves by name and by extension in the port
    as in the JAX package."""
    from libav_tpu.formats.api import find_input_format as jax_find_input
    from libav_tpu.formats.api import guess_format as jax_guess
    for name in ("mov", "mp4", "m4a", "3gp", "matroska", "webm", "mpegts",
                 "mp3", "flac"):
        assert find_input_format(name).__name__ == \
            jax_find_input(name).__name__
    for name in ("mp4", "mov", "matroska", "mpegts", "mp3", "mp2", "flac"):
        assert guess_format(name).__name__ == jax_guess(name).__name__
    for ext in ("mp4", "mov", "m4a", "mkv", "mka", "ts", "mp3", "mp2",
                "flac"):
        assert guess_format(url=f"x.{ext}").__name__ == \
            jax_guess(url=f"x.{ext}").__name__


# ---------------------------------------------------------------------- #
# the bitstream filters alone
# ---------------------------------------------------------------------- #

def _h264_annexb():
    _, pk, _ = _video("h264", nframes=3)
    return [(d, f) for d, *_, f in pk]


def test_h264_mp4toannexb_matches_jax():
    """avcC extradata and length-prefixed packets, as the MP4 muxer
    writes them, through both packages' H264Mp4ToAnnexB: the same Annex
    B packets, parameter sets before the key packets."""
    from libav_tpu.codecs.h264.nal import nal_header, split_annexb
    pk = _h264_annexb()
    nals = split_annexb(pk[0][0])
    sps = next(n for n in nals if nal_header(n)[1] == 7)
    pps = next(n for n in nals if nal_header(n)[1] == 8)
    assert bsf.make_avcc(sps, pps) == jbsf.make_avcc(sps, pps)
    avcc = jbsf.make_avcc(sps, pps)
    jf, pf = jbsf.H264Mp4ToAnnexB(avcc), bsf.H264Mp4ToAnnexB(avcc)
    for data, flags in pk:
        body = jbsf.annexb_to_avcc(data)
        assert bsf.annexb_to_avcc(data) == body
        assert bsf.avcc_to_annexb(body) == jbsf.avcc_to_annexb(body)
        want = jf.filter(JPacket(data=body, flags=flags))
        got = pf.filter(Packet(data=body, flags=flags))
        assert [p.data for p in got] == [p.data for p in want]
    assert bsf.parse_avcc(avcc) == jbsf.parse_avcc(avcc)


def test_aac_asctoadts_matches_jax():
    """Raw AAC frames + AudioSpecificConfig -> ADTS, both packages; the
    ADTS -> ASC filter fails the same way in both (the JAX filter
    unpacks four of parse_adts_header's values, which returns more)."""
    _, pk, _ = _audio("aac", nframes=4)
    asc = jbsf.make_asc(3, 2)
    assert bsf.make_asc(3, 2) == asc
    assert bsf.parse_asc(asc) == jbsf.parse_asc(asc)
    jb, pb = jbsf.AacAscToAdts(asc), bsf.AacAscToAdts(asc)
    for data, *_ in pk:
        raw = data[7:]
        assert pb.filter(Packet(data=raw))[0].data == \
            jb.filter(JPacket(data=raw))[0].data
        with pytest.raises(ValueError):
            jbsf.AacAdtsToAsc().filter(JPacket(data=data))
        with pytest.raises(ValueError):
            bsf.AacAdtsToAsc().filter(Packet(data=data))


@pytest.mark.parametrize("codec", ["h264", "mpeg4"])
def test_extract_extradata_matches_jax(codec):
    _, pk, _ = _video(codec, nframes=2)
    jf = jbsf.ExtractExtradata(codec_id=codec)
    pf = bsf.ExtractExtradata(codec_id=codec)
    for data, *_ in pk:
        jf.filter(JPacket(data=data))
        pf.filter(Packet(data=data))
    assert pf.extradata == jf.extradata and pf.extradata
    assert sorted(bsf._BSFS) == sorted(jbsf._BSFS)
    with pytest.raises(AVError):
        bsf.find_bsf("no_such_filter")
