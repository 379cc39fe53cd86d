"""The port's capture devices, AVDictionary and small tools against the
JAX package's, on the CPU: the testsrc, vsynth and sine devices (as
demuxers and through both CLIs), avutil/dict, pktdumper, trasher and the
fault-injection sweeps of tests/test_aux.py run through both packages'
decoders, avplay (null video, the terminal renderer, the A/V clock with
a PCM file sink) and the entropy profilers with their C harness.

Every input comes from a seed or a committed file; the port runs at
device="cpu". Packets, files, framecrc text and PCM must be equal bytes,
frames np.array_equal, and a decoder that refuses a trashed packet must
raise the JAX decoder's AVError.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from libav_tpu.avutil import dict as jdict
from libav_tpu.avutil.error import AVError as JAVError
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.codecs import api as jax_api
from libav_tpu.formats import FormatContext as JFormatContext
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu.tools import avplay as jax_avplay
from libav_tpu.tools import pktdumper as jax_pktdumper
from libav_tpu.tools import profile_entropy as jax_profile
from libav_tpu.tools import replay_entropy as jax_replay
from libav_tpu.tools import trasher as jax_trasher
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import dict as pdict
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import api as port_api
from libav_tpu_torch.formats import FormatContext
from libav_tpu_torch.tools import avconv, avplay, pktdumper
from libav_tpu_torch.tools import profile_entropy, replay_entropy, trasher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# ---------------------------------------------------------------------- #
# avutil/dict
# ---------------------------------------------------------------------- #

def dict_script(mod):
    """tests/test_avutil.py TestAVDictionary's calls on one package's
    AVDictionary: every value they return."""
    d = mod.AVDictionary()
    out = []
    d.set("Language", "eng")
    out += [d.get_value("language"),
            d.get_value("language", flags=mod.MATCH_CASE)]
    d.set("language", "ger")
    out += [len(d), d["Language"]]
    d.set("language", "fra", mod.DONT_OVERWRITE)
    out.append(d["language"])
    d.set("language", "+sub", mod.APPEND)
    out.append(d["language"])
    d.set("lang_alt", "x")
    out.append(d.get_value("lang", flags=mod.IGNORE_SUFFIX))
    d.set("tag", "a", mod.MULTIKEY)
    d.set("tag", "b", mod.MULTIKEY)
    e = d.get("tag")
    out += [tuple(e), tuple(d.get("tag", prev=e)), d.to_dict()]
    d.set("tag", None)
    out += ["tag" in d, list(d)]
    p = mod.AVDictionary()
    p.parse_string("a=1:b=2:c")
    out.append(p.to_dict())
    return out


def test_dict_matches_jax():
    got = dict_script(pdict)
    assert got == dict_script(jdict)
    assert got[1] is None and got[5] == "ger+sub"
    assert got[-1] == {"a": "1", "b": "2", "c": ""}


# ---------------------------------------------------------------------- #
# capture devices
# ---------------------------------------------------------------------- #

def demux(fc, url):
    ic = fc.open_input(url)
    par = ic.streams[0].codecpar
    pkts = [(bytes(p.data), p.pts, p.dts, p.duration, p.flags)
            for p in ic.packets()]
    ic.close()
    return (ic.iformat.NAME, par.codec_id, par.width, par.height,
            par.sample_rate, par.channels), pkts


@pytest.mark.parametrize("url", [
    "testsrc=64x48:rate=25:frames=5",
    "testsrc=size=48x32:frames=2",
    "vsynth=64x48:frames=3",
    "sine=freq=1000:rate=8000:samples=4000",
    "sine",
])
def test_device_demuxers_match_jax(url):
    head, pkts = demux(FormatContext, url)
    assert (head, pkts) == demux(JFormatContext, url)
    assert head[0] == url.split("=")[0] and pkts


def test_device_bad_size_raises_alike():
    errs = []
    for fc, err in ((FormatContext, AVError), (JFormatContext, JAVError)):
        with pytest.raises(err) as e:
            fc.open_input("testsrc=wide")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [
    ["-f", "testsrc", "-i", "testsrc=64x48:rate=25:frames=3"],
    ["-i", "vsynth=48x32:frames=2"],
    ["-i", "sine=freq=1000:rate=8000:samples=4000"],
])
def test_device_cli_framecrc_matches_jax(argv, tmp_path):
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        dst = str(tmp_path / f"{name}.crc")
        assert tool.main(argv + ["-f", "framecrc", dst], **kw) == 0
        with open(dst) as f:
            out[name] = f.read()
    assert out["port"] == out["jax"] and out["jax"].count("\n0, ") >= 2


# ---------------------------------------------------------------------- #
# pktdumper, trasher
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    from test_mjpeg import encode, synth_frame
    p = tmp_path_factory.mktemp("jpg") / "x.jpg"
    p.write_bytes(encode(synth_frame(32, 32), 90))
    return str(p)


@pytest.mark.parametrize("src", ["jpeg", "h264", "sine"])
def test_pktdumper_matches_jax(src, jpeg, tmp_path, capsys):
    url = {"jpeg": jpeg, "h264": testdata.SMALL_H264,
           "sine": "sine=rate=8000:samples=3000"}[src]
    out = {}
    for name, tool in (("jax", jax_pktdumper), ("port", pktdumper)):
        d = tmp_path / name
        d.mkdir()
        assert tool.main([url, str(d)]) == 0
        out[name] = (capsys.readouterr().out,
                     {p: (d / p).read_bytes() for p in os.listdir(d)})
    assert out["port"] == out["jax"]
    assert "pkt 00000" in out["jax"][0] and "crc=0x" in out["jax"][0]
    assert len(out["jax"][1]) == out["jax"][0].count("pkt ")
    assert pktdumper.main([]) == 1


@pytest.mark.parametrize("count,seed,keep", [(8, 1, 12), (12, 2, 2),
                                             (30, 7, 0), (5, 3, 5000)])
def test_trash_matches_jax(count, seed, keep):
    data = bytes(range(256)) * 9
    got = trasher.trash(data, count, seed, keep_prefix=keep)
    assert got == jax_trasher.trash(data, count, seed, keep_prefix=keep)
    assert (got == data) == (keep >= len(data))


def test_trasher_main_matches_jax(jpeg, tmp_path):
    for name, tool in (("jax", jax_trasher), ("port", trasher)):
        assert tool.main([jpeg, "10", "4", str(tmp_path / name)]) == 0
    assert (tmp_path / "port").read_bytes() == \
        (tmp_path / "jax").read_bytes()
    assert trasher.main([jpeg]) == 1


# ---------------------------------------------------------------------- #
# fault injection: both packages' decoders on the same trashed packets
# ---------------------------------------------------------------------- #

def outcomes(decoder, datas, packet):
    """Per packet, the frames (host planes) it gives, or the AVError text
    it raises: the only sanctioned failure for corrupt input."""
    out = []
    for d in datas:
        try:
            decoder.send_packet(packet(data=d))
            frames = decoder._pump()
            out.append([[np.asarray(p) for p in f.to_host().planes]
                        for f in frames])
        except (AVError, JAVError) as e:
            out.append(("AVError", str(e)))
    return out


def assert_same_outcomes(codec, datas):
    want = outcomes(jax_api.find_decoder(codec)(jax_api.CodecParameters(
        codec_type="video", codec_id=codec)).open(), datas, JPacket)
    got = outcomes(port_api.find_decoder(codec)(port_api.CodecParameters(
        codec_type="video", codec_id=codec), device="cpu").open(), datas,
        Packet)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
            continue
        assert not isinstance(g, tuple) and len(g) == len(w)
        for fg, fw in zip(g, w):
            assert all(np.array_equal(a, b) for a, b in zip(fg, fw))


@pytest.fixture(scope="module")
def mpeg1_packets():
    from test_mpeg12 import make_encoder, vsynth_frame
    enc = make_encoder(48, 32, qscale=4)
    return [p.data for p in enc.encode_all(
        [vsynth_frame(48, 32, t) for t in range(3)])]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trashed_mpeg1_matches_jax(seed, mpeg1_packets):
    assert_same_outcomes("mpeg1video", [
        trasher.trash(d, count=8, seed=seed, keep_prefix=12)
        for d in mpeg1_packets])


@pytest.mark.parametrize("seed", [1, 2])
def test_trashed_jpeg_matches_jax(seed, jpeg):
    with open(jpeg, "rb") as f:
        data = f.read()
    assert_same_outcomes("mjpeg", [trasher.trash(data, 12, seed,
                                                 keep_prefix=2)])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trashed_b_frames_match_jax(seed):
    from test_mpeg12 import vsynth_frame
    par = jax_api.CodecParameters(codec_type="video",
                                  codec_id="mpeg2video", width=48,
                                  height=32, pix_fmt="yuv420p")
    enc = jax_api.find_encoder("mpeg2video")(par)
    enc.set_opt("qscale", 4)
    enc.set_opt("b_frames", 2)
    pkts = enc.encode_all([vsynth_frame(48, 32, t) for t in range(5)])
    assert_same_outcomes("mpeg2video", [
        trasher.trash(p.data, 8, seed, keep_prefix=8) for p in pkts])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trashed_matroska_matches_jax(seed, tmp_path):
    """A trashed Matroska file: both demuxers give the same packets, or
    raise the same AVError at the same packet."""
    from test_matroska import mux_mkv
    path, _ = mux_mkv(tmp_path, "mpeg4")
    with open(path, "rb") as f:
        data = trasher.trash(f.read(), count=10, seed=seed, keep_prefix=4)
    p2 = tmp_path / "trash.mkv"
    p2.write_bytes(data)
    out = []
    for fc, err in ((FormatContext, AVError), (JFormatContext, JAVError)):
        got = []
        try:
            ic = fc.open_input(str(p2))
            for p in ic.packets():
                got.append((bytes(p.data), p.pts, p.dts, p.flags))
        except err as e:
            got.append(("AVError", str(e)))
        out.append(got)
    assert out[0] == out[1]


# ---------------------------------------------------------------------- #
# avplay
# ---------------------------------------------------------------------- #

def run_quiet(fn):
    """fn() with stdout and stderr captured: (result, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        r = fn()
    return r, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("vo", ["null", "term"])
def test_avplay_video_matches_jax(vo, jpeg):
    """play(vo=null|term, max_frames=1) on a JPEG: the same frame count
    line, and for the terminal renderer the same ANSI cells (its scale
    and RGB conversion on the port's device)."""
    runs = [run_quiet(lambda: jax_avplay.play(jpeg, vo=vo, max_frames=1)),
            run_quiet(lambda: avplay.play(jpeg, vo=vo, max_frames=1,
                                          device="cpu"))]
    assert runs[0] == runs[1]
    assert runs[1][0] == 0 and "1 frames shown" in runs[1][2]
    assert ("\x1b[38;2;" in runs[1][1]) == (vo == "term")


def test_avplay_main_matches_jax(jpeg):
    """The CLI with -vo null -ao null -frames 1, and the usage error
    without an input."""
    argv = ["-vo", "null", "-ao", "null", "-frames", "1", jpeg]
    runs = [run_quiet(lambda: jax_avplay.main(argv)),
            run_quiet(lambda: avplay.main(argv, device="cpu"))]
    assert runs[0] == runs[1] and runs[1][0] == 0
    assert "1 frames shown" in runs[1][2]
    usage = [run_quiet(lambda: jax_avplay.main([])),
             run_quiet(lambda: avplay.main([], device="cpu"))]
    assert usage[0] == usage[1] and usage[1][0] == 1


def test_avplay_av_sync_matches_jax(tmp_path):
    """The A/V path (tests/test_aux.py TestAvplayAV): an MPEG-1 + MP2 AVI
    played with the audio clock as master and a PCM file sink for 0.45 s.
    How much audio each run writes depends on the wall clock, so each
    file must be the s16 interleave of its package's own decode of the
    MP2 track over its length, and the two files equal over the shorter
    one."""
    from fate_util import write_wav48, write_y4m
    y4m, wav = str(tmp_path / "in.y4m"), str(tmp_path / "in.wav")
    write_y4m(y4m, 64, 48, 13)
    write_wav48(wav, seconds=0.6)
    avi = str(tmp_path / "av.avi")
    assert jax_avconv.main(["-y", "-i", y4m, "-i", wav, "-c:v",
                            "mpeg1video", "-c:a", "mp2", "-map", "0:v",
                            "-map", "1:a", avi]) == 0
    pcm = {}
    for name, mod, kw in (("jax", jax_avplay, {}),
                          ("port", avplay, {"device": "cpu"})):
        path = str(tmp_path / f"{name}.pcm")
        p = mod.Player(avi, vo="null", ao="file", ao_path=path,
                       duration=0.45, **kw)
        assert run_quiet(p.run)[0] == 0
        pcm[name] = np.fromfile(path, "<i2")
        assert pcm[name].size > 4000
        assert np.abs(pcm[name].astype(np.float64)).mean() > 100
    # the whole MP2 track, decoded by the port and interleaved as the
    # audio thread interleaves it
    ic = FormatContext.open_input(avi)
    ast = next(s for s in ic.streams if s.codecpar.codec_type == "audio")
    dec = port_api.find_decoder(ast.codecpar.codec_id)(
        ast.codecpar, device="cpu").open()
    frames = dec.decode_all(p for p in ic.packets()
                            if p.stream_index == ast.index)
    ic.close()
    ref = np.concatenate([np.clip(np.stack(
        [np.asarray(x, np.float32) for x in f.to_host().planes[:2]]
    ).T.reshape(-1) * 32767.0, -32768, 32767).astype(np.int16)
        for f in frames])
    for name in pcm:
        assert np.array_equal(pcm[name], ref[:pcm[name].size])


# ---------------------------------------------------------------------- #
# the entropy profilers and the C harness
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def small_pkts(tmp_path_factory):
    """The committed 64x64 H.264 file as a length-prefixed packet file,
    the format of both profilers' bench stream."""
    path = str(tmp_path_factory.mktemp("ent") / "small.h264pkts")
    testdata.write_packets(path, profile_entropy.load_packets(
        testdata.SMALL_H264))
    return path


def test_profile_entropy_matches_jax(small_pkts, monkeypatch, capsys):
    """Both profilers time the same native slice calls: one rep over the
    4 AUs, the same call count; the port reads the Annex-B file as the
    raw H.264 demuxer splits it."""
    assert profile_entropy.load_packets(small_pkts) == \
        jax_profile.load_packets(small_pkts)
    assert profile_entropy.bench_stream_path() == testdata.SMOKE_STREAM
    monkeypatch.setattr(jax_profile, "bench_stream_path", lambda: small_pkts)
    monkeypatch.setattr(sys, "argv", ["profile_entropy", "1"])
    jax_profile.main()
    want = capsys.readouterr().out
    assert profile_entropy.main(["1", testdata.SMALL_H264],
                                device="cpu") == 0
    got = capsys.readouterr().out

    def calls(text):
        return int(re.search(r"\((\d+) slice calls", text).group(1))
    assert calls(got) == calls(want) == 16     # 4 AUs of 4 slices
    assert "ms/frame" in got and "wall total" in got


def test_replay_entropy_matches_jax(small_pkts, monkeypatch, capsys,
                                    tmp_path):
    """The captured calls equal the JAX capture's (shapes, CABAC bytes,
    arguments), the replay's arena checksum is stable and equals the
    JAX replay's, and the dump runs in the C harness. Both decoders take
    their serial slice path (one CPU seen), so the calls come in stream
    order; on more cores the slices of an AU go to a thread pool."""
    monkeypatch.setattr(jax_replay, "bench_stream_path", lambda: small_pkts)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    want = jax_replay.capture()
    got = replay_entropy.capture(small_pkts, device="cpu")
    assert len(got) == len(want) == 16         # 4 AUs of 4 slices
    for g, w in zip(got, want):
        assert g[:4] == w[:4] and g[4].keys() == w[4].keys()
        for k in g[4]:
            if k == "sctx":     # an output buffer (np.empty) at call time
                assert g[4][k].shape == w[4][k].shape
            elif isinstance(g[4][k], np.ndarray):
                assert np.array_equal(g[4][k], w[4][k])
            else:
                assert g[4][k] == w[4][k]
    monkeypatch.setattr(sys, "argv", ["replay_entropy", "2"])
    jax_replay.main()
    want_text = capsys.readouterr().out
    assert replay_entropy.main(["2", small_pkts], device="cpu") == 0
    got_text = capsys.readouterr().out
    ck = [re.search(r"checksum=(\w+) ([0-9a-f]{8})", t).groups()
          for t in (got_text, want_text)]
    assert ck[0] == ck[1] and ck[0][0] == "stable"

    out = tmp_path / "dump"
    assert replay_entropy.main(["1", small_pkts, "--dump", str(out)],
                               device="cpu") == 0
    calls_bin = out / "calls.bin"
    assert calls_bin.stat().st_size > 4
    exe = str(tmp_path / "cabac_prof")
    r = subprocess.run(["gcc", "-O1", "-fno-strict-aliasing", "-I",
                        os.path.join(REPO, "libav_tpu_torch", "native"),
                        os.path.join(REPO, "libav_tpu_torch", "tools",
                                     "cabac_prof.c"), "-o", exe],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run([exe, str(calls_bin), "2"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("16 calls x 2 reps")
