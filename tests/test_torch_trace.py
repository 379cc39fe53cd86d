"""The port's span-and-counter recorder (`libav_tpu_torch/avutil/timer.py`)
and the spans the decoders keep with it: exact aggregates from many
threads, records only while recording is on, records on the host clock
with their parent and tag, and exact span counts from decoding the 64x64
H.264 test stream, small PAFF and MBAFF streams (the field path's spans)
and a short MPEG-2 stream."""

import functools
import json
import re
import sys
import threading
import time

import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import timer
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs import find_decoder, find_encoder
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.h264 import dec as h264dec
from libav_tpu_torch.codecs.h264 import nal
from libav_tpu_torch.codecs.h264.device import ReconH264
from libav_tpu_torch.native import mpeg12_slice
from libav_tpu_torch.ops import h264intra
from libav_tpu_torch.bitstream.getbits import GetBits
from libav_tpu_torch.formats.h264raw import split_access_units

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_recorder():
    timer.disable()
    timer.reset()
    yield
    timer.disable()
    timer.reset()


def spans_named(name):
    return [r for r in timer.records() if r[0] == name]


# -- the recorder ------------------------------------------------------- #

@pytest.mark.parametrize("recording", [False, True])
def test_threads_give_exact_aggregates(recording):
    """8 threads x 1,000 spans and counts, switching often, with a reader
    merging all the while: no update is lost, none is counted twice."""
    threads, per = 8, 1000
    if recording:
        timer.enable()
    start = threading.Barrier(threads + 1)
    done = threading.Event()
    errors = []

    def work(k):
        start.wait(timeout=60)
        for i in range(per):
            with timer.timer("stress.span", worker=k):
                timer.count("stress.count", 2)

    def read():
        start.wait(timeout=60)
        try:
            while not done.is_set():
                timer.stats()
                timer.counters()
                timer.records()
        except Exception as e:      # a torn merge would raise here
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        reader = threading.Thread(target=read)
        for t in pool + [reader]:
            t.start()
        for t in pool:
            t.join(timeout=120)
        done.set()
        reader.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool + [reader])
    assert errors == []
    n, total, mn, mx = timer.stats()["stress.span"]
    assert n == threads * per
    assert 0 <= mn <= mx and total >= n * mn
    assert timer.counters()["stress.count"] == 2 * threads * per
    assert timer._STATS["stress.span"][0] == threads * per
    recs = spans_named("stress.span")
    assert len(recs) == (threads * per if recording else 0)
    if recording:
        assert sorted({r[5]["worker"] for r in recs}) == list(range(8))
        counts = spans_named("stress.count")
        assert len(counts) == threads * per
        assert all(r[1] == "stress.span" and r[5]["n"] == 2
                   for r in counts)


def test_records_only_while_recording_and_report_as_before():
    with timer.timer("off.span", au=3):
        pass
    timer.count("off.count")
    assert timer.records() == []
    timer.enable()
    with timer.timer("on.span"):
        pass
    timer.disable()
    with timer.timer("off.span"):
        pass
    assert [r[0] for r in timer.records()] == ["on.span"]
    # the aggregates are kept either way, in the JAX timer's report format
    assert timer.stats()["off.span"][0] == 2
    assert timer.counters() == {"off.count": 1}
    rep = timer.report()
    assert re.search(r"^ *\d+\.\d us avg in off\.span \(n=2, min=\d+\.\d, "
                     r"max=\d+\.\d\)$", rep, re.M)
    n0, s0 = h264dec.host_entropy_stats()
    assert (n0, s0) == (0, 0.0)
    with timer.timer("h264.entropy"):
        time.sleep(0.002)
    n1, s1 = h264dec.host_entropy_stats()
    assert n1 == 1 and s1 >= 0.002
    assert (n1, s1) == tuple(timer._STATS["h264.entropy"][:2])
    timer._STATS.clear()
    assert dict(timer._STATS) == {} and timer.report() == ""


def test_records_lie_on_the_host_clock_with_parent_and_tag():
    timer.enable()
    before = time.perf_counter()
    with timer.timer("outer", au=7):
        with timer.timer("inner", path="native"):
            timer.count("inner.count", 5)
        box = []
        t = threading.Thread(target=lambda: box.append(
            timer.timer("worker", au=7).__enter__().__exit__()))
        t.start()
        t.join(timeout=60)
    after = time.perf_counter()
    recs = {r[0]: r for r in timer.records()}
    assert set(recs) == {"outer", "inner", "inner.count", "worker"}
    for name, parent, thread, t0, t1, tag in recs.values():
        assert before <= t0 <= t1 <= after
    assert recs["outer"][1] is None and recs["outer"][5] == {"au": 7}
    assert recs["inner"][1] == "outer"
    assert recs["inner"][5] == {"au": 7, "path": "native"}
    assert recs["outer"][3] <= recs["inner"][3] <= recs["inner"][4] \
        <= recs["outer"][4]
    assert recs["inner.count"][1] == "inner"
    assert recs["inner.count"][5] == {"au": 7, "path": "native", "n": 5}
    # another thread: no parent there, its own tag, its own name
    assert recs["worker"][1] is None and recs["worker"][5] == {"au": 7}
    assert recs["worker"][2] != recs["outer"][2]
    assert [r[0] for r in timer.records()] == ["outer", "inner",
                                               "inner.count", "worker"]


def test_spans_are_ranges_of_the_profiler_trace(tmp_path):
    with timer.device_trace(str(tmp_path)) as path:
        with timer.timer("traced.span"):
            torch.ones(8).sum()
    with timer.timer("untraced.span"):
        pass
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "traced.span" in names
    assert timer.stats()["traced.span"][0] == 1


# -- the decoders' spans ------------------------------------------------- #

def h264_aus():
    with open(testdata.SMALL_H264, "rb") as f:
        return list(split_access_units(f.read()))


def h264_slice_types(aus):
    """The slice type of each slice of each AU, from the slice headers."""
    out = []
    for au in aus:
        types = []
        for n in nal.split_annexb(au):
            if nal.nal_header(n)[1] in (nal.NAL_SLICE, nal.NAL_IDR):
                gb = GetBits(nal.unescape(n[1:]))
                gb.get_ue_golomb()                  # first_mb_in_slice
                types.append(gb.get_ue_golomb() % 5)
        out.append(types)
    return out


def decode(codec, datas):
    dec = find_decoder(codec)(device=CPU)
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        return [f.to_host() for f in frames]
    finally:
        dec.close()


@pytest.mark.parametrize("path", ["native", "python"])
def test_h264_span_counts(monkeypatch, path):
    if path == "python":
        monkeypatch.setenv("LIBAV_TPU_NO_NATIVE", "1")
    aus = h264_aus()
    types = h264_slice_types(aus)
    intra = [0]
    wavefront = ReconH264._wavefront

    def counted(self, *a, **kw):
        intra[0] += 1
        return wavefront(self, *a, **kw)
    monkeypatch.setattr(ReconH264, "_wavefront", counted)
    decode("h264", aus)                 # builds the programs
    timer.reset()
    timer.enable()
    frames = decode("h264", aus)
    counts = {name: s[0] for name, s in timer.stats().items()}
    nslices = sum(len(t) for t in types)
    assert (len(aus), nslices, len(frames)) == (4, 16, 4)
    assert counts["h264.entropy"] == counts["h264.entropy.wait"] == 4
    assert counts["h264.recon"] == counts["upload"] == 4
    assert counts["h264.entropy.slice"] == nslices
    assert counts["download"] == len(frames)
    assert counts["h264.recon.intra"] == intra[0] // 2 >= 1
    assert timer.counters().get("programs.built", 0) == 0
    assert timer.counters()["upload.bytes"] == sum(
        r[5]["n"] for r in spans_named("upload.bytes")) > 0
    # one identifier per AU across threads: entropy on the worker, its
    # slices on the slice pool or in line, the wait and recon here
    for au, want in enumerate(types):
        of = [r for r in timer.records() if r[5].get("au") == au]
        names = [r[0] for r in of]
        assert names.count("h264.entropy") == 1
        assert names.count("h264.entropy.slice") == len(want)
        assert names.count("h264.entropy.wait") == 1
        recon = [r for r in of if r[0] == "h264.recon"]
        assert [r[5]["pict"] for r in recon] == \
            [{2: "I", 1: "B"}.get(want[0], "P")]
        assert {r[5]["path"] for r in of
                if r[0] == "h264.entropy.slice"} == {path}
    assert {r[1] for r in spans_named("h264.recon.intra")} == {"h264.recon"}
    # frame pictures: no field span
    assert not spans_named("h264.recon.field") + spans_named("h264.weave")


@functools.lru_cache(maxsize=None)
def ext_stream(name):
    """The 96x64 CABAC stream of an interlaced `testdata.H264_EXT` family
    (field pictures and MBAFF need a height that is a multiple of 32),
    encoded once by the port's H.264 encoder on the CPU, whose packets
    are the JAX package's byte for byte (test_torch_h264_encode*.py) and
    take seconds where the JAX encoder's compile takes half a minute:
    (packets, frames)."""
    _, _, n, opts = testdata.H264_EXT[name]
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                          width=96, height=64, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder("h264")(par, device=CPU)
    for k, v in dict(opts, entropy="cabac").items():
        enc.set_opt(k, v)
    frames = []
    for t in range(n):
        f = Frame.alloc_video(96, 64, "yuv420p")
        f.planes = list(testdata.pattern(96, 64, t))
        f.pts = t
        frames.append(f)
    return [p.data for p in enc.encode_all(frames)], n


def test_h264_field_pictures_open_field_spans():
    """PAFF: each field picture reconstructs inside `h264.recon.field`
    (tag `par`), each frame is woven inside `h264.weave` (src paff), and
    every field slice goes through the native CABAC."""
    datas, n = ext_stream("h264_1088i_paff")
    nslices = sum(len(t) for t in h264_slice_types(datas))
    timer.enable()
    frames = decode("h264", datas)
    assert len(frames) == n and len(datas) == 2 * n
    assert (frames[0].width, frames[0].height) == (96, 64)
    field = spans_named("h264.recon.field")
    assert len(field) == 2 * n
    assert {r[1] for r in field} == {"h264.recon"}
    assert [r[5]["par"] for r in field] == [0, 1] * n
    weave = spans_named("h264.weave")
    assert len(weave) == n
    assert {r[5]["src"] for r in weave} == {"paff"}
    paths = [r[5]["path"] for r in spans_named("h264.entropy.slice")]
    assert paths == ["native"] * nslices and nslices >= 2 * n


def test_h264_mbaff_frames_weave_their_halves():
    """All-field MBAFF: each frame's two halves are woven inside
    `h264.weave` (src mbaff) within its `h264.recon`; no field picture."""
    datas, n = ext_stream("h264_1088i_mbaff")
    timer.enable()
    frames = decode("h264", datas)
    assert len(frames) == n
    weave = spans_named("h264.weave")
    assert len(weave) == n
    assert {(r[1], r[5]["src"]) for r in weave} == {("h264.recon", "mbaff")}
    assert spans_named("h264.recon.field") == []


def test_h264_cpu_decode_takes_the_plain_wavefront(monkeypatch):
    """On CPU tensors ReconH264.forward runs the plain twin: `_wavefront`
    runs once per intra assembly, and neither the kernel's launch count
    nor the recorder's `h264.intra.kernel` counter moves."""
    calls = [0]
    wavefront = ReconH264._wavefront

    def counted(self, *a, **kw):
        calls[0] += 1
        return wavefront(self, *a, **kw)
    monkeypatch.setattr(ReconH264, "_wavefront", counted)
    launches = h264intra.h264_intra_frame.launches
    timer.enable()
    decode("h264", h264_aus())
    assert calls[0] == timer.stats()["h264.recon.intra"][0] >= 1
    assert h264intra.h264_intra_frame.launches == launches
    assert "h264.intra.kernel" not in timer.counters()


def mpeg2_stream(fieldpic):
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg2video",
                          width=64, height=64, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder("mpeg2video")(par, device=CPU)
    for k, v in {"qscale": 6, "gop_size": 8, "fieldpic": fieldpic}.items():
        enc.set_opt(k, v)
    frames = []
    for t in range(3):
        f = Frame.alloc_video(64, 64, "yuv420p")
        f.planes = list(testdata.pattern(64, 64, t))
        f.pts = t
        frames.append(f)
    return [p.data for p in enc.encode_all(frames)]


@pytest.mark.parametrize("fieldpic", [0, 1])
def test_mpeg2_span_counts(fieldpic):
    datas = mpeg2_stream(fieldpic)
    slices = sum(len(re.findall(rb"\x00\x00\x01[\x01-\xaf]", d))
                 for d in datas)
    pictures = sum(d.count(b"\x00\x00\x01\x00") for d in datas)
    decode("mpeg2video", datas)         # builds the programs
    timer.reset()
    timer.enable()
    frames = decode("mpeg2video", datas)
    counts = {name: s[0] for name, s in timer.stats().items()}
    assert len(frames) == 3 and pictures == 3 * (1 + fieldpic)
    assert counts["mpeg2.entropy"] == slices >= pictures
    assert counts["mpeg2.recon"] == pictures
    # one upload per picture, and one more per field pair (its weave)
    assert counts["upload"] == pictures + fieldpic * len(frames)
    assert counts["download"] == len(frames)
    counters = timer.counters()
    assert counters.get("programs.built", 0) == 0
    # one engine counter per slice: all native once the library is built
    native = counters.get("mpeg2.slice.native", 0)
    assert native + counters.get("mpeg2.slice.python", 0) == slices
    if mpeg12_slice.available():
        assert native == slices
    recs = timer.records()
    for pic in range(pictures):
        names = [r[0] for r in recs if r[5].get("pic") == pic]
        assert names.count("mpeg2.recon") == 1
        assert names.count("mpeg2.entropy") >= 1


@pytest.mark.parametrize("codec", ["h264", "mpeg2video"])
def test_programs_are_built_once(codec):
    datas = h264_aus() if codec == "h264" else mpeg2_stream(1)
    from libav_tpu_torch.codecs import mpegvideo
    from libav_tpu_torch.codecs.h264 import device
    for f in (device.recon_h264, device.recon_h264_sparse, mpegvideo.recon,
              mpegvideo.recon_field, mpegvideo.weave_fields):
        f.cache_clear()
    decode(codec, datas)
    first = timer.counters()["programs.built"]
    decode(codec, datas)
    assert first >= 2
    assert timer.counters()["programs.built"] == first
