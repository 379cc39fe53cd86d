"""The port's video filters and filter graphs (libav_tpu_torch/filters)
against the JAX package's (libav_tpu/filters), on the CPU.

The same seeded numpy frames go through `libav_tpu.filters.FilterGraph`
and the port's `FilterGraph(..., device="cpu")`: the port's frames hold
CPU tensors, as a decoder's do, or numpy planes, as after hwdownload.
Every output plane must equal the JAX filter's (np.array_equal,
tolerance 0), with the same frame count, timestamps and properties, and
no input plane may change (the filters never write in place). Where the
JAX filter raises, the port must raise too. The sources, the DAG graphs
of the JAX package's own tests and a `-vf` / `-filter_complex` run of
both CLIs are held the same way.
"""

import numpy as np
import pytest
import torch

from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.avutil.rational import Rational as JRational
from libav_tpu.filters.graph import FilterGraph as JGraph
from libav_tpu.filters.graph import get_filter as jget
from libav_tpu.filters.graph import list_filters as jlist
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.pixfmt import plane_dims
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.filters.graph import FilterGraph, get_filter
from libav_tpu_torch.filters.graph import list_filters
from libav_tpu_torch.tools import avconv


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


PROPS = ("width", "height", "format", "pts", "interlaced_frame",
         "top_field_first", "key_frame")


def planes_of(fmt, w, h, seed):
    """Seeded uint8 planes of a frame: a smooth ramp with noise, and a
    dark border so that blackframe and cropdetect find something."""
    rng = np.random.default_rng(seed)
    out = []
    if fmt in ("rgb24", "bgr24"):
        dims = [(3 * w, h)]
    else:
        dims = plane_dims(fmt, w, h)
    for i, (pw, ph) in enumerate(dims):
        yy, xx = np.mgrid[0:ph, 0:pw]
        p = (xx * 7 + yy * 3 + 40 * i + seed * 11) % 256
        p = p + rng.integers(-30, 31, (ph, pw))
        p[:max(1, ph // 8)] = rng.integers(0, 20, (max(1, ph // 8), pw))
        out.append(np.clip(p, 0, 255).astype(np.uint8))
    return out


def frames_of(fmt="yuv420p", w=64, h=48, n=3, seed=0, interlaced=False,
              tff=True):
    """n frames as (JAX frame, port frame) pairs over the same bytes."""
    pairs = []
    for i in range(n):
        planes = planes_of(fmt, w, h, seed + i)
        jf = JFrame(width=w, height=h, format=fmt, pts=i)
        jf.time_base = JRational(1, 25)
        jf.planes = [p.copy() for p in planes]
        tf = Frame(width=w, height=h, format=fmt, pts=i)
        tf.time_base = Rational(1, 25)
        tf.planes = [torch.from_numpy(p.copy()) for p in planes]
        for f in (jf, tf):
            f.interlaced_frame = interlaced
            f.top_field_first = tff
            f.key_frame = i == 0
        pairs.append((jf, tf))
    return pairs


def host(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def assert_same(jouts, touts, tensors=True):
    """Frame counts, properties and planes equal; the port's planes are
    tensors unless the chain ends in hwdownload (tensors=False)."""
    assert len(touts) == len(jouts)
    for k, (jf, tf) in enumerate(zip(jouts, touts)):
        for name in PROPS:
            assert getattr(tf, name) == getattr(jf, name), (k, name)
        jsar, tsar = jf.sample_aspect_ratio, tf.sample_aspect_ratio
        assert (tsar.num, tsar.den) == (jsar.num, jsar.den)
        if jf.time_base:
            assert (tf.time_base.num, tf.time_base.den) == \
                (jf.time_base.num, jf.time_base.den)
        assert len(tf.planes) == len(jf.planes)
        for i, (jp, tp) in enumerate(zip(jf.planes, tf.planes)):
            assert isinstance(tp, torch.Tensor) == tensors, (k, i)
            a, b = host(jp), host(tp)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, i)
            assert np.array_equal(a, b), (k, i)


def run_both(desc, pairs):
    """desc through both packages' graphs, each frame pushed then EOF;
    -> (JAX frames, port frames), or None where the JAX graph raised and
    the port's raised too."""
    before = [[host(p).copy() for p in tf.planes] for _, tf in pairs]
    try:
        jg = JGraph(desc)
        jouts = [o for jf, _ in pairs for o in jg.push(jf)]
        jouts += jg.push_eof()
    except Exception as e:
        with pytest.raises(Exception):
            tg = FilterGraph(desc, device="cpu")
            for _, tf in pairs:
                tg.push(tf)
            tg.push_eof()
        return None
    tg = FilterGraph(desc, device="cpu")
    touts = [o for _, tf in pairs for o in tg.push(tf)]
    touts += tg.push_eof()
    for (_, tf), planes in zip(pairs, before):
        for p, q in zip(tf.planes, planes):
            assert np.array_equal(host(p), q), "an input plane changed"
    return jouts, touts


YUV = ("yuv420p", "yuv422p", "yuv444p", "gray")
# (width, height): even, odd, narrower than the filters' radii
SHAPES = ((64, 48), (37, 23), (6, 5))

# pixel and geometry filters: every format of YUV at every shape
PIXEL = [
    "crop=32:16:6:4", "crop=20:10", "pad=80:64:8:6:16",
    "transpose=0", "transpose=1", "transpose=2", "transpose=3",
    "hflip", "vflip", "copy", "shuffleplanes=0:0:0",
    "drawbox=4:6:20:14:red", "drawbox=-2:-3:60:40:0x3366cc",
    "fade=in:0:3", "fade=out:1:2", "boxblur", "boxblur=2:1",
    "boxblur=5:2:1:1", "boxblur=0:3", "lut=c0=val*2:c1=negval",
    "lutyuv=y=negval", "lutyuv=u=clipval:v=gammaval(0.5)", "negate",
    "unsharp", "unsharp=13:13:1.5", "unsharp=3:5:-1.0:7:3:0.5",
    "hqdn3d", "hqdn3d=8:6:12:9", "gradfun", "gradfun=3.0:8",
    "delogo=x=10:y=8:w=20:h=12", "delogo=x=0:y=0:w=10:h=10:show=1",
    "delogo=x=10:y=8:w=20:h=12:band=1", "interlace", "interlace=bff:0",
    "blackframe", "blackframe=amount=0:threshold=100", "cropdetect",
    "cropdetect=limit=100:round=4:reset=2", "showinfo",
    "fieldorder=0", "fieldorder=1",
    "crop=40:30,hqdn3d,unsharp=5:5:1.0,boxblur=2:1,drawbox=4:4:16:8:red,"
    "fade=in:0:2,lutyuv=y=negval,hflip,transpose=1",
    "pad=72:52:0:4,gradfun,delogo=x=10:y=10:w=20:h=8,vflip",
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("fmt", YUV)
@pytest.mark.parametrize("desc", PIXEL)
def test_pixel_filter_matches_jax(desc, fmt, shape):
    interlaced = desc.startswith("fieldorder")
    out = run_both(desc, frames_of(fmt, *shape, interlaced=interlaced,
                                   tff=desc == "fieldorder=0"))
    if out is not None:
        assert_same(*out)


@pytest.mark.parametrize("desc", ["lutrgb=r=maxval-val:g=val/2", "lutrgb",
                                  "lut=c0=val*2:c2=negval", "negate",
                                  "hflip", "vflip", "crop=30:20:2:2",
                                  "showinfo", "copy", "pixdesctest"])
@pytest.mark.parametrize("fmt", ["rgb24", "bgr24"])
def test_packed_rgb_filter_matches_jax(desc, fmt):
    assert_same(*run_both(desc, frames_of(fmt, 37, 23)))


# timing, metadata and plumbing filters, and the swscale wrappers
PLUMBING = [
    "null", "fifo", "buffer", "buffersink", "split", "hwmap",
    "fps=12", "fps=50", "setpts=PTS*2+1", "settb=1/90000", "trim=1:2",
    "trim=start_frame=1", "select=mod(n\\,2)", "select=key",
    "setdar=dar=16/9", "setsar=sar=3/2", "nullsink", "pixdesctest",
    "format=yuv444p", "format=yuv420p", "noformat=yuv420p",
    "scale=32:24", "scale=w=48:h=-1:flags=bilinear", "hwupload,hwdownload",
    "hwdownload,hflip",
]


def test_settb_without_time_base_matches_jax():
    """settb on frames without a time base: the new base, pts kept."""
    pairs = frames_of("yuv420p", 32, 16)
    for jf, tf in pairs:
        jf.time_base, tf.time_base = JRational(0, 1), Rational(0, 1)
    jouts, touts = run_both("settb=1/90000", pairs)
    assert_same(jouts, touts)
    assert [(f.time_base.num, f.time_base.den) for f in touts] == \
        [(1, 90000)] * 3


@pytest.mark.parametrize("desc", PLUMBING)
def test_plumbing_filter_matches_jax(desc):
    out = run_both(desc, frames_of("yuv420p", 64, 48, n=4))
    if desc == "settb=1/90000":
        # the JAX filter calls Rational.to_float, which does not exist, on
        # any frame with a time base: the port raises as it does
        assert out is None
        return
    assert_same(*out, tensors=not desc.endswith("hwdownload"))


def test_numpy_planes_run_on_the_cpu():
    """After hwdownload a frame holds numpy planes: the same torch code
    runs on CPU tensors made from them."""
    pairs = frames_of("yuv420p", 37, 23)
    for _, tf in pairs:
        tf.planes = [p.numpy() for p in tf.planes]
    jouts, touts = run_both("hqdn3d,unsharp,transpose=2", pairs)
    assert_same(jouts, touts)
    assert all(p.device.type == "cpu" for f in touts for p in f.planes)


@pytest.mark.parametrize("desc", [
    "split[a][b];[a]crop=16:16:0:0[c];[b][c]overlay=x=40:y=30",
    "split[a][b];[a]hflip[c];[b][c]overlay=x=-4:y=2",
    "split[a][b];[b]vflip[c];[a][c]overlay=x=50:y=40",
    "[in]hflip[m];[m]vflip[out]",
    "split[a][b];[b]hflip[c];[a][c]framepack=sbs",
    "split[a][b];[b]hflip[c];[a][c]framepack=tab",
    "split[a][b];[b]hflip[c];[a][c]framepack=lines",
    "split[a][b];[b]hflip[c];[a][c]framepack=columns",
    "split[a][b];[b]negate[c];[a][c]framepack=frameseq",
    "split=3[a][b][c];[a]null[x];[b]vflip[y];[x][y]overlay[o];"
    "[c][o]overlay=x=2:y=2",
])
def test_dag_matches_jax(desc):
    assert_same(*run_both(desc, frames_of("yuv420p", 64, 48)))


def test_dag_errors():
    """Both packages refuse a graph with two open inputs."""
    from libav_tpu_torch.avutil.error import AVError
    with pytest.raises(AVError):
        FilterGraph("[a]hflip[b];[c]vflip[d]", device="cpu")


def test_overlay_push_secondary_matches_jax():
    """overlay fed through push_secondary, the way the CLI feeds a
    -filter_complex input: the latest overlay frame with pts <= the main
    frame's is composited."""
    main = frames_of("yuv420p", 64, 48, n=4)
    over = frames_of("yuv420p", 20, 14, n=2, seed=9)
    over[1][0].pts = over[1][1].pts = 2
    jg, tg = JGraph("overlay=x=8:y=6"), FilterGraph("overlay=x=8:y=6",
                                                    device="cpu")
    for jo, to in over:
        jg.filters[0].push_secondary(jo)
        tg.filters[0].push_secondary(to)
    assert_same([o for jf, _ in main for o in jg.push(jf)],
                [o for _, tf in main for o in tg.push(tf)])


def test_every_filter_is_registered():
    assert list_filters() == jlist()


def test_graph_device_is_validated():
    g = FilterGraph("hwupload", device="cpu")
    assert g.device == torch.device("cpu")
    assert g.filters[0].device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FilterGraph("null")


@pytest.mark.parametrize("name,args", [
    ("testsrc", "size=40x30:duration=3"), ("nullsrc", "size=32x32"),
    ("color", "color=orange:size=33x17:duration=2"),
    ("color", "color=#3366cc:size=32x16:duration=1"),
    ("rgbtestsrc", "size=30x18:duration=2"),
])
def test_video_source_matches_jax(name, args):
    want = list(jget(name)(args).generate())
    got = list(get_filter(name)(args, device="cpu").generate())
    assert_same(want, got)


def test_movie_source_matches_jax(tmp_path):
    y4m = str(tmp_path / "m.y4m")
    rng = np.random.default_rng(4)
    with open(y4m, "wb") as fh:
        fh.write(b"YUV4MPEG2 W32 H16 F25:1 Ip A1:1 C420jpeg\n")
        for _ in range(3):
            fh.write(b"FRAME\n")
            fh.write(rng.integers(0, 256, 32 * 16 * 3 // 2,
                                  dtype=np.uint8).tobytes())
    for args in (f"filename={y4m}", f"filename={y4m}:loop=2"):
        want = [f.to_host() for f in jget("movie")(args).generate()]
        got = list(get_filter("movie")(args, device="cpu").generate())
        assert len(got) == len(want) == 3 * (1 + ("loop" in args))
        assert_same(want, got)


# ---------------------------------------------------------------------- #
# the CLIs
# ---------------------------------------------------------------------- #

def _crc(tool, argv, dst, **kw):
    assert tool.main(argv + ["-f", "framecrc", dst], **kw) == 0
    with open(dst) as f:
        return f.read()


@pytest.mark.parametrize("argv", [
    ["-vf", "crop=48:32:8:8,hqdn3d,unsharp=5:5:1.0,boxblur=2:1,"
            "drawbox=4:4:20:10:red,fade=in:0:2,lutyuv=y=negval,hflip,"
            "transpose=1"],
    ["-vf", "pad=64:72:0:4,gradfun=1.2:8,delogo=x=10:y=10:w=20:h=8,vflip",
     "-pix_fmt", "rgb24"],
    ["-vf", "yadif=1"],
    ["-vf", "interlace"],
])
def test_avconv_vf_matches_jax(argv, tmp_path):
    src = ["-i", testdata.SMALL_H264]
    want = _crc(jax_avconv, src + argv, str(tmp_path / "jax.crc"))
    got = _crc(avconv, src + argv, str(tmp_path / "port.crc"), device="cpu")
    assert got == want and want.count("\n0, ") >= 1


def test_avconv_fps_matches_jax(tmp_path):
    """fps needs timestamps, which raw H.264 frames lack (both filters
    raise on them): the small stream is muxed into MP4 first."""
    mp4 = str(tmp_path / "in.mp4")
    assert jax_avconv.main(["-i", testdata.SMALL_H264, "-c", "copy",
                            mp4]) == 0
    argv = ["-i", mp4, "-vf", "fps=12"]
    want = _crc(jax_avconv, argv, str(tmp_path / "jax.crc"))
    got = _crc(avconv, argv, str(tmp_path / "port.crc"), device="cpu")
    assert got == want and want.count("\n0, ") == 3


def test_avconv_filter_complex_matches_jax(tmp_path):
    """A second input through -filter_complex: overlay of the small H.264
    stream on itself, decoded on the CLI's device."""
    src = ["-i", testdata.SMALL_H264, "-i", testdata.SMALL_H264,
           "-filter_complex", "[0:v][1:v]overlay=16:8"]
    want = _crc(jax_avconv, src, str(tmp_path / "jax.crc"))
    got = _crc(avconv, src, str(tmp_path / "port.crc"), device="cpu")
    assert got == want and want.count("\n0, ") == 4


@pytest.fixture(scope="module")
def filter_work(tmp_path_factory):
    """A directory holding bench.mp4, the port's -c copy mux of the bench
    stream (which must equal the JAX CLI's)."""
    import hashlib
    d = tmp_path_factory.mktemp("filters")
    bench = testdata.write_cli_input("h264_1080p_ipbb_cabac", str(d))
    mp4 = str(d / testdata.FILTER_MP4)
    assert avconv.main(["-i", bench, *testdata.FILTER_MP4_ARGS, mp4],
                       device="cpu") == 0
    gold = testdata.load_golden(testdata.filters_golden_path())
    with open(mp4, "rb") as f:
        assert hashlib.md5(f.read()).hexdigest() == gold["mp4"]["md5"]
    return d


@pytest.mark.slow
@pytest.mark.parametrize("run", sorted(testdata.FILTER_RUNS))
def test_filter_run_matches_golden(run, filter_work):
    """The 1080-line filter runs of the smoke script, the port on the
    CPU: each output equals the JAX CLI's committed one."""
    import hashlib
    gold = testdata.load_golden(testdata.filters_golden_path())["runs"][run]
    inputs = [a for path in testdata.filter_inputs(run, str(filter_work))
              for a in ("-i", path)]
    out = str(filter_work / (run + ".out"))
    assert avconv.main(inputs + list(testdata.FILTER_RUNS[run][1]) + [out],
                       device="cpu") == 0
    with open(out, "rb") as f:
        data = f.read()
    if "frames" in gold:
        with open(testdata.filter_run_path(run), "rb") as f:
            assert data == f.read()
    else:
        assert hashlib.md5(data).hexdigest() == gold["md5"]
