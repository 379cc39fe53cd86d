"""The port's swscale against the JAX package's, on the CPU: the plain
version of kernel `sws_yuv2rgb` against `_yuv_rgb_jit` (XLA), the
bit-exact plane scaler against `scale_plane_jit`, RGB -> YUV, whole
frames through `SwsContext.scale_frame`, the yuv4mpeg container and the
rawvideo decoder, and the port's avconv `-pix_fmt`/`-s` against the JAX
CLI. The same numpy inputs, made from a seed, go to both packages.

Every comparison is exact. RGB -> YUV is also held on adversarial
frames (`testdata.rgb2yuv_frame`): blocks on which the port's rounding
steps and another order of the same float32 arithmetic give different
bytes, found by `tools/gen_rgb2yuv_samples.py`.
"""

import importlib.util
import itertools
import json
import os

import numpy as np
import pytest
import torch

from libav_tpu import swscale as jsw
from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.formats.api import open_input as jax_open_input
from libav_tpu.swscale.bitexact import scale_plane_jit
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import swscale as tsw
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.formats.api import open_input
from libav_tpu_torch.swscale.bitexact import scale_plane
from libav_tpu_torch.swscale.yuv2rgb import (constants, fma, yuv2rgb,
                                             yuv2rgb_plain)
from libav_tpu_torch.tools import avconv


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


SUBSAMPLING = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "410": (2, 2),
               "411": (2, 0), "440": (0, 1)}
# subsamplings with a full-range (yuvj) pixel format; the others take
# full range from the "pc" color range
YUVJ = ("420", "422", "444")


def _planes(seed, h, w, sw, sh):
    rng = np.random.default_rng(seed)
    ch, cw = -(-h >> sh), -(-w >> sw)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8))


@pytest.mark.parametrize("out_fmt", ["rgb24", "bgr24"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (480, 640),
                                (37, 53), (97, 71)])
def test_yuv2rgb_matches_xla(hw, sub, full, out_fmt):
    """SwsContext._yuv_to_rgb of both packages on the same planes: 0
    differing bytes."""
    (h, w), (sw, sh) = hw, SUBSAMPLING[sub]
    src_fmt = ("yuvj" if full and sub in YUVJ else "yuv") + sub + "p"
    color_range = "pc" if full and sub not in YUVJ else "tv"
    planes = _planes(h + 7 * sw + 3 * sh, h, w, sw, sh)
    want = jsw.SwsContext(w, h, src_fmt, w, h, out_fmt)._yuv_to_rgb(
        list(planes), src_fmt, out_fmt, color_range)[0]
    got = tsw.SwsContext(w, h, src_fmt, w, h, out_fmt,
                         device="cpu")._yuv_to_rgb(
        [torch.from_numpy(p) for p in planes], src_fmt, out_fmt,
        color_range)[0]
    assert got.dtype == torch.uint8 and got.shape == (h, 3 * w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv2rgb_wrapper_takes_plain_version_on_cpu():
    y, u, v = (torch.from_numpy(p) for p in _planes(5, 16, 24, 1, 1))
    before = yuv2rgb.launches
    assert torch.equal(yuv2rgb(y, u, v, 1, 1, True, True),
                       yuv2rgb_plain(y, u, v, 1, 1, True, True))
    assert yuv2rgb.launches == before


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("algo", sorted(
    set(tsw.SwsContext._ALGO_OF_FLAG.values())))
def test_plane_scaler_matches_jax(algo, direction):
    """The bit-exact scaler's torch program against scale_plane_jit."""
    sw_, sh_, dw, dh = (64, 48, 40, 30) if direction == "down" else \
        (37, 29, 80, 61)
    rng = np.random.default_rng(len(algo))
    plane = rng.integers(0, 256, (sh_, sw_), dtype=np.uint8)
    want = np.asarray(scale_plane_jit(sw_, sh_, dw, dh, algo)(plane))
    got = scale_plane(sw_, sh_, dw, dh, algo, "cpu")(torch.from_numpy(plane))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


RGB2YUV_FORMATS = ["yuv444p", "yuvj444p", "yuv422p", "yuvj422p", "yuv420p",
                   "yuvj420p", "yuv410p", "yuv411p", "yuv440p"]


def _rgb_to_yuv_both(rgb, h, w, dst_fmt):
    """SwsContext._rgb_to_yuv of the JAX package and of the port on the
    CPU, the same rgb24 frame: lists of numpy planes."""
    want = jsw.SwsContext(w, h, "rgb24", w, h, dst_fmt)._rgb_to_yuv(
        [rgb], "rgb24", dst_fmt)
    got = tsw.SwsContext(w, h, "rgb24", w, h, dst_fmt,
                         device="cpu")._rgb_to_yuv(
        [torch.from_numpy(rgb)], "rgb24", dst_fmt)
    return [np.asarray(a) for a in want], [b.numpy() for b in got]


@pytest.mark.parametrize("dst_fmt", RGB2YUV_FORMATS)
@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (480, 640),
                                (37, 53)])
def test_rgb_to_yuv_matches_xla(hw, seed, dst_fmt):
    """Random rgb24 frames (seed None: h + len(fmt)): 0 differing
    bytes."""
    h, w = hw
    rng = np.random.default_rng(h + len(dst_fmt) if seed is None else seed)
    rgb = rng.integers(0, 256, (h, 3 * w), dtype=np.uint8)
    for a, b in zip(*_rgb_to_yuv_both(rgb, h, w, dst_fmt)):
        assert a.shape == b.shape and b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)


# mean_order's 4:1:0 answer at the shapes of the test below: vectorised
# when no column is edge-padded
ORDER_410 = {(1080, 1920): "pairs", (720, 1280): "pairs", (37, 53): "rows",
             (71, 255): "rows", (72, 127): "rows", (135, 241): "rows"}


@pytest.mark.parametrize("dst_fmt", RGB2YUV_FORMATS)
@pytest.mark.parametrize("hw,order", [((1080, 1920), "rows"),
                                      ((720, 1280), "rows"),
                                      ((37, 53), "pairs"),
                                      ((71, 255), "pairs"),
                                      ((72, 127), "pairs"),
                                      ((135, 241), "rows")])
def test_rgb_to_yuv_adversarial_matches_xla(hw, order, dst_fmt):
    """testdata.rgb2yuv_frame: blocks on which the port's rounding and
    another order of the same arithmetic differ, each at every chroma
    column of the 1080-line frame, at shapes on both sides of
    `mean_order` (its 4:2:0 answer given; 4:1:0's in ORDER_410): 0
    differing bytes."""
    h, w = hw
    sub = SUBSAMPLING[dst_fmt[-4:-1]]
    assert tsw.mean_order(h, w, *sub, dst_fmt.startswith("yuvj")) == {
        (1, 1): order, (2, 2): ORDER_410[hw]}.get(sub, "rows")
    rgb = testdata.rgb2yuv_frame(h, w, dst_fmt)
    if h == 1080:       # every unit at every chroma column
        chroma_rows = h >> sub[1]
        assert len(testdata.rgb2yuv_units(dst_fmt)) <= chroma_rows
    for a, b in zip(*_rgb_to_yuv_both(rgb, h, w, dst_fmt)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, a)


# (h, w) -> mean_order's answer for yuv420p, yuvj420p and yuv410p: the
# edges of its rules (tools/check_rgb2yuv_order.py read XLA's bytes at
# each)
ORDER_EDGES = {
    (8, 123): ("rows", "rows", "pairs"), (8, 125): ("rows", "rows", "rows"),
    (1080, 124): ("rows", "rows", "pairs"),
    (1080, 125): ("rows", "rows", "rows"),
    (5, 3): ("pairs", "pairs", "pairs"), (5, 5): ("pairs", "pairs", "rows"),
    (1081, 1920): ("rows", "rows", "pairs"),
    (1081, 1921): ("rows", "rows", "rows"),
    (1080, 1918): ("rows", "rows", "rows"), (4, 2): ("rows", "rows", "rows"),
    (3, 1): ("rows", "rows", "rows"), (1, 2): ("pairs", "pairs", "colpairs"),
    (2, 1): ("pairs", "pairs", "pairs"), (2, 7): ("pairs", "rows", "rows"),
    (2, 1920): ("pairs", "rows", "pairs"),
    (2, 127): ("pairs", "pairs", "rows"), (2, 129): ("rows", "rows", "rows"),
    (5, 1): ("rows", "rows", "pairs"), (16, 255): ("pairs", "pairs", "rows"),
    (5, 127): ("pairs", "pairs", "rows"), (5, 129): ("rows", "rows", "rows"),
    (16, 1024): ("rows", "rows", "pairs"),
}
EDGE_FORMATS = ("yuv420p", "yuvj420p", "yuv410p")


@pytest.mark.parametrize("dst_fmt", EDGE_FORMATS)
@pytest.mark.parametrize("hw", list(ORDER_EDGES))
def test_rgb_to_yuv_order_edges_match_xla(hw, dst_fmt):
    """RGB -> YUV at the shapes where `mean_order` changes its answer,
    on the adversarial frames: mean_order as read, 0 differing bytes."""
    h, w = hw
    sub = SUBSAMPLING[dst_fmt[-4:-1]]
    assert tsw.mean_order(h, w, *sub, dst_fmt.startswith("yuvj")) == \
        ORDER_EDGES[hw][EDGE_FORMATS.index(dst_fmt)]
    rgb = testdata.rgb2yuv_frame(h, w, dst_fmt)
    for a, b in zip(*_rgb_to_yuv_both(rgb, h, w, dst_fmt)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, a)


def _sample_search():
    spec = importlib.util.spec_from_file_location(
        "gen_rgb2yuv_samples", os.path.join(
            os.path.dirname(__file__), "..", "tools",
            "gen_rgb2yuv_samples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dst_fmt", RGB2YUV_FORMATS)
def test_rgb2yuv_samples_have_teeth(dst_fmt):
    """Every committed unit gives another byte under the alternative it
    was found for than under the port's rule (numpy, the search's own
    arithmetic)."""
    gen = _sample_search()
    full = dst_fmt.startswith("yuvj")
    with open(testdata.RGB2YUV_SAMPLES) as f:
        units = json.load(f)["samples"]["full" if full else "limited"][
            dst_fmt[-4:-1]]
    assert units
    for unit in units:
        comp, alt = unit["what"].split()
        rgb = np.array(unit["rgb"], np.float32)
        r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        port = gen.component(comp, full, "port", r, g, b)
        if comp == "Y":
            other = gen.component(comp, full, alt, r, g, b)
            assert (gen.to_byte(port) != gen.to_byte(other)).any(), unit
            continue
        shape = gen.BLOCK[dst_fmt[-4:-1]]
        if alt in gen.ORDER_ALTS:
            other = gen.block_mean(port[None], shape, alt)
        else:
            other = gen.block_mean(
                gen.component(comp, full, alt, r, g, b)[None], shape)
        assert gen.to_byte(gen.block_mean(port[None], shape))[0] != \
            gen.to_byte(other)[0], unit


def _fma_exact(a, b, c):
    """float32 a*b+c with one rounding: the product is exact in float64,
    the sum is rounded to odd in float64 (TwoSum), then to float32."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even,
                 np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _fma_port(a, b, c):
    c = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.asarray(c, np.float32), a.shape)))
    return fma(torch.from_numpy(a), float(b), c).numpy()


@pytest.mark.parametrize("chain", ["rgb2yuv", "yuv2rgb_limited",
                                   "yuv2rgb_full"])
def test_fma_emulation_rounds_once(chain):
    """yuv2rgb.fma (float64 product and sum, then float32) equals a
    correctly rounded float32 FMA at every step of the port's rules, on
    all 2^24 inputs of each (in four slices)."""
    f32 = np.float32
    for part in range(4):
        v = np.arange(part << 22, (part + 1) << 22, dtype=np.uint32)
        a = (v >> 16).astype(f32)
        b = ((v >> 8) & 255).astype(f32)
        c = (v & 255).astype(f32)
        steps = []
        if chain == "rgb2yuv":
            for k0, k1, k2 in ((0.299, 0.587, 0.114),
                               (-0.168736, -0.331264, 0.5),
                               (0.5, -0.418688, -0.081312)):
                k0, k1, k2 = f32(k0), f32(k1), f32(k2)
                t1 = _fma_exact(a, k0, b * k1)
                t = _fma_exact(c, k2, t1)
                steps += [(a, k0, b * k1), (c, k2, t1)]
                for scale, off in ((219.0, 16.0), (224.0, 128.0)):
                    steps.append((t, f32(scale * f32(1.0 / 255.0)), off))
        else:
            full = chain == "yuv2rgb_full"
            ky, oy, kru, kgu, kgv, kbv = (f32(k) for k in constants(full))
            ys, uc, vc = (a - oy).astype(f32), b - 128, c - 128
            yf = ys * ky
            steps += [(ys, ky, kru * vc), (vc, kru, yf), (uc, kbv, yf),
                      (ys, ky, kbv * uc), (ys, ky, kgu * uc),
                      (uc, kgu, yf), (vc, kgv, _fma_exact(uc, kgu, yf)),
                      (vc, kgv, _fma_exact(ys, ky, kgu * uc))]
        for x, k, y in steps:
            np.testing.assert_array_equal(_fma_port(x, k, y),
                                          _fma_exact(x, k, y))


FRAME_CASES = [
    ("yuv420p", "yuv444p", None), ("yuv420p", "yuv420p", (40, 30)),
    ("yuv420p", "gray", None), ("gray", "yuv420p", (24, 18)),
    ("rgb24", "bgra", None), ("rgba", "rgb24", (30, 20)),
    ("yuv420p", "nv12", None), ("yuvj422p", "rgb24", None),
    ("rgb24", "yuvj420p", None), ("yuv444p", "bgr24", None),
]


@pytest.mark.parametrize("src_fmt,dst_fmt,size", FRAME_CASES)
def test_scale_frame_matches_jax(src_fmt, dst_fmt, size):
    """Whole frames through both SwsContexts (scaling, gray, the host
    RGB reorder and the packing layer): the same planes."""
    w, h = 48, 36
    dw, dh = size or (w, h)
    src = JFrame.alloc_video(w, h, src_fmt)
    rng = np.random.default_rng(len(src_fmt + dst_fmt))
    src.planes = [rng.integers(0, 256, p.shape, dtype=np.uint8)
                  for p in src.planes]
    want = jsw.SwsContext(w, h, src_fmt, dw, dh, dst_fmt).scale_frame(src)
    frame = Frame(width=w, height=h, format=src_fmt)
    frame.planes = [torch.from_numpy(p) for p in src.planes]
    got = tsw.SwsContext(w, h, src_fmt, dw, dh, dst_fmt,
                         device="cpu").scale_frame(frame)
    assert (got.width, got.height, got.format, got.color_range) == \
        (want.width, want.height, want.format, want.color_range)
    assert len(got.planes) == len(want.planes)
    for a, b in zip(want.planes, got.to_host().planes):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("src_fmt,dst_fmt,size", [
    ("yuv420p", "rgb24", None), ("yuvj422p", "bgr24", None),
    ("yuv420p", "yuv420p", (40, 30)), ("rgba", "rgb24", (30, 20))])
def test_scale_frame_numpy_planes_on_cpu(src_fmt, dst_fmt, size):
    """A frame of numpy planes through SwsContext.get(device="cpu"): the
    planes are uploaded to the context's device (the CPU), and the output
    equals the JAX package's scale_frame."""
    w, h = 48, 36
    dw, dh = size or (w, h)
    src = JFrame.alloc_video(w, h, src_fmt)
    rng = np.random.default_rng(len(src_fmt) + 3 * len(dst_fmt))
    src.planes = [rng.integers(0, 256, p.shape, dtype=np.uint8)
                  for p in src.planes]
    want = jsw.SwsContext(w, h, src_fmt, dw, dh, dst_fmt).scale_frame(src)
    frame = Frame(width=w, height=h, format=src_fmt)
    frame.planes = [p.copy() for p in src.planes]
    sws = tsw.SwsContext.get(w, h, src_fmt, dw, dh, dst_fmt, device="cpu")
    assert sws.device == torch.device("cpu")
    got = sws.scale_frame(frame)
    assert (got.width, got.height, got.format) == \
        (want.width, want.height, want.format)
    for a, b in zip(want.planes, got.to_host().planes):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_sws_context_defaults_to_cuda(monkeypatch):
    """Without CUDA the default device raises; nothing runs on the CPU
    unless the caller says device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(tsw.SwsContext, "_yuv_to_rgb",
                        lambda *a, **k: calls.append(a))
    for make in (tsw.SwsContext, tsw.SwsContext.get):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(48, 36, "yuv420p", 48, 36, "rgb24")
    assert calls == []
    cpu = tsw.SwsContext.get(48, 36, "yuv420p", 48, 36, "rgb24",
                             device="cpu")
    assert cpu.device == torch.device("cpu")
    assert cpu is tsw.SwsContext.get(48, 36, "yuv420p", 48, 36, "rgb24",
                                     device="cpu")


# ---------------------------------------------------------------------- #
# yuv4mpeg, rawvideo and the CLI
# ---------------------------------------------------------------------- #

def _framecrc(tool, src, dst, *opts, **kw):
    assert tool.main(["-i", src, *opts, "-f", "framecrc", dst], **kw) == 0
    with open(dst) as f:
        return f.read()


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    """The committed 64x64 H.264 file as a yuv4mpeg file, by the JAX
    CLI."""
    path = str(tmp_path_factory.mktemp("y4m") / "small.y4m")
    assert jax_avconv.main(["-i", testdata.SMALL_H264, "-f",
                            "yuv4mpegpipe", path]) == 0
    return path


def _packets(fc):
    out = []
    while True:
        try:
            pkt = fc.read_frame()
        except Exception:
            return out
        if pkt is None:
            return out
        out.append((pkt.data, pkt.pts))


def test_yuv4mpeg_demux_matches_jax(y4m):
    want = _packets(jax_open_input(y4m))
    got = _packets(open_input(y4m))
    assert len(want) == 4 and got == want


def test_rawvideo_decoder_uploads_to_its_device(y4m):
    from libav_tpu_torch.codecs import find_decoder
    fc = open_input(y4m)
    par = fc.streams[0].codecpar
    dec = find_decoder(par.codec_id)(par, device="cpu")
    frames = dec.decode_all(fc.read_frame() for _ in range(1))
    assert frames and all(isinstance(p, torch.Tensor) for p in
                          frames[0].planes)
    assert dec.device == torch.device("cpu")


@pytest.mark.parametrize("src,opts", list(itertools.product(
    ["h264", "y4m"], [("-pix_fmt", "rgb24"), ("-pix_fmt", "bgr24"),
                      ("-s", "40x24"), ("-s", "96x80", "-sws_flags",
                                        "lanczos"),
                      ("-pix_fmt", "yuv444p"), ("-pix_fmt", "gray")])))
def test_avconv_scale_matches_jax(src, opts, y4m, tmp_path):
    """-pix_fmt and -s through both CLIs: identical framecrc."""
    path = testdata.SMALL_H264 if src == "h264" else y4m
    want = _framecrc(jax_avconv, path, str(tmp_path / "jax.crc"), *opts)
    got = _framecrc(avconv, path, str(tmp_path / "port.crc"), *opts,
                    device="cpu")
    assert got == want and want.count("\n0, ") == 4


def test_avconv_writes_yuv4mpeg_like_jax(y4m, tmp_path):
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        out[name] = tmp_path / f"{name}.y4m"
        assert tool.main(["-i", y4m, "-pix_fmt", "yuv444p", "-f",
                          "yuv4mpegpipe", str(out[name])], **kw) == 0
    assert out["port"].read_bytes() == out["jax"].read_bytes()
