"""The PyTorch port's FFV1 codec held against the JAX package's.

FFV1 is host code in both packages: the port's copy decodes on the host
and uploads each finished frame to its device, and its encoder takes
frames from any device. The same seeded numpy frames go through the JAX
encoder and decoder (on the CPU) and the port's on the CPU: every coder
(Golomb-Rice, the range coder with the default and with the custom
state-transition table) with both context models, in gray and every
planar YUV layout, over a 3-frame GOP (so the context state carries into
two non-key frames); then the CLI path (8-bit rawvideo into .avi, then
framecrc). Lossless and integer-exact: packets byte for byte, and the
decode equal to the JAX decode and to the source.
"""

import hashlib

import numpy as np
import pytest
import torch

from libav_tpu.avutil.frame import Frame as JaxFrame
from libav_tpu.avutil.frame import Packet as JaxPacket
from libav_tpu.codecs.api import CodecParameters as JaxParameters
from libav_tpu.codecs.api import find_decoder as jax_find_decoder
from libav_tpu.codecs.api import find_encoder as jax_find_encoder
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_decoder, find_encoder)
from libav_tpu_torch.codecs.ffv1.dec import FFV1Decoder
from libav_tpu_torch.codecs.ffv1.enc import FFV1Encoder
from libav_tpu_torch.tools import avconv

CPU = torch.device("cpu")
W, H = 22, 18          # not a multiple of any chroma subsampling


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _frames(fmt, n, seed):
    """n frames of fmt: a moving gradient with noise and flat patches (so
    the Golomb coder's run mode starts and stops), as (JAX frames, port
    frames) over the same numpy planes."""
    rng = np.random.default_rng(seed)
    jf, tf = [], []
    for t in range(n):
        j = JaxFrame.alloc_video(W, H, fmt)
        p = Frame.alloc_video(W, H, fmt)
        for i, plane in enumerate(j.planes):
            ph, pw = plane.shape
            yy, xx = np.mgrid[0:ph, 0:pw]
            a = (xx * 7 + yy * 3 + 11 * t + 50 * i +
                 rng.integers(0, 24, (ph, pw))) % 256
            a[: ph // 2, : pw // 2] = 128
            j.planes[i] = a.astype(np.uint8)
            p.planes[i] = a.astype(np.uint8)
        j.pts = p.pts = t
        jf.append(j)
        tf.append(p)
    return jf, tf


@pytest.mark.parametrize("coder", [0, 1, 2])
@pytest.mark.parametrize("context", [0, 1])
@pytest.mark.parametrize("fmt", ["gray", "yuv420p", "yuv422p", "yuv444p",
                                 "yuv410p", "yuv411p"])
def test_gop_matches_jax_and_is_lossless(coder, context, fmt):
    jf, tf = _frames(fmt, 3, seed=coder * 10 + context)
    jax_enc = jax_find_encoder("ffv1")(JaxParameters(
        codec_type="video", codec_id="ffv1", width=W, height=H,
        pix_fmt=fmt))
    port = find_encoder("ffv1")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="ffv1", width=W, height=H,
        pix_fmt=fmt))
    for enc in (jax_enc, port):
        enc.set_opt("coder", coder)
        enc.set_opt("context", context)
        enc.set_opt("gop_size", 3)
    want = jax_enc.encode_all(jf)
    got = port.encode_all(tf)
    assert [p.data for p in got] == [p.data for p in want]
    assert [p.flags for p in got] == [p.flags for p in want] == [1, 0, 0]

    jdec = jax_find_decoder("ffv1")(JaxParameters(
        codec_type="video", codec_id="ffv1", width=W, height=H))
    tdec = find_decoder("ffv1")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="ffv1", width=W, height=H),
        device="cpu")
    jout = jdec.decode_all(JaxPacket(data=p.data, pts=i)
                           for i, p in enumerate(want))
    tout = tdec.decode_all(Packet(data=p.data, pts=i)
                           for i, p in enumerate(want))
    assert len(tout) == len(jout) == 3
    for src, j, t in zip(tf, jout, tout):
        assert t.format == j.format == fmt
        assert all(isinstance(p, torch.Tensor) and p.device == CPU
                   for p in t.planes)
        host = t.to_host().planes
        assert len(host) == len(j.planes) == len(src.planes)
        for a, b, s in zip(host, j.to_host().planes, src.planes):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, s)


def test_encoder_takes_tensor_frames():
    """Planes on a device (here the CPU's tensors) come to the host once:
    the packets equal those of the numpy planes."""
    jf, tf = _frames("yuv420p", 2, seed=4)
    for f in tf:
        f.planes = [torch.as_tensor(p) for p in f.planes]
    par = dict(codec_type=MediaType.VIDEO, codec_id="ffv1", width=W,
               height=H, pix_fmt="yuv420p")
    jax_enc = jax_find_encoder("ffv1")(JaxParameters(**par))
    port = find_encoder("ffv1")(CodecParameters(**par))
    assert [p.data for p in port.encode_all(tf)] == \
        [p.data for p in jax_enc.encode_all(jf)]


def test_registration_and_devices():
    assert find_decoder("ffv1") is FFV1Decoder
    assert find_encoder("ffv1") is FFV1Encoder
    assert not FFV1Encoder.DEVICE_PART
    assert FFV1Decoder(device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FFV1Decoder()


def test_first_frame_not_key_fails_like_jax():
    jf, tf = _frames("yuv420p", 2, seed=6)
    par = dict(codec_type=MediaType.VIDEO, codec_id="ffv1", width=W,
               height=H, pix_fmt="yuv420p")
    data = [p.data for p in jax_find_encoder("ffv1")(
        JaxParameters(**par)).encode_all(jf)]
    errors = []
    for dec, pkt in ((jax_find_decoder("ffv1")(JaxParameters(**par)),
                      JaxPacket),
                     (find_decoder("ffv1")(CodecParameters(**par),
                                           device="cpu"), Packet)):
        try:
            dec.decode_all([pkt(data=data[1], pts=0)])
        except Exception as e:   # both raise their package's AVError
            errors.append((type(e).__name__, str(e)))
    assert len(errors) == 2 and errors[0] == errors[1]
    assert "keyframe" in errors[0][1]


def test_golden_source_and_lossless_decode():
    """The card's smoke run encodes `pattern` at 1080p with FFV1 and holds
    the packets to the JAX encoder's: the planes are the golden's, and the
    golden's decode digests are those of the source (lossless)."""
    gold = testdata.load_golden(testdata.ffv1_golden_path())
    sources = [testdata.pattern(*testdata.PRORES_SIZE, t)
               for t in range(testdata.PRORES_FRAMES)]
    assert [testdata.plane_adler32(p) for p in sources] == gold["source"]
    assert testdata.digest(sources) == gold["decode"]
    assert [p["key"] for p in gold["packets"]] == [True, False]


@pytest.mark.parametrize("opts", [["-frames:v", "2"], ["-g", "1"]])
def test_cli_rawvideo_to_avi_matches_jax(opts, tmp_path):
    """`-f rawvideo -pix_fmt yuv420p -s 96x64 -i in.yuv ... -c:v ffv1
    out.avi` and `-i out.avi -f framecrc` through both CLIs."""
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for t in range(3):
            for p in testdata.pattern(96, 64, t):
                f.write(p.tobytes())
    argv = ["-f", "rawvideo", "-pix_fmt", "yuv420p", "-s", "96x64", "-i",
            str(src), *opts, "-c:v", "ffv1"]
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        avi = str(tmp_path / f"{name}.avi")
        crc = str(tmp_path / f"{name}.crc")
        assert tool.main(argv + [avi], **kw) == 0
        assert tool.main(["-i", avi, "-f", "framecrc", crc], **kw) == 0
        with open(avi, "rb") as f, open(crc) as g:
            out[name] = (hashlib.md5(f.read()).hexdigest(), g.read())
    assert out["port"] == out["jax"]
    assert b"FFV1" in (tmp_path / "port.avi").read_bytes()
    assert out["jax"][1].count("\n0, ") == (2 if "-frames:v" in opts else 3)
