"""The PyTorch port's MJPEG encoder held against the JAX package's.

The same seeded frames go through the JAX encoder (on the CPU) and the
port's MJPEGEncoder on the CPU: 4:2:0, 4:2:2, 4:4:4 and gray, sizes that
are not whole MCUs (the planes are edge-padded on the device), quality
and qscale, with the native C packer and with the Python one; the plane
program (EncodePlane) against _encode_plane_jit, and jpeg_quant against
the JAX package's and its numpy twin. Integer-exact, so the tolerance is
exact equality: packets byte for byte.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.avutil.frame import Frame as JaxFrame
from libav_tpu.codecs.api import CodecParameters as JaxParameters
from libav_tpu.codecs.api import find_encoder as jax_find_encoder
from libav_tpu.codecs.mjpeg import enc as jenc
from libav_tpu.ops import quant as jquant
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_encoder)
from libav_tpu_torch.codecs.mjpeg import MJPEGEncoder
from libav_tpu_torch.codecs.mjpeg import enc as tenc
from libav_tpu_torch.native import jpeg_enc
from libav_tpu_torch.ops import quant as tquant
from libav_tpu_torch.tools import avconv

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _frames(fmt, w, h, n, seed):
    """n frames of fmt: a gradient with noise, as (JAX frames, port
    frames) over the same numpy planes."""
    rng = np.random.default_rng(seed)
    jf, tf = [], []
    for t in range(n):
        j = JaxFrame.alloc_video(w, h, fmt)
        p = Frame.alloc_video(w, h, fmt)
        for i, plane in enumerate(j.planes):
            ph, pw = np.asarray(plane).shape
            yy, xx = np.mgrid[0:ph, 0:pw]
            a = ((xx * 5 + yy * 3 + 17 * t + 40 * i
                  + rng.integers(0, 40, (ph, pw))) % 256).astype(np.uint8)
            j.planes[i] = a
            p.planes[i] = a.copy()
        j.pts = p.pts = t
        jf.append(j)
        tf.append(p)
    return jf, tf


def _encode_both(fmt, w, h, n, settings, seed=1):
    jf, tf = _frames(fmt, w, h, n, seed)
    jax_enc = jax_find_encoder("mjpeg")(JaxParameters(
        codec_type="video", codec_id="mjpeg", width=w, height=h,
        pix_fmt=fmt))
    port = find_encoder("mjpeg")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mjpeg", width=w, height=h,
        pix_fmt=fmt), device="cpu")
    for k, v in settings.items():
        jax_enc.set_opt(k, v)
        port.set_opt(k, v)
    want = [p.data for p in jax_enc.encode_all(jf)]
    got = [p.data for p in port.encode_all(tf)]
    return got, want, port


@pytest.mark.parametrize("fmt,w,h,settings", [
    ("yuvj420p", 64, 48, {"quality": 90}),
    ("yuvj420p", 37, 29, {"quality": 75}),
    ("yuv422p", 48, 32, {"quality": 50}),
    ("yuvj422p", 33, 17, {"qscale": 6}),
    ("yuvj444p", 24, 40, {"quality": 95}),
    ("yuv444p", 17, 9, {"qscale": 2}),
    ("gray", 40, 24, {"quality": 60}),
    ("gray", 31, 13, {"qscale": 20}),
])
@pytest.mark.parametrize("packer", ["native", "python"])
def test_packets_match_jax(fmt, w, h, settings, packer, monkeypatch):
    if packer == "native":
        if not jpeg_enc.available():
            pytest.skip("no C compiler for the native packer")
    else:
        monkeypatch.setattr(jpeg_enc, "available", lambda: False)
    got, want, port = _encode_both(fmt, w, h, 2, settings, seed=w + h)
    assert len(got) == len(want) == 2
    for g, wnt in zip(got, want):
        assert g == wnt
    assert port.packer == packer


def test_native_packer_builds_here():
    """The C packer builds on this host (the card's host asserts it in
    chip_smoke.py), and the encoder records that it packed."""
    assert jpeg_enc.available()
    got, want, port = _encode_both("yuvj420p", 16, 16, 1, {})
    assert got == want and port.packer == "native"


@pytest.mark.parametrize("bh,bw,qual", [(2, 3, 90), (5, 4, 30)])
def test_plane_program_matches_jax(bh, bw, qual):
    rng = np.random.default_rng(bh * 10 + bw)
    plane = rng.integers(0, 256, (8 * bh, 8 * bw)).astype(np.uint8)
    from libav_tpu_torch.codecs.mjpeg import tables as T
    q = T.scale_quant_table(T.STD_LUMINANCE_QUANT, qual)
    want = jenc._encode_plane_jit(bh, bw)(jnp.asarray(plane), q)
    got = tenc.encode_plane(bh, bw, device=CPU)(torch.as_tensor(plane),
                                                torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jpeg_quant():
    rng = np.random.default_rng(5)
    c = rng.integers(-20000, 20000, (50, 64)).astype(np.int32)
    q = rng.integers(1, 255, 64).astype(np.int32) * 8
    c[0, :8] = q[:8] // 2 * np.array([1, -1, 1, -1, 3, -3, 0, 1])   # ties
    got = tquant.jpeg_quant(torch.as_tensor(c), torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), jquant.jpeg_quant_ref(c, q))
    np.testing.assert_array_equal(got.numpy(), tquant.jpeg_quant_ref(c, q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jquant.jpeg_quant(jnp.asarray(c), q)))


def test_tensor_planes_and_default_device():
    _, tf = _frames("yuvj420p", 32, 32, 1, 3)
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg",
                          width=32, height=32, pix_fmt="yuvj420p")
    enc = MJPEGEncoder(par, device="cpu")
    want = enc.encode_all(tf)[0].data
    f = tf[0]
    f.planes = [torch.as_tensor(p) for p in f.planes]
    assert MJPEGEncoder(par, device="cpu").encode_all([f])[0].data == want
    assert find_encoder("mjpeg") is MJPEGEncoder and MJPEGEncoder.DEVICE_PART
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MJPEGEncoder(par)


def test_avconv_mjpeg_avi_matches_jax(tmp_path):
    """`avconv -c:v mjpeg -q:v 4` into AVI (the CLI run of chip_smoke.py's
    phase 18, on the 64x64 bench stream): the same bytes."""
    name, args = testdata.ENCODE_CLI["out.avi"]
    out = {}
    for tag, tool, kw in (("jax", jax_avconv, {}),
                          ("port", avconv, {"device": "cpu"})):
        out[tag] = tmp_path / f"{tag}.avi"
        assert tool.main(["-i", testdata.SMALL_H264, *args,
                          str(out[tag])], **kw) == 0
    want = out["jax"].read_bytes()
    assert out["port"].read_bytes() == want and b"MJPG" in want
