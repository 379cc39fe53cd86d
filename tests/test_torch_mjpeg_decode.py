"""The PyTorch port's MJPEG decoder against the JAX package's.

Small JPEGs come from tests/test_mjpeg.py's synthetic frames and encoder
(4:2:0, 4:2:2, 4:4:4 and gray) and from PIL (one progressive file); the
committed 1080p stream is held against its golden. The JAX decoder and
the port's decoder on the CPU must give identical planes, one frame at a
time and as a batch, with one IDCT call per component per call.
"""

import io

import numpy as np
import pytest
import torch

from libav_tpu.avutil.frame import Packet
from libav_tpu.codecs.api import find_decoder as jax_find
from libav_tpu_torch import testdata
from libav_tpu_torch.codecs import find_decoder
from libav_tpu_torch.codecs.mjpeg import MJPEGDecoder
from libav_tpu_torch.codecs.mjpeg import dec as tdec
from libav_tpu_torch.ops import idct as tidct
from test_mjpeg import encode, synth_frame

FORMATS = ["yuvj420p", "yuvj422p", "yuvj444p", "gray"]


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _jpeg(fmt, seed=0, w=72, h=40):
    return encode(synth_frame(w, h, fmt, seed=seed), 85)


def _progressive_jpeg():
    PIL = pytest.importorskip("PIL.Image")
    yy, xx = np.mgrid[0:40, 0:56]
    arr = np.stack([(xx * 3 + yy).astype(np.uint8),
                    (128 + 60 * np.sin(xx / 5.0)).astype(np.uint8),
                    ((xx * yy) % 251).astype(np.uint8)], axis=2)
    buf = io.BytesIO()
    PIL.fromarray(arr, "RGB").save(buf, "JPEG", quality=88, progressive=True)
    data = buf.getvalue()
    assert b"\xff\xc2" in data
    return data


def _host(frames):
    return [[np.asarray(p) for p in f.to_host().planes] for f in frames]


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for gp, rp in zip(g, r):
            assert gp.dtype == np.uint8
            np.testing.assert_array_equal(gp, rp)


def _decode(datas, dec):
    return dec.decode_all(Packet(data=d, pts=i) for i, d in enumerate(datas))


@pytest.mark.parametrize("fmt", FORMATS + ["progressive"])
def test_decode_matches_jax(fmt):
    data = _progressive_jpeg() if fmt == "progressive" else _jpeg(fmt)
    ref = _decode([data], jax_find("mjpeg")())
    got = _decode([data], MJPEGDecoder(device="cpu"))
    _assert_same(_host(got), _host(ref))
    assert got[0].format == ref[0].format
    assert isinstance(got[0].planes[0], torch.Tensor)


def test_batch_matches_jax():
    datas = [_jpeg("yuvj420p", seed=s) for s in range(3)]
    ref = jax_find("mjpeg")().open().decode_jpeg_batch(datas)
    got = MJPEGDecoder(device="cpu").open().decode_jpeg_batch(datas)
    _assert_same(_host(got), _host(ref))


def test_one_idct_per_component_per_call(monkeypatch):
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int_plain(blocks)
    monkeypatch.setattr(tidct, "idct8x8_int", counted)
    datas = [_jpeg("yuvj420p", seed=s) for s in range(2)]
    _decode(datas, MJPEGDecoder(device="cpu"))
    # 72x40 4:2:0: 5x3 MCUs of 4 luma blocks, 5x3 per chroma plane
    assert calls == [60, 15, 15] * 2
    calls.clear()
    MJPEGDecoder(device="cpu").open().decode_jpeg_batch(datas)
    assert calls == [120, 30, 30]


def test_registry_is_the_port_own():
    assert find_decoder("mjpeg") is MJPEGDecoder
    assert jax_find("mjpeg") is not MJPEGDecoder
    with pytest.raises(TypeError):
        MJPEGDecoder()


def test_programs_reach_no_jax_global():
    dec = MJPEGDecoder(device="cpu")
    for name in tdec._DEVICE_METHODS:
        g = getattr(dec, name).__func__.__globals__
        assert g["_reconstruct_plane_jit"].__module__ == tdec.__name__
        assert g["_reconstruct_plane_batch_jit"].__module__ == tdec.__name__
        assert g["Frame"].__module__ == "libav_tpu_torch.avutil.frame"


def test_committed_stream_matches_golden():
    """The chip smoke's MJPEG path on the CPU: the committed 1080p stream
    decodes to the golden the JAX package wrote."""
    path, golden = testdata.stream_paths(testdata.MJPEG_SMOKE)
    datas = testdata.read_packets(path)
    got = testdata.digest(_host(_decode(datas, MJPEGDecoder(device="cpu"))))
    assert got == testdata.load_golden(golden)
    batch = MJPEGDecoder(device="cpu").open().decode_jpeg_batch(datas)
    assert testdata.digest(_host(batch)) == got
