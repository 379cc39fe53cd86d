"""The H.264 decoder's choice of entropy engine (`dec._engine`) and what
each engine hands `_reconstruct`.

The chooser's table: each case names the facts of a slice and the
engine that must take it. Then a small CABAC P stream with partitioned
macroblocks, decoded once on the native engine and once on the twin
(LIBAV_TPU_NO_NATIVE): the C motion export (`export_blocks`, and
`col_pack` for the reference pictures) runs only on the cabac engine,
the numpy transport only on the twin, and both decodes equal the JAX
decoder's frames.
"""

import functools

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs import find_encoder
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.h264 import H264Decoder
from libav_tpu_torch.codecs.h264 import dec as h264dec
from libav_tpu_torch.codecs.h264 import device as _device
from libav_tpu_torch.native import h264_cabac_host, h264_cavlc
from tools.gen_torch_smoke_stream import decode_reference

CPU = torch.device("cpu")
P, B, I = h264dec.SLICE_P, h264dec.SLICE_B, h264dec.SLICE_I


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# (entropy, slice type, field_pic, MBAFF, temporal direct, twin only,
#  LIBAV_TPU_NO_NATIVE, native library loaded) -> engine
ENGINE = {
    "cabac_p": (("cabac", P, 0, 0, 0, 0, 0, 1), "cabac"),
    "cabac_b": (("cabac", B, 0, 0, 0, 0, 0, 1), "cabac"),
    "cabac_i": (("cabac", I, 0, 0, 0, 0, 0, 1), "cabac"),
    "cabac_field": (("cabac", P, 1, 0, 0, 0, 0, 1), "cabac"),
    "cabac_mbaff": (("cabac", P, 0, 1, 0, 0, 0, 1), "python"),
    "cabac_temporal": (("cabac", B, 0, 0, 1, 0, 0, 1), "python"),
    "cabac_twin": (("cabac", P, 0, 0, 0, 1, 0, 1), "python"),
    "cabac_no_native": (("cabac", P, 0, 0, 0, 0, 1, 1), "python"),
    "cabac_unloaded": (("cabac", P, 0, 0, 0, 0, 0, 0), "python"),
    "cavlc_i": (("cavlc", I, 0, 0, 0, 0, 0, 1), "cavlc"),
    "cavlc_p": (("cavlc", P, 0, 0, 0, 0, 0, 1), "cavlc"),
    "cavlc_b": (("cavlc", B, 0, 0, 0, 0, 0, 1), "python"),
    "cavlc_temporal": (("cavlc", B, 0, 0, 1, 0, 0, 1), "python"),
    "cavlc_field": (("cavlc", P, 1, 0, 0, 0, 0, 1), "python"),
    "cavlc_mbaff": (("cavlc", P, 0, 1, 0, 0, 0, 1), "python"),
    "cavlc_twin": (("cavlc", P, 0, 0, 0, 1, 0, 1), "python"),
    "cavlc_no_native": (("cavlc", I, 0, 0, 0, 0, 1, 1), "python"),
    "cavlc_unloaded": (("cavlc", P, 0, 0, 0, 0, 0, 0), "python"),
}


@pytest.mark.parametrize("case", list(ENGINE))
def test_engine_table(case, monkeypatch):
    (entropy, st, field, mbaff, temporal, twin, no_native,
     loaded), want = ENGINE[case]
    if no_native:
        monkeypatch.setenv("LIBAV_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("LIBAV_TPU_NO_NATIVE", raising=False)
    if loaded:
        assert h264_cabac_host.available() and h264_cavlc.available()
    else:
        monkeypatch.setattr(h264_cabac_host, "available", lambda: False)
        monkeypatch.setattr(h264_cavlc, "available", lambda: False)
    assert h264dec._engine(entropy == "cabac", st, bool(field),
                           bool(mbaff), bool(temporal), bool(twin)) == want


@functools.lru_cache(maxsize=None)
def p_stream():
    """4 frames of a 64x64 CABAC stream, I then P with every partition
    shape and the deblock, from the port's encoder on the CPU (its
    packets are the JAX encoder's, test_torch_h264_encode*.py)."""
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                          width=64, height=64, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder("h264")(par, device=CPU)
    for k, v in {"qp": 28, "gop_size": 8, "entropy": "cabac",
                 "deblock": 1, "parts": "all"}.items():
        enc.set_opt(k, v)
    frames = []
    for t in range(4):
        f = Frame.alloc_video(64, 64, "yuv420p")
        f.planes = list(testdata.pattern(64, 64, t))
        f.pts = t
        frames.append(f)
    return tuple(p.data for p in enc.encode_all(frames))


def traced_decode(datas):
    """The port's decode on the CPU -> (host planes per frame, one
    (engine, part, export_blocks calls) per picture, col_pack calls)."""
    calls = {"export": 0, "col": 0}
    export, col_pack = h264_cabac_host.export_blocks, h264_cabac_host.col_pack
    reconstruct = H264Decoder._reconstruct
    factory = _device.recon_h264_sparse
    pictures = []

    def counted(name, inner):
        def spy(*a, **kw):
            calls[name] += 1
            return inner(*a, **kw)
        return spy

    def program(*key, **flags):
        pictures[-1][1] = flags["part"]
        return factory(*key, **flags)

    def recon(self, fd, slice_info):
        pictures.append([fd.engine, None, calls["export"]])
        out = reconstruct(self, fd, slice_info)
        pictures[-1][2] = calls["export"] - pictures[-1][2]
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(h264_cabac_host, "export_blocks",
                  counted("export", export))
        m.setattr(h264_cabac_host, "col_pack", counted("col", col_pack))
        m.setattr(_device, "recon_h264_sparse", program)
        m.setattr(H264Decoder, "_reconstruct", recon)
        dec = H264Decoder(device="cpu")
        try:
            frames = dec.decode_all(Packet(data=d, pts=i)
                                    for i, d in enumerate(datas))
        finally:
            dec.close()
    return ([f.to_host().planes for f in frames],
            [tuple(p) for p in pictures], calls["col"])


def test_motion_export_follows_the_engine(monkeypatch):
    datas = list(p_stream())
    want = decode_reference(datas)
    monkeypatch.delenv("LIBAV_TPU_NO_NATIVE", raising=False)
    native, native_pics, native_cols = traced_decode(datas)
    monkeypatch.setenv("LIBAV_TPU_NO_NATIVE", "1")
    twin, twin_pics, twin_cols = traced_decode(datas)
    assert len(want) == len(native) == len(twin) == len(datas) == 4
    for got in (native, twin):
        for g, w in zip(got, want):
            for gp, wp in zip(g, w):
                np.testing.assert_array_equal(gp, wp)
    # every picture is a reference: col_pack once a picture, natively
    assert native_cols == 4 and twin_cols == 0
    assert {e for e, _, _ in native_pics} == {"cabac"}
    assert {e for e, _, _ in twin_pics} == {"python"}
    # the P pictures take the block-granular transport: the C export on
    # the cabac engine, the numpy one (no export call) on the twin
    assert [p for _, p, _ in native_pics] == \
        [p for _, p, _ in twin_pics] == [False, True, True, True]
    assert [n for _, _, n in native_pics] == [0, 1, 1, 1]
    assert [n for _, _, n in twin_pics] == [0, 0, 0, 0]


@pytest.mark.parametrize("grid", ["int8", "strided"])
def test_c_export_refuses_other_grids(grid):
    """The C motion export reads the arena's int32 grids through raw
    pointers: any other grid raises, none is read."""
    bref = np.zeros((2, 8, 16), np.int32)
    bmv = np.zeros((2, 8, 16, 2), np.int32)
    if grid == "int8":
        bref = bref.astype(np.int8)
    else:
        bref, bmv = bref[:, :, ::2], bmv[:, :, ::2]
    pocs = np.zeros(2, np.int32)
    with pytest.raises(ValueError):
        h264_cabac_host.col_pack(bref, bmv, pocs, pocs)
    with pytest.raises(ValueError):
        h264_cabac_host.export_blocks(bref, bmv, None, 1, 1, None, None,
                                      want_b=False, want_pid=False,
                                      want_nnz=False, zero_bmv1=False)
