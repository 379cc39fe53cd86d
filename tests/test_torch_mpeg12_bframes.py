"""MPEG-2 frame pictures with B pictures (I B B P B B P, M=3), the path of
the benchmark configuration `mpeg2_mp_1080p`, at 176x144 on the CPU.

Seven frames of `testdata.pattern` and of its fade (`testdata.pattern_fade`)
go through the JAX MPEG-2 encoder with that configuration's settings; the
port's decoder must give the JAX decoder's frames, in display order. The
fade is there because the plain pattern only translates, so its B pictures
have no bi-predicted MB. The port's recorder splits frame-picture recon
into `mpeg2.recon.b` and `mpeg2.recon.anchor`, each inside its picture's
`mpeg2.recon`, and counts each B picture's MBs and bi-predicted MBs.
"""

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import timer
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder
from tools.gen_torch_smoke_stream import decode_reference, encode

W, H, FRAMES = 176, 144, 7
SETTINGS = testdata.MPEG2_STREAMS["mpeg2_1080p_ipbb"][1]
SOURCES = {"pattern": testdata.pattern, "fade": testdata.pattern_fade}


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


@pytest.fixture
def recorder():
    timer.disable()
    timer.reset()
    yield timer
    timer.disable()
    timer.reset()


_CACHE = {}


def stream(source):
    """(packets, JAX-decoded host planes) of the source, encoded once."""
    if source not in _CACHE:
        datas = encode(W, H, FRAMES, "mpeg2video", SETTINGS,
                       source=SOURCES[source])
        _CACHE[source] = datas, decode_reference(datas, "mpeg2video")
    return _CACHE[source]


def port_decode(datas):
    dec = find_decoder("mpeg2video")(device="cpu")
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return frames


def picture_types(datas):
    """picture_coding_type of each packet's picture, in coding order."""
    out = []
    for d in datas:
        i = d.index(b"\x00\x00\x01\x00") + 4
        out.append((d[i + 1] >> 3) & 7)
    return out


def test_the_fade_dips_toward_black():
    for t in (0, 3, 6):
        y0, u0, v0 = (p.astype(np.int32) for p in testdata.pattern(W, H, t))
        y, u, v = testdata.pattern_fade(W, H, t)
        g = 32 - 2 * t
        np.testing.assert_array_equal(y, y0 * g // 32)
        for c, c0 in ((u, u0), (v, v0)):
            np.testing.assert_array_equal(c, 128 + (c0 - 128) * g // 32)
    assert all(np.array_equal(a, b) for a, b in
               zip(testdata.pattern_fade(W, H, 0), testdata.pattern(W, H, 0)))


@pytest.mark.parametrize("source", list(SOURCES))
def test_decode_matches_jax_in_display_order(source):
    datas, ref = stream(source)
    # coded I P B B P B B, displayed I B B P B B P
    assert picture_types(datas) == [1, 2, 3, 3, 2, 3, 3]
    frames = port_decode(datas)
    assert len(frames) == len(ref) == FRAMES
    # each frame carries its packet's pts (coding order): B pictures leave
    # at once, each anchor when the next anchor arrives, the last on drain
    assert [f.pts for f in frames] == [0, 2, 3, 1, 5, 6, 4]
    for f, r in zip(frames, ref):
        for got, want in zip(f.to_host().planes, r):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", list(SOURCES))
def test_b_and_anchor_recon_spans(recorder, source):
    datas, _ = stream(source)
    types = picture_types(datas)
    recorder.enable()
    port_decode(datas)
    records = recorder.records()
    recon = {r[5]["pic"]: r for r in records if r[0] == "mpeg2.recon"}
    assert len(recon) == FRAMES
    inner = [r for r in records
             if r[0] in ("mpeg2.recon.b", "mpeg2.recon.anchor")]
    assert len(inner) == FRAMES
    for r, kind in zip(inner, types):
        assert r[0] == ("mpeg2.recon.b" if kind == 3 else
                        "mpeg2.recon.anchor")
        if kind != 3:
            assert r[5]["type"] == "IP"[kind - 1]
        outer = recon[r[5]["pic"]]
        assert r[1] == "mpeg2.recon" and r[2] == outer[2]
        assert outer[3] <= r[3] <= r[4] <= outer[4]
    stats = recorder.stats()
    assert stats["mpeg2.recon.b"][0] == types.count(3) == 4
    assert stats["mpeg2.recon.anchor"][0] == types.count(1) + \
        types.count(2) == 3
    counters = recorder.counters()
    mbs = ((W + 15) // 16) * ((H + 15) // 16)
    assert counters["mpeg2.mb.b"] == 4 * mbs
    bipred = counters.get("mpeg2.mb.bipred", 0)
    if source == "fade":
        assert bipred >= 1
    else:
        assert bipred == 0          # pure translation: one anchor suffices
