"""The PyTorch port's MSMPEG4 v2, v3 and WMV1 decoders held against the
JAX package.

The streams come from `tools/legacy_streams.py` (the repository has no
MSMPEG4 encoder), which writes the (code, length) pairs of
`codecs/msmpeg4_tables.py` directly: the RL tables with all three escape
modes, the DC tables, the MV tables with their escape, I-picture
coded-block prediction, slices, flip-flop rounding, and WMV1's per-MB RL
selection and ESC3 widths. A stream counts only if the JAX decoder
decodes every macroblock with no concealment. The same packets go
through the JAX decoder and the port's on the CPU, also inside AVI and
through both CLIs; the tolerance is exact equality.
"""

import collections

import pytest
import torch

from libav_tpu.formats.api import FormatContext as JFormatContext
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.codecs.api import find_decoder
from libav_tpu_torch.codecs.msmpeg4dec import (MSMPEG4v2Decoder,
                                               MSMPEG4v3Decoder,
                                               WMV1Decoder)
from libav_tpu_torch.formats.api import FormatContext
from libav_tpu_torch.tools import avconv
from tools import legacy_streams as L
from test_torch_h263_decode import (_demux, _mux, assert_same, frames,
                                    jax_decode,
                                    jax_faults, packages,  # noqa: F401
                                    port_decode)

CPU = torch.device("cpu")
CODECS = {2: "msmpeg4v2", 3: "msmpeg4v3", 4: "wmv1"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("version,w,h,kw", [
    (3, 64, 48, {}),
    (3, 96, 64, {"slices": 2, "qscale": 4}),
    (3, 50, 38, {"gop": 3}),
    (2, 64, 48, {}),
    (2, 96, 64, {"slices": 2, "gop": 2}),
    (4, 96, 64, {"bitrate": 200, "per_mb_rl": True, "slices": 2}),
    (4, 64, 48, {"bitrate": 200, "qscale": 5}),
    (4, 336, 240, {"bitrate": 40}),
])
def test_msmpeg4_matches_jax(version, w, h, kw, jax_faults):
    used = collections.Counter()
    datas = L.msmpeg4_stream(frames(w, h, 4), 80 + version + w, version,
                             w, h, used=used, **kw)
    want = assert_same(CODECS[version], datas, w, h)
    assert jax_faults == []
    assert want[0][0].shape == (h, w)
    for form in ("vlc", "esc1", "esc2", "esc3", "intra", "inter"):
        assert used[form] > 0, form


def test_msmpeg4_aliases_and_devices():
    assert find_decoder("msmpeg4") is find_decoder("msmpeg4v3") is \
        MSMPEG4v3Decoder
    assert find_decoder("msmpeg4v2") is MSMPEG4v2Decoder
    assert find_decoder("wmv1") is find_decoder("msmpeg4v4") is WMV1Decoder
    assert WMV1Decoder(device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MSMPEG4v3Decoder()


@pytest.mark.parametrize("version", [3, 4])
def test_damaged_picture_is_concealed_alike(version, jax_faults):
    datas = L.msmpeg4_stream(frames(96, 64, 3), 90 + version, version,
                             96, 64, bitrate=200)
    assert_same(CODECS[version], testdata.cut_packet(datas, 1), 96, 64)
    assert any("concealing" in m for m in jax_faults)


def test_one_idct_per_picture(monkeypatch):
    from libav_tpu_torch.codecs import mpegvideo as tmv
    from libav_tpu_torch.ops import idct as tidct
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int(blocks)
    monkeypatch.setattr(tmv, "idct8x8_int", counted)
    for version in (2, 3, 4):
        datas = L.msmpeg4_stream(frames(64, 48, 2), 95, version, 64, 48,
                                 bitrate=200)
        port_decode(CODECS[version], datas, 64, 48)
    assert calls == [12 * 6] * 6


@pytest.mark.parametrize("version", [2, 3, 4])
def test_avi_and_cli_match_jax(version, tmp_path):
    """The stream inside AVI (FourCC MP42, MP43 or WMV1): the muxers'
    bytes, the demuxed packets and both CLIs' framecrc are the same."""
    codec = CODECS[version]
    datas = L.msmpeg4_stream(frames(64, 48, 3), 99, version, 64, 48,
                             bitrate=200)
    jp, tp = packages()
    want = _mux(jp, tmp_path / "jax.avi", "avi", codec, 64, 48, datas)
    assert _mux(tp, tmp_path / "port.avi", "avi", codec, 64, 48,
                datas) == want
    jname, jpkts = _demux(JFormatContext, tmp_path / "jax.avi")
    assert _demux(FormatContext, tmp_path / "jax.avi") == (jname, jpkts)
    assert [p[0] for p in jpkts] == datas
    out = {}
    for tag, tool, kw in (("jax", jax_avconv, {}),
                          ("port", avconv, {"device": "cpu"})):
        dst = tmp_path / f"{tag}.crc"
        assert tool.main(["-i", str(tmp_path / "jax.avi"), "-f", "framecrc",
                          str(dst)], **kw) == 0
        out[tag] = dst.read_text()
    assert out["port"] == out["jax"] and out["jax"].count("\n0, ") == 3


def test_wmv1_first_rl_fault_matches_jax():
    """WMV1 with per-MB RL selection whose first intra MB codes nothing:
    the JAX decoder reads the RL index of a block it does not decode
    before any MB has set one and raises AttributeError out of the
    decode (ROADMAP.md §3). The port raises the same."""
    w = L.MSMPEG4Writer(96, 64, 7, 4, bitrate=200, per_mb_rl=True)
    w.first_rl = False
    datas = [w.picture(frames(96, 64, 1)[0], 0, 8)]
    for decode in (jax_decode, port_decode):
        with pytest.raises(AttributeError, match="_rl"):
            decode("wmv1", datas, 96, 64)
