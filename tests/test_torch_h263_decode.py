"""The PyTorch port's H.263 and FLV1 decoders, raw H.263 and FLV
containers held against the JAX package.

The streams come from `tools/legacy_streams.py` (the repository has no
H.263 encoder): every picture-header form the decoders parse, the
standard source formats, custom sizes, both FLV escape formats, DQUANT,
vectors reaching outside the picture. A stream counts only if the JAX
decoder decodes every macroblock of it with no concealment (its log
warnings and its conceal_missing calls are captured). The same packets go
through the JAX decoder and the port's on the CPU; the codecs are
integer-exact, so the tolerance is exact equality: every frame's planes,
every demuxed packet, every framecrc line.
"""

import collections

import numpy as np
import pytest
import torch

from libav_tpu.avutil import log as jlog
from libav_tpu.avutil.error import AVError as JAVError
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.codecs import er as jer
from libav_tpu.codecs import mpegvideo as jmv
from libav_tpu.codecs.api import CodecParameters as JParams
from libav_tpu.codecs.api import find_decoder as jax_find_decoder
from libav_tpu.formats.api import FormatContext as JFormatContext
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.codecs import mpegvideo as tmv
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.api import find_decoder
from libav_tpu_torch.codecs.h263dec import FLV1Decoder, H263Decoder
from libav_tpu_torch.formats.api import FormatContext
from libav_tpu_torch.tools import avconv
from tools import legacy_streams as L
from test_torch_mpeg4_encode import _eq_tree

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_faults(monkeypatch):
    """The JAX decoders' log warnings and concealed MB counts."""
    out = []

    def warning(obj, fmt, *args):
        out.append(fmt % args if args else fmt)
    conceal = jer.conceal_missing

    def counted(*args):
        n = conceal(*args)
        out.append(f"concealed {n} MBs")
        return n
    monkeypatch.setattr(jlog, "warning", warning)
    monkeypatch.setattr(jer, "conceal_missing", counted)
    return out


def frames(w, h, n):
    return [testdata.pattern(w, h, t) for t in range(n)]


def jax_decode(codec, datas, w=0, h=0):
    dec = jax_find_decoder(codec)(JParams(codec_type="video", codec_id=codec,
                                          width=w, height=h))
    try:
        out = dec.decode_all(JPacket(data=d, pts=i)
                             for i, d in enumerate(datas))
    finally:
        dec.close()
    return [[np.asarray(p) for p in f.to_host().planes] for f in out]


def port_decode(codec, datas, w=0, h=0):
    dec = find_decoder(codec)(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=w, height=h),
        device="cpu")
    try:
        out = dec.decode_all(Packet(data=d, pts=i)
                             for i, d in enumerate(datas))
    finally:
        dec.close()
    return [[p.cpu().numpy() for p in f.planes] for f in out]


def assert_same(codec, datas, w=0, h=0):
    want = jax_decode(codec, datas, w, h)
    got = port_decode(codec, datas, w, h)
    assert len(got) == len(want) == len(datas)
    assert testdata.digest(got) == testdata.digest(want)
    return want


# ---------------------------------------------------------------------- #
# H.263


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_h263_formats_match_jax(fmt, jax_faults):
    """sub-QCIF, QCIF and CIF with the standard PTYPE header: COD, intra
    and inter MCBPC with and without DQUANT, CBPY, MVDs, TCOEF escapes
    (the 11-bit extension too), INTRADC, PEI bytes; an I picture every 3."""
    w, h = L.H263_FORMATS[fmt]
    used = collections.Counter()
    datas = L.h263_stream(frames(w, h, 4), 10 + fmt, fmt, gop=3,
                          used=used)
    assert_same("h263", datas)
    assert jax_faults == []
    for form in ("skip", "intra", "inter", "dquant", "escape"):
        assert used[form] > 0, form


@pytest.mark.parametrize("kw", [
    dict(fmt=6, width=100, height=60, custom_pcf=True, par15=True),
    dict(fmt=6, width=64, height=36),
    dict(fmt=2),
])
def test_h263_plusptype_matches_jax(kw, jax_faults):
    """PLUSPTYPE: UFEP 1 then 0, the custom picture format (with an
    extended PAR) or a standard one, custom PCF, and the rounding type of
    the P pictures."""
    w, h = (kw["width"], kw["height"]) if kw["fmt"] == 6 else (176, 144)
    datas = L.h263_stream(frames(w, h, 4), 20 + w, header="plus", **kw)
    want = assert_same("h263", datas)
    assert jax_faults == []
    assert want[0][0].shape == (h, w)


def test_h263_damaged_picture_is_concealed_alike(jax_faults):
    """A P picture cut in half: both decoders conceal its lost MBs the
    same way."""
    datas = L.h263_stream(frames(176, 144, 3), 30, 2)
    assert_same("h263", testdata.cut_packet(datas, 1))
    assert any("concealed" in m for m in jax_faults)


def test_h263_stuffing_conceals_like_jax(jax_faults):
    """An MCBPC stuffing code: the JAX decoder moves on to the next MB
    and leaves this one undecoded, so it is concealed (ROADMAP.md §3:
    the reference decoder reads the MB's type again after stuffing). The
    port does the same."""
    from libav_tpu_torch.bitstream import PutBits
    from libav_tpu_torch.codecs.mpeg4 import tables as T
    w = L.H263Writer(128, 96, 31, fmt=1)
    datas = [w.picture(frames(128, 96, 1)[0], 0, 8)]
    pb = PutBits()
    w._std_header(pb, 1, 8)
    nmb = w.mb_w * w.mb_h
    pb.put_bits(1, 0)                         # COD 0
    pb.put_bits(T.INTER_MCBPC_BITS[20], T.INTER_MCBPC_CODE[20])
    for _ in range(nmb - 1):
        pb.put_bits(1, 1)                     # the rest skipped
    pb.align(pad_bit=0)
    datas.append(pb.flush())
    want = assert_same("h263", datas)
    assert "concealed 1 MBs" in jax_faults
    assert len(want) == 2


def test_one_idct_per_picture(monkeypatch):
    """The recon's IDCT (K2's wrapper) runs once per coded picture."""
    from libav_tpu_torch.ops import idct as tidct
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int(blocks)
    monkeypatch.setattr(tmv, "idct8x8_int", counted)
    datas = L.h263_stream(frames(128, 96, 3), 40, 1)
    port_decode("h263", datas)
    assert calls == [8 * 6 * 6] * 3
    datas = L.flv1_stream(frames(96, 64, 2), 41, 96, 64)
    port_decode("flv1", datas)
    assert calls[3:] == [6 * 4 * 6] * 2


@pytest.mark.parametrize("kind", ["h263sh", "wmv1"])
@pytest.mark.parametrize("inter", [False, True])
def test_recon_h263sh_and_wmv1(kind, inter):
    """The two quantiser kinds of the legacy decoders: H.263's fixed DC
    scaler 8 and WMV1's DC scale tables, in both rounding modes."""
    for rounding in (0, 1):
        args, _ = testdata.recon_inputs(250 + rounding, 5, 3, inter)
        args[1] = np.clip(args[1], 1, 31).astype(np.int32)
        want = jmv.recon_jit(5, 3, kind, False, inter, rounding)(*args)
        got = tmv.recon(5, 3, kind, False, inter, rounding, device=CPU)(
            *state_from_numpy(args, CPU))
        _eq_tree(got, want)


# ---------------------------------------------------------------------- #
# FLV1


@pytest.mark.parametrize("w,h,size_code,escapes", [
    (96, 64, 0, (0, 1)),          # 8-bit size, both escape formats
    (96, 64, 1, (1,)),            # 16-bit size, Sorenson escapes
    (176, 144, None, (0,)),       # a fixed size code, H.263 escapes
    (320, 240, None, (1, 0)),
    (50, 38, None, (1,)),         # no whole number of MBs
])
def test_flv1_matches_jax(w, h, size_code, escapes, jax_faults):
    used = collections.Counter()
    datas = L.flv1_stream(frames(w, h, 4), 50 + w, w, h,
                          size_code=size_code, escapes=escapes, used=used)
    want = assert_same("flv1", datas)
    assert jax_faults == []
    assert want[0][0].shape == (h, w)
    if 1 in escapes:
        assert used["flv escape 7-bit"] and used["flv escape 11-bit"]


# ---------------------------------------------------------------------- #
# containers, the decoder table, the CLI


def _demux(fc_cls, path):
    """(demuxer name, packet records) of a file through a package's
    demuxer; either package's AVError (EOF) ends it."""
    ic = fc_cls.open_input(str(path))
    try:
        pkts = []
        while True:
            try:
                p = ic.read_frame()
            except (AVError, JAVError):
                break
            pkts.append((bytes(p.data), p.pts, p.dts, p.stream_index,
                         p.flags))
        return ic.iformat.NAME, pkts
    finally:
        ic.close()


def _mux(P, path, fmt, codec, w, h, datas):
    """datas through package P's muxer fmt into path."""
    oc = P["FormatContext"].open_output(str(path), fmt)
    oc.new_stream(P["Params"](codec_type="video", codec_id=codec, width=w,
                              height=h, pix_fmt="yuv420p"),
                  time_base=P["Rational"](1, 25))
    oc.write_header()
    for i, d in enumerate(datas):
        p = P["Packet"](data=d, pts=i, dts=i, duration=1,
                        flags=1 if i == 0 else 0)
        p.stream_index = 0
        p.time_base = P["Rational"](1, 25)
        oc.write_packet(p)
    oc.write_trailer()
    return path.read_bytes()


def packages():
    from libav_tpu.avutil.rational import Rational as JRational
    from libav_tpu_torch.avutil.rational import Rational
    return ({"FormatContext": JFormatContext, "Params": JParams,
             "Packet": JPacket, "Rational": JRational},
            {"FormatContext": FormatContext, "Params": CodecParameters,
             "Packet": Packet, "Rational": Rational})


@pytest.mark.parametrize("fmt,ext,codec,w,h", [
    ("h263", "263", "h263", 176, 144),
    ("flv", "flv", "flv1", 96, 64),
])
def test_containers_match_jax(fmt, ext, codec, w, h, tmp_path):
    """The muxers write the same bytes, and the demuxers read the same
    packets back (the raw H.263 demuxer splits at picture start codes)."""
    datas = (L.h263_stream(frames(w, h, 3), 60, 2) if codec == "h263"
             else L.flv1_stream(frames(w, h, 3), 61, w, h))
    jp, tp = packages()
    want = _mux(jp, tmp_path / f"jax.{ext}", fmt, codec, w, h, datas)
    got = _mux(tp, tmp_path / f"port.{ext}", fmt, codec, w, h, datas)
    assert got == want
    jname, jpkts = _demux(JFormatContext, tmp_path / f"jax.{ext}")
    tname, tpkts = _demux(FormatContext, tmp_path / f"jax.{ext}")
    assert (tname, tpkts) == (jname, jpkts) and tname == fmt
    assert [p[0] for p in tpkts] == datas


def test_find_decoder_resolves_to_the_port():
    assert find_decoder("h263") is H263Decoder
    assert find_decoder("flv1") is FLV1Decoder
    assert find_decoder("h263")(device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            find_decoder("flv1")()
    from libav_tpu_torch.codecs.prores.dec import ProresDecoder
    assert find_decoder("prores") is ProresDecoder


@pytest.mark.parametrize("name", ["in.263", "in.flv"])
def test_avconv_framecrc_matches_jax(name, tmp_path):
    if name.endswith("263"):
        data = b"".join(L.h263_stream(frames(176, 144, 3), 70, 2))
    else:
        jp, _ = packages()
        data = _mux(jp, tmp_path / "src.flv", "flv", "flv1", 96, 64,
                    L.flv1_stream(frames(96, 64, 3), 71, 96, 64))
    src = tmp_path / name
    src.write_bytes(data)
    out = {}
    for tag, tool, kw in (("jax", jax_avconv, {}),
                          ("port", avconv, {"device": "cpu"})):
        dst = tmp_path / f"{tag}.crc"
        assert tool.main(["-i", str(src), "-f", "framecrc", str(dst)],
                         **kw) == 0
        out[tag] = dst.read_text()
    assert out["port"] == out["jax"] and out["jax"].count("\n0, ") == 3


def test_gob_headers_conceal_like_jax(jax_faults):
    """GOB headers: neither decoder reads a GBSC (ROADMAP.md §3), so a P
    picture with them fails past its first MB row and is concealed, the
    same way in both."""
    w = L.H263Writer(176, 144, 32, fmt=2)
    src = frames(176, 144, 2)
    datas = [w.picture(src[0], 0, 8)]
    w.gob_headers = True
    datas.append(w.picture(src[1], 1, 8, pan=(2, -1)))
    assert_same("h263", datas)
    assert any("concealing" in m for m in jax_faults)
