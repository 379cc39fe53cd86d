"""The PyTorch port's ProRes codec held against the JAX package's.

The same seeded numpy inputs go through the JAX functions (on the CPU)
and the port's on the CPU: `prores_idct` and `fdct10` against the JAX
jit and the numpy goldens (dequant products that wrap int16, DC-only
blocks, row sums that overflow int32, samples at 0 and 1023); the
encoder's packets across the profiles, forced and rate-controlled
quantisers, slice widths and bit budgets, at a whole-MB and a
non-MB-aligned size; both decoders on the JAX packets; an interlaced
frame spliced from field pictures of the JAX encoder; the errors; and
the CLI path (10-bit rawvideo into .mov, then framecrc). Integer-exact,
so the tolerance is exact equality: packets byte for byte, frames sample
for sample.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libav_tpu.avutil.error import AVError as JaxAVError
from libav_tpu.avutil.frame import Frame as JaxFrame
from libav_tpu.avutil.frame import Packet as JaxPacket
from libav_tpu.codecs.api import CodecParameters as JaxParameters
from libav_tpu.codecs.api import find_decoder as jax_find_decoder
from libav_tpu.codecs.api import find_encoder as jax_find_encoder
from libav_tpu.codecs.prores.tables import INTERLACED_SCAN
from libav_tpu.ops import prores_dct as jdct
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_decoder, find_encoder)
from libav_tpu_torch.codecs.prores.dec import ProresDecoder
from libav_tpu_torch.codecs.prores.enc import ProresEncoder
from libav_tpu_torch.ops import prores_dct as tdct
from libav_tpu_torch.tools import avconv

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# ---------------------------------------------------------------------- #
# the transforms
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("B", [1, 5, 640])
def test_prores_idct_matches_jax_and_golden(B):
    coeffs, qrows = testdata.prores_idct_inputs(40 + B, B)
    want = np.asarray(jax.jit(jdct.prores_idct)(jnp.asarray(coeffs),
                                                jnp.asarray(qrows)))
    np.testing.assert_array_equal(want, jdct.prores_idct_ref(coeffs, qrows))
    np.testing.assert_array_equal(want, tdct.prores_idct_ref(coeffs, qrows))
    got = tdct.prores_idct(torch.as_tensor(coeffs), torch.as_tensor(qrows))
    assert got.dtype == torch.int32 and got.shape == (B, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prores_idct_inputs_reach_the_wrap_cases():
    """The classes the card checks too: dequant products past int16, row
    sums past int32, DC-only and all-zero blocks."""
    coeffs, qrows = testdata.prores_idct_inputs(7, 500)
    x = coeffs.astype(np.int64) * qrows
    assert (np.abs(x[2::5]) > 32767).mean() > 0.9
    x16 = ((x + 0x8000) & 0xFFFF) - 0x8000
    rows = np.einsum("bij,kj->bik", x16.reshape(-1, 8, 8),
                     tdct.idct_matrix_int10())
    assert (np.abs(rows[3::5]) > 2 ** 31 - 1).any()
    assert (coeffs[1::5, 1:] == 0).all() and (coeffs[4::5] == 0).all()
    # one qmat row for every block broadcasts as in the JAX program
    q = torch.as_tensor(qrows[0])
    got = tdct.prores_idct(torch.as_tensor(coeffs), q)
    np.testing.assert_array_equal(
        got.numpy(), jdct.prores_idct_ref(coeffs, qrows[:1]))


@pytest.mark.parametrize("B", [1, 7, 640])
def test_fdct10_matches_jax_and_golden(B):
    blocks = testdata.prores_fdct_inputs(50 + B, B)
    want = np.asarray(jax.jit(jdct.fdct10)(jnp.asarray(blocks)))
    np.testing.assert_array_equal(want, jdct.fdct10_ref(blocks))
    np.testing.assert_array_equal(want, tdct.fdct10_ref(blocks))
    got = tdct.fdct10(torch.as_tensor(blocks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if B > 5:
        assert blocks.min() == 0 and blocks.max() == 1023


def test_fdct10_wraps_like_jax_past_ten_bits():
    """Samples far outside 10 bits: the sums wrap in int32 as XLA's do."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(-(1 << 20), 1 << 20, (64, 8, 8)).astype(np.int32)
    want = np.asarray(jax.jit(jdct.fdct10)(jnp.asarray(blocks)))
    np.testing.assert_array_equal(
        tdct.fdct10(torch.as_tensor(blocks)).numpy(), want)


# ---------------------------------------------------------------------- #
# the encoder and decoder
# ---------------------------------------------------------------------- #

def _planes(src, fmt, w, h, t):
    """Frame t's host uint16 planes: pattern10, or full-range noise that
    drives the trellis past max_quant (q >= 16 rows are built per slice)."""
    if src == "pattern10":
        return testdata.pattern10(w, h, t, fmt)
    rng = np.random.default_rng(90 + t)
    cw = w if fmt == "yuv444p10le" else (w + 1) // 2
    return tuple(rng.integers(0, 1024, (h, pw)).astype(np.uint16)
                 for pw in (w, cw, cw))


def _frames(src, fmt, w, h, n):
    jf, tf = [], []
    for t in range(n):
        planes = _planes(src, fmt, w, h, t)
        j = JaxFrame(width=w, height=h, format=fmt)
        p = Frame(width=w, height=h, format=fmt)
        j.planes = [a.copy() for a in planes]
        p.planes = [a.copy() for a in planes]
        j.pts = p.pts = t
        jf.append(j)
        tf.append(p)
    return jf, tf


def _encoders(fmt, w, h, settings):
    jax_enc = jax_find_encoder("prores")(JaxParameters(
        codec_type="video", codec_id="prores", width=w, height=h,
        pix_fmt=fmt))
    port = find_encoder("prores")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="prores", width=w, height=h,
        pix_fmt=fmt), device="cpu")
    for k, v in settings.items():
        jax_enc.set_opt(k, v)
        port.set_opt(k, v)
    return jax_enc, port


def _decode_both(datas):
    """Both decoders on the same packets: -> (JAX host planes, port
    frames)."""
    jdec = jax_find_decoder("prores")(JaxParameters(codec_type="video",
                                                    codec_id="prores"))
    tdec = find_decoder("prores")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="prores"), device="cpu")
    want = jdec.decode_all(JaxPacket(data=d, pts=i)
                           for i, d in enumerate(datas))
    got = tdec.decode_all(Packet(data=d, pts=i) for i, d in enumerate(datas))
    return [[np.asarray(p) for p in f.to_host().planes] for f in want], got


def _assert_frames_equal(want, got, fmt):
    assert len(got) == len(want)
    for wp, f in zip(want, got):
        assert f.format == fmt
        assert all(isinstance(p, torch.Tensor) and p.device == CPU and
                   p.dtype == torch.uint16 for p in f.planes)
        host = f.to_host().planes
        for a, b in zip(wp, host):
            assert b.dtype == np.uint16 and a.dtype == np.uint16
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("src,fmt,w,h,settings", [
    ("pattern10", "yuv422p10le", 64, 48, {"profile": "proxy"}),
    ("pattern10", "yuv422p10le", 60, 44, {"profile": "lt"}),
    ("pattern10", "yuv422p10le", 64, 48, {"profile": "standard",
                                          "qscale": 1}),
    ("noise", "yuv422p10le", 60, 44, {"profile": "hq",
                                      "mbs_per_slice": 1}),
    ("pattern10", "yuv444p10le", 64, 48, {"profile": "4444"}),
    ("noise", "yuv444p10le", 60, 44, {"profile": "4444", "qscale": 1,
                                      "mbs_per_slice": 2}),
    ("noise", "yuv422p10le", 64, 48, {"mbs_per_slice": 4,
                                      "bits_per_mb": 300}),
    ("pattern10", "yuv422p10le", 64, 48, {"profile": "hq",
                                          "mbs_per_slice": 2,
                                          "bits_per_mb": 2000}),
    ("noise", "yuv422p10le", 60, 44, {"mbs_per_slice": 8}),
    ("pattern10", "yuv444p10le", 60, 44, {"profile": "4444", "qscale": 0,
                                          "mbs_per_slice": 4}),
])
def test_encode_and_decode_match_jax(src, fmt, w, h, settings):
    jax_enc, port = _encoders(fmt, w, h, settings)
    assert port.device == CPU and port.DEVICE_PART
    jf, tf = _frames(src, fmt, w, h, 2)
    want = [p.data for p in jax_enc.encode_all(jf)]
    got = [p.data for p in port.encode_all(tf)]
    assert got == want
    assert port.params.codec_tag == jax_enc.params.codec_tag
    jax_frames, port_frames = _decode_both(want)
    _assert_frames_equal(jax_frames, port_frames, fmt)


def test_encoder_takes_tensor_frames():
    """Frames whose planes are tensors (a decoder's output on its device)
    encode as their numpy planes do."""
    jax_enc, port = _encoders("yuv422p10le", 64, 48, {})
    jf, tf = _frames("pattern10", "yuv422p10le", 64, 48, 1)
    tf[0].planes = [torch.as_tensor(p.astype(np.int64)).to(torch.uint16)
                    for p in tf[0].planes]
    assert [p.data for p in port.encode_all(tf)] == \
        [p.data for p in jax_enc.encode_all(jf)]


def _error(fn):
    try:
        fn()
    except (AVError, JaxAVError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("fmt,profile", [
    ("yuv420p10le", "standard"),
    ("yuv422p10le", "4444"),
])
def test_encoder_refuses_like_jax(fmt, profile):
    """4:2:0 input does not fit any profile, and the JAX encoder also
    refuses 4:2:2 under profile 4444: the port refuses both alike."""
    jax_enc, port = _encoders(fmt, 32, 32, {"profile": profile})
    jf = JaxFrame.alloc_video(32, 32, fmt)
    tf = Frame.alloc_video(32, 32, fmt)
    want = _error(lambda: jax_enc.encode_all([jf]))
    assert "does not fit profile" in want[1]
    assert _error(lambda: port.encode_all([tf])) == want


# ---------------------------------------------------------------------- #
# interlaced frames: field pictures of the JAX encoder under one header
# ---------------------------------------------------------------------- #

def _interlaced_packet(fmt, w, h, frame_type, seed):
    """An interlaced ProRes frame of two field pictures. No encoder writes
    one: each field is encoded as a picture of its own by the JAX encoder
    with the interlaced scan set on the instance, and the two pictures
    are spliced under a frame header with frame_type 1 (top field first)
    or 2, each picture's size field set to its length."""
    rng = np.random.default_rng(seed)
    cw = w if fmt == "yuv444p10le" else (w + 1) // 2
    full = [rng.integers(0, 1024, (h, pw)).astype(np.uint16)
            for pw in (w, cw, cw)]
    tff = 1 if frame_type == 1 else 0
    pictures, header = [], None
    for pic_num in range(2):
        off = 1 if (pic_num ^ tff) == 0 else 0
        fh = (h - off + 1) // 2
        f = JaxFrame(width=w, height=fh, format=fmt)
        f.planes = [np.ascontiguousarray(p[off::2]) for p in full]
        enc = jax_find_encoder("prores")(JaxParameters(
            codec_type="video", codec_id="prores", width=w, height=fh,
            pix_fmt=fmt))
        if fmt == "yuv444p10le":
            enc.set_opt("profile", "4444")
        enc.set_opt("mbs_per_slice", 2)
        enc.open()
        enc.scan = INTERLACED_SCAN
        data = enc.encode_all([f])[0].data
        hdr_size = int.from_bytes(data[8:10], "big")
        header = bytearray(data[8:8 + hdr_size])
        pic = bytearray(data[8 + hdr_size:])
        pic[1:5] = len(pic).to_bytes(4, "big")
        pictures.append(bytes(pic))
    header[10:12] = h.to_bytes(2, "big")
    header[12] = (header[12] & ~0x0C) | (frame_type << 2)
    body = bytes(header) + b"".join(pictures)
    return (8 + len(body)).to_bytes(4, "big") + b"icpf" + body, full


@pytest.mark.parametrize("fmt,w,h,frame_type", [
    ("yuv422p10le", 64, 96, 1),
    ("yuv422p10le", 48, 61, 2),
    ("yuv444p10le", 40, 60, 1),
    ("yuv444p10le", 64, 64, 2),
])
def test_interlaced_decode_matches_jax(fmt, w, h, frame_type):
    data, _ = _interlaced_packet(fmt, w, h, frame_type, seed=h + w)
    jax_frames, port_frames = _decode_both([data])
    _assert_frames_equal(jax_frames, port_frames, fmt)
    f = port_frames[0]
    assert f.interlaced_frame and f.top_field_first == (frame_type == 1)
    assert f.planes[0].shape == (h, w)


def test_interlaced_weave_puts_each_field_on_its_lines():
    """Each decoded line is closer to the source line it was coded from
    than to the line of the other parity beside it."""
    data, full = _interlaced_packet("yuv422p10le", 64, 64, 1, seed=5)
    _, got = _decode_both([data])
    y = got[0].to_host().planes[0].astype(np.int64)
    src = full[0].astype(np.int64)
    own = np.abs(y - src).mean()
    swapped = np.abs(y[0::2] - src[1::2]).mean()
    assert own < swapped


# ---------------------------------------------------------------------- #
# errors, registration, the CLI
# ---------------------------------------------------------------------- #

def _good_packet():
    jax_enc, _ = _encoders("yuv422p10le", 32, 32, {"qscale": 4})
    jf, _ = _frames("pattern10", "yuv422p10le", 32, 32, 1)
    return jax_enc.encode_all(jf)[0].data


def _decode_error(decoder, packet_cls, data):
    return _error(lambda: decoder.decode_all([packet_cls(data=data, pts=0)]))


@pytest.mark.parametrize("damage", ["alpha", "atom_id", "short", "size",
                                    "frame_type", "slices"])
def test_errors_match_jax(damage):
    data = bytearray(_good_packet())
    if damage == "alpha":
        data[8 + 17] |= 1
    elif damage == "atom_id":
        data[4:8] = b"icpx"
    elif damage == "short":
        data = data[:20]
    elif damage == "size":
        data[0:4] = (len(data) + 1).to_bytes(4, "big")
    elif damage == "frame_type":
        data[8 + 12] |= 0x0C
    else:
        hdr = int.from_bytes(data[8:10], "big")
        data[8 + hdr + 5:8 + hdr + 7] = (999).to_bytes(2, "big")
    jdec = jax_find_decoder("prores")(JaxParameters(codec_type="video",
                                                    codec_id="prores"))
    tdec = find_decoder("prores")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="prores"), device="cpu")
    want = _decode_error(jdec, JaxPacket, bytes(data))
    assert want[0] == "AVError"
    assert _decode_error(tdec, Packet, bytes(data)) == want


def test_registration_and_devices():
    assert find_decoder("prores") is ProresDecoder
    assert find_encoder("prores") is ProresEncoder
    assert ProresDecoder(device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ProresDecoder()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ProresEncoder(CodecParameters(codec_type=MediaType.VIDEO,
                                          codec_id="prores"))


def test_pattern10_matches_the_golden_source():
    """The card's smoke run encodes pattern10 at 1080p and holds the
    packets to the JAX encoder's: its planes must be the ones the golden
    was made from (numpy's generator and arithmetic on this host)."""
    gold = testdata.load_golden(testdata.prores_golden_path())
    for t, want in enumerate(gold["source"]):
        planes = testdata.pattern10(*testdata.PRORES_SIZE, t)
        assert [p.dtype for p in planes] == [np.uint16] * 3
        assert testdata.plane_adler32(planes, "<u2") == want


def test_cli_rawvideo_to_mov_matches_jax(tmp_path):
    """`-f rawvideo -pix_fmt yuv422p10le ... -frames:v 1 -c:v prores
    out.mov` and `-i out.mov -f framecrc` through both CLIs, at 96x64."""
    src = tmp_path / "p10.yuv"
    with open(src, "wb") as f:
        for t in range(2):
            for p in testdata.pattern10(96, 64, t):
                f.write(p.astype("<u2").tobytes())
    argv = ["-f", "rawvideo", "-pix_fmt", "yuv422p10le", "-s", "96x64",
            "-r", "25", "-i", str(src), "-frames:v", "1", "-c:v", "prores"]
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        mov = str(tmp_path / f"{name}.mov")
        crc = str(tmp_path / f"{name}.crc")
        assert tool.main(argv + [mov], **kw) == 0
        assert tool.main(["-i", mov, "-f", "framecrc", crc], **kw) == 0
        with open(mov, "rb") as f, open(crc) as g:
            out[name] = (hashlib.md5(f.read()).hexdigest(), g.read())
    assert out["port"] == out["jax"]
    assert out["jax"][1].count("\n0, ") == 1
