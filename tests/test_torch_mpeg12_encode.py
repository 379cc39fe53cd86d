"""The PyTorch port's MPEG-1/2 encoders held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU; the reconstruction's IDCT takes its einsum path, which the JAX
package holds bit-identical to its Pallas kernel K2) and its counterpart
in the port on the CPU: the motion search bounded to the picture, the
I/P picture program for the 'mpeg1' and 'mpeg2' quantisers, the MPEG-1/2
B program, the MPEG-2 field-stress P program, and the encoders through
their send/receive API and through avconv. The codecs are integer-exact,
so the tolerance is exact equality: packets byte for byte, every array
`np.array_equal`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs import mpegvideo as jmv
from libav_tpu.ops import me as jme
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs import mpegvideo as tmv
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_encoder)
from libav_tpu_torch.codecs.mpeg12 import MPEG1Encoder, MPEG2Encoder
from libav_tpu_torch.ops import me as tme
from libav_tpu_torch.ops.mc import EDGE
from libav_tpu_torch.tools import avconv
from tools.gen_torch_smoke_stream import encode as jax_encode
from test_torch_mpeg4_encode import _eq, _eq_tree, _encode_inputs, _t

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# ---------------------------------------------------------------------- #
# the bounded search


def _edge_planes(seed, mb_w, mb_h, shift):
    """A reference and the current picture cut from a larger textured
    plane shifted by `shift`: the MBs on the picture's edges find their
    best match outside the picture, where the bounded search may not go."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    yy, xx = np.mgrid[0:H + 96, 0:W + 96]
    big = (0.6 * xx + 0.7 * yy + 20 * np.sin(xx / 4.0) * np.cos(yy / 6.0)
           + rng.integers(0, 4, xx.shape)).astype(np.int64) % 256
    ref = big[48:48 + H, 48:48 + W]
    dx, dy = shift
    cur = big[48 + dy:48 + dy + H, 48 + dx:48 + dx + W]
    padded = np.pad(ref, EDGE, mode="edge").astype(np.uint8)
    cur_mbs = (cur.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)
               .reshape(-1, 16, 16).astype(np.int32))
    return cur_mbs, padded


@pytest.mark.parametrize("mb_w,mb_h,shift,search_range", [
    (4, 3, (-12, -9), 15), (5, 4, (11, 13), 15), (3, 2, (-7, 6), 12),
    (6, 3, (14, -15), 15)])
def test_bounded_search_and_refine(mb_w, mb_h, shift, search_range):
    cur_mbs, padded = _edge_planes(200 + mb_w, mb_w, mb_h, shift)
    want = jme._search_jit(mb_w, mb_h, search_range, True)(
        jnp.asarray(cur_mbs), jnp.asarray(padded))
    got = tme.search(mb_w, mb_h, search_range, True, device=CPU)(
        _t(cur_mbs), _t(padded))
    _eq_tree(got, want)
    mv = np.asarray(want[0])
    xs = (np.arange(mb_w * mb_h) % mb_w) * 16
    ys = (np.arange(mb_w * mb_h) // mb_w) * 16
    # inside the picture, and the edge MBs held back by the bound
    assert (xs + mv[:, 0] >= 0).all() and (ys + mv[:, 1] >= 0).all()
    assert (xs + mv[:, 0] <= 16 * mb_w - 16).all()
    assert (ys + mv[:, 1] <= 16 * mb_h - 16).all()
    free = np.asarray(jme._search_jit(mb_w, mb_h, search_range)(
        jnp.asarray(cur_mbs), jnp.asarray(padded))[0])
    assert (free != mv).any()
    jref = jme._hpel_refine_jit(mb_w, mb_h, True)(
        jnp.asarray(cur_mbs), jnp.asarray(padded), want[0])
    tref = tme.hpel_refine(mb_w, mb_h, True, device=CPU)(
        _t(cur_mbs), _t(padded), got[0])
    _eq_tree(tref, jref)
    hmv = np.asarray(jref[0])
    assert (2 * xs + hmv[:, 0] >= 0).all() and \
        (2 * ys + hmv[:, 1] <= 2 * (16 * mb_h - 16)).all()


# ---------------------------------------------------------------------- #
# the picture programs


def _matrices(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(8, 64, 64).astype(np.int32),
            rng.integers(8, 64, 64).astype(np.int32))


@pytest.mark.parametrize("kind", ["mpeg1", "mpeg2"])
@pytest.mark.parametrize("mbcmp", ["sad", "satd"])
@pytest.mark.parametrize("inter", [False, True])
def test_encode_mpeg(kind, mbcmp, inter):
    cur, qscale, refs = _encode_inputs(210 + inter, 5, 4, 1)
    qi, qp = _matrices(211)
    args = [*cur, qscale, qi, qp, *refs]
    want = jmv.encode_jit(5, 4, inter, kind, want_coeffs=True,
                          mbcmp=mbcmp)(*args)
    got = tmv.encode(5, 4, inter, kind, want_coeffs=True, mbcmp=mbcmp,
                     device=CPU)(*state_from_numpy(args, CPU))
    _eq_tree(got, want)
    levels, intra = np.asarray(want[0]), np.asarray(want[2])
    lim = 255 if kind == "mpeg1" else 2047
    assert np.abs(levels[..., 1:]).max() <= lim and levels.any()
    if inter:
        assert intra.any() and (~intra).any()


def _b_inputs(seed, mb_w, mb_h):
    """A current picture whose left third moves with the past reference,
    right third with the future one, and middle is their average: each
    of the three modes wins somewhere."""
    cur, qscale, refs = _encode_inputs(seed, mb_w, mb_h, 2)
    r0, r1 = refs[:3], refs[3:]
    out = []
    for c, a, b, s in zip(cur, r0, r1, (16, 8, 8)):
        a = a[EDGE:-EDGE, EDGE:-EDGE].astype(int)
        b = np.roll(a, (1, 2), (0, 1))
        c = c.astype(int)
        w = c.shape[1]
        c[:, w // 3:] = b[:, w // 3:]
        c[:, w // 3:2 * w // 3] = (a + b + 1)[:, w // 3:2 * w // 3] // 2
        out.append(np.clip(c, 0, 255).astype(np.uint8))
    r1 = [np.pad(np.roll(p[EDGE:-EDGE, EDGE:-EDGE], (1, 2), (0, 1)), EDGE,
                 mode="edge") for p in r0]
    return out, qscale, [*r0, *r1]


@pytest.mark.parametrize("kind", ["mpeg1", "mpeg2"])
def test_encode_b_mpeg(kind):
    cur, qscale, refs = _b_inputs(220, 6, 4)
    _, qp = _matrices(221)
    args = [*cur, qscale, qp, *refs]
    want = jmv.encode_b_jit(6, 4, kind)(*args)
    got = tmv.encode_b(6, 4, kind, device=CPU)(*state_from_numpy(args, CPU))
    _eq_tree(got, want)
    uf, ub = np.asarray(want[3]), np.asarray(want[4])
    assert (uf & ~ub).any() and (ub & ~uf).any() and (uf & ub).any()
    assert got[3].dtype == torch.bool


@pytest.mark.parametrize("pattern", ["same", "opp", "whole", "h16",
                                     "dponly", "full"])
@pytest.mark.parametrize("parity", [0, 1])
def test_encode_field_stress(pattern, parity):
    """At the field geometry of test_fieldpic_matches_jax's pictures (4x4
    MBs), so both tests share the JAX programs."""
    cur, qscale, refs = _encode_inputs(230 + parity, 4, 4, 2)
    _, qp = _matrices(231)
    args = [*cur, qscale, qp, *refs]
    fn, mode_pat = jmv.encode_field_stress_jit(4, 4, parity,
                                               pattern=pattern)
    want = fn(*args)
    prog = tmv.encode_field_stress(4, 4, parity, pattern=pattern,
                                   device=CPU)
    _eq_tree(prog(*state_from_numpy(args, CPU)), want)
    _eq(prog.mode_pat, mode_pat)
    if pattern in ("dponly", "full"):
        assert (mode_pat == 3).any()      # dual prime on interior MBs


def test_programs_refuse_other_kinds():
    with pytest.raises(ValueError):
        tmv.encode_b(2, 2, "h263", device=CPU)
    with pytest.raises(ValueError):
        tmv.encode(2, 2, True, "mpeg4", device=CPU)


# ---------------------------------------------------------------------- #
# the encoders


def _frames(w, h, n):
    out = []
    for t in range(n):
        f = Frame(width=w, height=h, format="yuv420p")
        f.planes = list(testdata.pattern(w, h, t))
        f.pts = t
        out.append(f)
    return out


def port_encode(codec, w, h, n, settings, device="cpu", anchors=None):
    """The port's counterpart of gen_torch_smoke_stream.encode: packet
    bytes; anchors, if a list, gets each anchor's reconstructed planes."""
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec,
                          width=w, height=h, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder(codec)(par, device=device)
    for k, v in settings.items():
        enc.set_opt(k, v)
    if anchors is not None:
        inner = enc._encode_anchor

        def recorded(*args):
            pkt = inner(*args)
            anchors.append([p[EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
                            for p in enc._refs])
            return pkt
        enc._encode_anchor = recorded
    return [p.data for p in enc.encode_all(_frames(w, h, n))]


ENCODES = [
    ("mpeg1video", 64, 48, 5, {}),
    ("mpeg2video", 96, 64, 4, {}),
    ("mpeg1video", 50, 38, 6, {"b_frames": 1, "gop_size": 4}),
    ("mpeg2video", 64, 48, 6, {"b_frames": 2, "gop_size": 5}),
    ("mpeg2video", 50, 38, 5, {"b_frames": 2, "trellis": 1}),
    ("mpeg1video", 96, 64, 4, {"mbcmp": "satd", "trellis": 1,
                               "b_frames": 1}),
    ("mpeg2video", 64, 48, 6, {"b_frames": 2, "gop_size": 8,
                               "bit_rate": 300000}),
]


@pytest.mark.parametrize("codec,w,h,n,settings", ENCODES)
def test_encoder_matches_jax(codec, w, h, n, settings):
    """Defaults, B runs of 1 and 2 (the stream ends inside one: drained
    behind a P), GOP restarts, trellis, SATD, rate control."""
    want = jax_encode(w, h, n, codec, settings)
    got = port_encode(codec, w, h, n, settings)
    assert got == want and len(got) == n


@pytest.mark.parametrize("option", ["lumi_masking", "dark_masking",
                                    "tcplx_masking", "scplx_masking",
                                    "p_masking", "border_masking"])
def test_masking_matches_jax(option):
    """Each masking option's adaptive quantisation (per-MB qscale coded
    through the QUANT macroblock types). It moves the packets of the
    96x64 pattern, except lumi masking: that picture's luma is too even
    for its field to leave the frame qscale."""
    settings = {option: 0.5, "gop_size": 3}
    want = jax_encode(96, 64, 4, "mpeg2video", settings)
    assert port_encode("mpeg2video", 96, 64, 4, settings) == want
    assert (want != jax_encode(96, 64, 4, "mpeg2video", {"gop_size": 3})) \
        == (option != "lumi_masking")


@pytest.mark.parametrize("stress", ["same", "opp", "whole", "h16",
                                    "dponly", "full"])
def test_fieldpic_matches_jax(stress):
    """64x128: four MB rows per field, so the field pictures have
    interior MBs and 'dponly' and 'full' code dual prime (at 64x64 no
    MB is interior and dual prime never occurs)."""
    settings = {"fieldpic": 1, "fieldstress": stress, "gop_size": 2}
    want = jax_encode(64, 128, 3, "mpeg2video", settings)
    assert port_encode("mpeg2video", 64, 128, 3, settings) == want


@pytest.mark.parametrize("bad", [{"fieldpic": 1, "b_frames": 1},
                                 {"fieldpic": 1}])
def test_fieldpic_einval(bad):
    """fieldpic with B-frames, and fieldpic on an odd number of MB rows
    (48 lines): EINVAL at open, as in the JAX encoder."""
    par = CodecParameters(codec_type=MediaType.VIDEO,
                          codec_id="mpeg2video", width=64,
                          height=64 if "b_frames" in bad else 48,
                          pix_fmt="yuv420p")
    enc = find_encoder("mpeg2video")(par, device="cpu")
    for k, v in bad.items():
        enc.set_opt(k, v)
    with pytest.raises(AVError, match="fieldpic"):
        enc.open()


def test_anchors_and_one_idct_per_anchor(monkeypatch):
    """The closed loop: every anchor's reconstruction equals the JAX
    encoder's, and the reconstruction's IDCT (K2's wrapper) runs once per
    I/P picture and never for a B picture."""
    from libav_tpu.codecs.mpeg12 import enc as jenc
    from libav_tpu_torch.ops import idct as tidct
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int(blocks)
    monkeypatch.setattr(tmv, "idct8x8_int", counted)
    settings = {"b_frames": 2, "gop_size": 8}
    anchors = []
    got = port_encode("mpeg2video", 64, 48, 7, settings, anchors=anchors)
    want_anchors = []
    inner = jenc.MPEG2Encoder._encode_anchor

    def recorded(self, *args):
        pkt = inner(self, *args)
        want_anchors.append([np.asarray(p)[EDGE:-EDGE, EDGE:-EDGE]
                             for p in self._refs])
        return pkt
    monkeypatch.setattr(jenc.MPEG2Encoder, "_encode_anchor", recorded)
    assert got == jax_encode(64, 48, 7, "mpeg2video", settings)
    _eq_tree(anchors, want_anchors)
    assert calls == [4 * 3 * 6] * 3          # I0, P3, P6


def test_encoder_runs_on_the_card_unless_told():
    for codec, cls in (("mpeg1video", MPEG1Encoder),
                       ("mpeg2video", MPEG2Encoder)):
        assert find_encoder(codec) is cls and cls.DEVICE_PART
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec,
                              width=32, height=32, pix_fmt="yuv420p")
        assert cls(par, device="cpu").device == CPU
        if torch.cuda.is_available():
            assert find_encoder(codec)(par).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                find_encoder(codec)(par)


def test_encoder_takes_tensor_frames():
    """Planes as (non-contiguous) tensor views, as a decoder returns them."""
    want = port_encode("mpeg2video", 56, 40, 4, {"b_frames": 1})
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg2video",
                          width=56, height=40, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder("mpeg2video")(par, device="cpu")
    enc.set_opt("b_frames", 1)
    frames = _frames(56, 40, 4)
    for f in frames:
        f.planes = [torch.nn.functional.pad(_t(p), (0, 3, 0, 5))[
            :p.shape[0], :p.shape[1]] for p in f.planes]
        assert not f.planes[0].is_contiguous()
    assert [p.data for p in enc.encode_all(frames)] == want


@pytest.mark.parametrize("out,args", [
    ("out.m2v", ("-c:v", "mpeg2video", "-bf", "2")),
    ("out.ts", ()),
])
def test_avconv_mpeg2_matches_jax(out, args, tmp_path):
    """The port's avconv encodes the small H.264 stream to MPEG-2 (an
    elementary stream with two B-frames, and MPEG-TS, whose default video
    codec is mpeg2video): the JAX CLI's bytes."""
    files = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        files[name] = tmp_path / f"{name}_{out}"
        assert tool.main(["-i", testdata.SMALL_H264, *args,
                          str(files[name])], **kw) == 0
    want = files["jax"].read_bytes()
    assert files["port"].read_bytes() == want and len(want) > 1000


def test_encode_probe_stages():
    """The timing tool's stage wrappers see every stage of an MPEG-2
    I/P/B encode and of a field-picture one, change no byte, and leave
    the classes as they found them."""
    from libav_tpu_torch.codecs.mpeg12.enc import MPEG1Encoder
    from libav_tpu_torch.tools import encode_probe
    frames = encode_probe.pattern_frames(CPU, 48, 32, 4)
    settings = {"b_frames": 2}
    want, _ = encode_probe.encode(CPU, frames, settings, codec="mpeg2video")
    assert want == port_encode("mpeg2video", 48, 32, 4, settings)
    before = (dict(MPEG1Encoder.__dict__), dict(tmv.Recon.__dict__),
              dict(tmv.ReconField.__dict__))
    with encode_probe.stages(CPU, "mpeg2video") as st:
        got, _ = encode_probe.encode(CPU, frames, settings,
                                     codec="mpeg2video")
        encode_probe.encode(CPU, frames[:2], {"fieldpic": 1},
                            codec="mpeg2video")
    assert got == want
    assert (dict(MPEG1Encoder.__dict__), dict(tmv.Recon.__dict__),
            dict(tmv.ReconField.__dict__)) == before
    # I, P, B, B; then two frames of field pictures: I I, P P
    assert {k: len(v) for k, v in st.items()} == {
        "P search (full + half pel)": 1,
        "B search (full + half pel), per direction": 4,
        "P field search (full + half pel)": 2,
        "FDCT + quant": 8, "anchor recon (one K2 launch)": 2,
        "field recon (one K2 launch)": 4,
        "levels/MV/intra download": 8, "I/P host packing": 2,
        "B host packing": 2}


def test_b_pictures_ask_rate_control_for_p(monkeypatch):
    """The JAX encoder asks rate control for a "P" qscale for its B
    pictures too (enc.py `_encode_b`, ROADMAP.md §3); the port keeps it:
    both ask for the same picture types."""
    from libav_tpu.codecs import ratecontrol as jrc
    from libav_tpu_torch.codecs import ratecontrol as trc
    asked = {"jax": [], "port": []}
    for tag, mod in (("jax", jrc), ("port", trc)):
        inner = mod.RateControl.qscale_for_frame

        def spy(self, ptype, *a, _inner=inner, _tag=tag, **k):
            asked[_tag].append(ptype)
            return _inner(self, ptype, *a, **k)
        monkeypatch.setattr(mod.RateControl, "qscale_for_frame", spy)
    settings = {"b_frames": 2, "gop_size": 8, "bit_rate": 300000}
    assert port_encode("mpeg2video", 64, 48, 4, settings) == \
        jax_encode(64, 48, 4, "mpeg2video", settings)
    assert asked["port"] == asked["jax"] == ["I", "P", "P", "P"]
