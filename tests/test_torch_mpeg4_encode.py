"""The PyTorch port's MPEG-4 part 2 encoder held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU; the reconstruction's IDCT takes its einsum path, which the JAX
package holds bit-identical to its Pallas kernel K2) and its counterpart
in the port on the CPU: the forward DCT, H.263 dequantisation and chroma
vectors, the motion search and its half-pel refine, the I/P and B
picture programs, the 'h263' reconstruction, and the whole encoder
through its send/receive API. The codec is integer-exact, so the
tolerance is exact equality: packets byte for byte, every array
`np.array_equal`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs import mpegvideo as jmv
from libav_tpu.formats import m4v as jm4v
from libav_tpu.ops import fdct as jfdct
from libav_tpu.ops import mc as jmc
from libav_tpu.ops import me as jme
from libav_tpu.ops import quant as jq
from libav_tpu.ops.mc import EDGE
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.codecs import mpegvideo as tmv
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.api import find_encoder
from libav_tpu_torch.formats import m4v as tm4v
from libav_tpu_torch.ops import fdct as tfdct
from libav_tpu_torch.ops import mc as tmc
from libav_tpu_torch.ops import me as tme
from libav_tpu_torch.ops import quant as tq
from tools.gen_torch_smoke_stream import encode_mpeg4, pattern

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _eq_tree(got, want):
    if isinstance(got, (tuple, list)):
        assert isinstance(want, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _eq_tree(g, w)
    else:
        _eq(got, want)


# ---------------------------------------------------------------------- #
# FDCT, dequantisation, chroma vectors


@pytest.mark.parametrize("lo,hi", [(-255, 256), (0, 256)])
def test_fdct8x8_int(lo, hi):
    """Residuals in +-255 and pixels, with the extremes as whole blocks."""
    rng = np.random.default_rng(100 - lo)
    x = rng.integers(lo, hi, (600, 8, 8)).astype(np.int32)
    x[:4] = [[[lo]], [[hi - 1]], [[0]], [[(lo + hi) // 2]]]
    x[4] = np.where(np.add.outer(np.arange(8), np.arange(8)) % 2, lo, hi - 1)
    got = tfdct.fdct8x8_int(_t(x))
    assert got.dtype == torch.int32
    _eq(got, jfdct.fdct8x8_int_ref(x))
    _eq(got, jfdct.fdct8x8_int(jnp.asarray(x)))
    _eq(tfdct.fdct8x8_int_ref(x), jfdct.fdct8x8_int_ref(x))
    _eq(tfdct.fdct_matrix_int(), jfdct.fdct_matrix_int())


@pytest.mark.parametrize("intra", [True, False])
def test_h263_dequant(intra):
    rng = np.random.default_rng(110 + intra)
    c = np.where(rng.random((400, 64)) < 0.4,
                 rng.integers(-2047, 2048, (400, 64)), 0).astype(np.int16)
    q = rng.integers(1, 32, 400).astype(np.int32)
    d = np.where(np.arange(400) % 6 < 4, tq.mpeg4_dc_scaler(q, True),
                 tq.mpeg4_dc_scaler(q, False)).astype(np.int32)
    got = tq.h263_dequant(_t(c), _t(q), _t(d), intra)
    assert got.dtype == torch.int32
    _eq(got, jq.h263_dequant(jnp.asarray(c), jnp.asarray(q),
                             jnp.asarray(d), intra))
    _eq(got, jq.h263_dequant_ref(c, q, d, intra))
    _eq(tq.h263_dequant_ref(c, q, d, intra), jq.h263_dequant_ref(c, q, d,
                                                                 intra))


def test_dc_scaler_and_scans():
    q = np.arange(1, 32, dtype=np.int32)
    for luma in (True, False):
        _eq(tq.mpeg4_dc_scaler(q, luma), jq.mpeg4_dc_scaler(q, luma))
        assert tq.mpeg4_dc_scaler(7, luma) == jq.mpeg4_dc_scaler(7, luma)
        lum = torch.full((31,), luma)
        _eq(tq.dc_scaler(_t(q), lum), jq.mpeg4_dc_scaler(q, luma))
    _eq(tq.alternate_horizontal_scan(), jq.alternate_horizontal_scan())


def test_chroma_mv_h263():
    mv = np.arange(-67, 68, dtype=np.int32).reshape(-1, 1).repeat(2, 1)
    got = tmc.chroma_mv_h263(_t(mv))
    _eq(got, jmc.chroma_mv_h263(jnp.asarray(mv)))
    _eq(got, jmc.chroma_mv_h263_ref(mv))
    _eq(tmc.chroma_mv_h263_ref(mv), jmc.chroma_mv_h263_ref(mv))


# ---------------------------------------------------------------------- #
# motion search


def _me_planes(seed, mb_w, mb_h, shift, flat_rows=0):
    """A reference plane and the current picture cut from it shifted by
    `shift` (dx, dy); the top flat_rows MB rows are one grey level, so
    every candidate there ties."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    yy, xx = np.mgrid[0:H + 64, 0:W + 64]
    # a slope with ripples: the diamond descends to the shift
    big = (0.7 * xx + 0.6 * yy + 12 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
           + rng.integers(0, 3, xx.shape)).astype(np.int64)
    ref = big[32:32 + H, 32:32 + W]
    dx, dy = shift
    cur = big[32 + dy:32 + dy + H, 32 + dx:32 + dx + W].copy()
    ref = ref.copy()
    ref[:16 * flat_rows] = cur[:16 * flat_rows] = 90
    padded = np.pad(ref, EDGE, mode="edge").astype(np.uint8)
    cur_mbs = (cur.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)
               .reshape(-1, 16, 16).astype(np.int32))
    return cur_mbs, padded


@pytest.mark.parametrize("mb_w,mb_h,shift,search_range,flat", [
    (4, 3, (3, -2), 15, 1),
    (6, 4, (-7, 5), 12, 0),
    (5, 3, (2, 6), 15, 1),
    (3, 3, (-12, -9), 15, 0),
])
def test_search_and_refine(mb_w, mb_h, shift, search_range, flat):
    cur_mbs, padded = _me_planes(120 + mb_w, mb_w, mb_h, shift, flat)
    jfull = jme._search_jit(mb_w, mb_h, search_range)
    jmv_, jsad = jfull(jnp.asarray(cur_mbs), jnp.asarray(padded))
    tfull = tme.search(mb_w, mb_h, search_range, device=CPU)
    tmv_, tsad = tfull(_t(cur_mbs), _t(padded))
    _eq(tmv_, jmv_)
    _eq(tsad, jsad)
    interior = np.abs(np.asarray(jmv_) - shift).max(1) == 0
    assert interior.sum() >= mb_w * (mb_h - flat) // 3   # the shift is found
    if flat:                     # every candidate ties: the first one stays
        assert (np.asarray(jmv_)[:mb_w] == 0).all()
    jref = jme._hpel_refine_jit(mb_w, mb_h)(
        jnp.asarray(cur_mbs), jnp.asarray(padded), jmv_)
    tref = tme.hpel_refine(mb_w, mb_h, device=CPU)(
        _t(cur_mbs), _t(padded), tmv_)
    _eq_tree(tref, jref)
    _eq_tree(tme.motion_search(_t(cur_mbs), _t(padded), mb_w, mb_h,
                               search_range),
             jme.motion_search(jnp.asarray(cur_mbs), jnp.asarray(padded),
                               mb_w, mb_h, search_range))


def test_motion_search_ref_and_sad_ref():
    cur_mbs, padded = _me_planes(130, 2, 2, (1, -1))
    _eq_tree(tme.motion_search_ref(cur_mbs, padded, 2, 2, 3),
             jme.motion_search_ref(cur_mbs, padded, 2, 2, 3))
    _eq(tme.sad_ref(cur_mbs[0], cur_mbs[1]), jme.sad_ref(cur_mbs[0],
                                                         cur_mbs[1]))


# ---------------------------------------------------------------------- #
# the picture programs


def _encode_inputs(seed, mb_w, mb_h, nrefs):
    """(current y, u, v planes, per-MB qscale, padded references): the
    current picture is the first reference moved by a few pixels, plus
    noise, with one MB row of new content (intra candidates)."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    refs = testdata.padded_planes(rng, H, W)
    smooth = [np.pad(np.clip(128 + 60 * np.sin(np.add.outer(
        np.arange(p.shape[0] - 2 * EDGE) / 5.0,
        np.arange(p.shape[1] - 2 * EDGE) / 7.0)) +
        rng.integers(-20, 21, (p.shape[0] - 2 * EDGE, p.shape[1] - 2 * EDGE)),
        0, 255), EDGE, mode="edge").astype(np.uint8) for p in refs]
    refs = [smooth] + [testdata.padded_planes(rng, H, W)
                       for _ in range(nrefs - 1)]
    cur = []
    for p, s in zip(refs[0], (16, 8, 8)):
        c = np.roll(p[EDGE:-EDGE, EDGE:-EDGE], (2, -3), (0, 1)).astype(int)
        c = c + rng.integers(-3, 4, c.shape)
        c[:s] = rng.integers(0, 256, c[:s].shape)       # new content
        cur.append(np.clip(c, 0, 255).astype(np.uint8))
    qscale = rng.integers(2, 32, mb_w * mb_h).astype(np.int32)
    return cur, qscale, [p for r in refs for p in r]


@pytest.mark.parametrize("mb_w,mb_h", [(4, 3), (6, 4)])
@pytest.mark.parametrize("inter", [False, True])
def test_encode(mb_w, mb_h, inter):
    cur, qscale, refs = _encode_inputs(140 + mb_w + inter, mb_w, mb_h, 1)
    q = np.ones(64, np.int32)
    args = [*cur, qscale, q, q, *refs]
    want = jmv.encode_jit(mb_w, mb_h, inter, "h263", want_coeffs=inter)(
        *args)
    got = tmv.encode(mb_w, mb_h, inter, want_coeffs=inter,
                     device=CPU)(*state_from_numpy(args, CPU))
    _eq_tree(got, want)
    levels, mv, intra = (np.asarray(a) for a in want[:3])
    assert levels.any() and intra.any()
    if inter:
        assert (~intra).any() and mv.any()      # both decisions taken


@pytest.mark.parametrize("mb_w,mb_h", [(4, 3), (6, 4)])
def test_encode_b_h263(mb_w, mb_h):
    cur, qscale, refs = _encode_inputs(150 + mb_w, mb_w, mb_h, 2)
    q = np.ones(64, np.int32)
    args = [*cur, qscale, q, q, *refs]
    want = jmv.encode_b_h263_jit(mb_w, mb_h)(*args)
    got = tmv.encode_b_h263(mb_w, mb_h, device=CPU)(
        *state_from_numpy(args, CPU))
    _eq_tree(got, want)
    assert got[3].dtype == torch.int32
    assert len(np.unique(np.asarray(want[3]))) >= 2


@pytest.mark.parametrize("mb_w,mb_h,inter", [(4, 3, False), (5, 3, True),
                                             (6, 4, True)])
def test_recon_h263(mb_w, mb_h, inter):
    args, _ = testdata.recon_inputs(160 + mb_w * mb_h, mb_w, mb_h, inter)
    args[1] = np.clip(args[1], 1, 31).astype(np.int32)      # qscale 1..31
    want = jmv.recon_jit(mb_w, mb_h, "h263", False, inter)(*args)
    got = tmv.recon(mb_w, mb_h, "h263", False, inter, device=CPU)(
        *state_from_numpy(args, CPU))
    _eq_tree(got, want)
    assert got[0][0].dtype == torch.uint8


@pytest.mark.parametrize("flags", [dict(quant_kind="mpeg4mq"),
                                   dict(quant_kind="mpeg4"),
                                   dict(qpel=True), dict(any_4mv=True)])
def test_unported_programs_raise(flags):
    """The MPEG-4 reconstructions beside the 'h263' kind's default path:
    the MPEG quantisers, quarter-sample MC and 4MV."""
    key = dict(quant_kind="h263", alt_scan=False, inter_frame=True)
    key.update(flags)
    with pytest.raises(NotImplementedError, match="step 8b"):
        tmv.recon(2, 2, device=CPU, **key)


# ---------------------------------------------------------------------- #
# the encoder


def _port_frames(jax_frames):
    out = []
    for f in jax_frames:
        g = Frame(width=f.width, height=f.height, format="yuv420p")
        g.planes = [np.asarray(p) for p in f.planes]
        g.pts = f.pts
        out.append(g)
    return out


def port_encode(frames, settings, device="cpu"):
    """The port's counterpart of gen_torch_smoke_stream.encode_mpeg4:
    (packet bytes, anchors' reconstructed coded planes)."""
    f0 = frames[0]
    enc = find_encoder("mpeg4")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg4", width=f0.width,
        height=f0.height, pix_fmt="yuv420p"), device=device)
    for k, v in settings.items():
        enc.set_opt(k, v)
    anchors = []
    code_anchor = enc._code_anchor

    def recorded(*args):
        pkt = code_anchor(*args)
        anchors.append([p[EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
                        for p in enc._refs])
        return pkt
    enc._code_anchor = recorded
    return [p.data for p in enc.encode_all(frames)], anchors


@pytest.mark.parametrize("w,h,n,settings", [
    (64, 48, 5, {"b_frames": 0}),
    (64, 48, 5, {"b_frames": 2}),
    (96, 64, 3, {"acpred": 1, "ps": 200, "trellis": 1,
                 "lumi_masking": 0.5}),
])
def test_encoder_matches_jax(w, h, n, settings):
    frames = [pattern(w, h, t) for t in range(n)]
    want, want_anchors = encode_mpeg4(frames, settings)
    got, got_anchors = port_encode(_port_frames(frames), settings)
    assert got == want
    assert len(got_anchors) == len(want_anchors) == \
        (n if not settings.get("b_frames") else 3)
    _eq_tree(got_anchors, want_anchors)


def test_encoder_takes_tensor_frames():
    """Planes as (non-contiguous) tensor views, as a decoder returns them,
    and a picture that is no whole number of macroblocks."""
    frames = _port_frames([pattern(56, 40, t) for t in range(4)])
    want, _ = port_encode(frames, {"b_frames": 1})
    for f in frames:
        f.planes = [torch.nn.functional.pad(_t(p), (0, 3, 0, 5))[
            :p.shape[0], :p.shape[1]] for p in f.planes]
        assert not f.planes[0].is_contiguous()
    got, _ = port_encode(frames, {"b_frames": 1})
    assert got == want


@pytest.mark.parametrize("opt,value", [("qpel", 1), ("gmc", 1), ("mpegq", 1),
                                       ("mbcmp", "satd")])
def test_unported_options_raise(opt, value):
    enc = find_encoder("mpeg4")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg4", width=32, height=32,
        pix_fmt="yuv420p"), device="cpu")
    enc.set_opt(opt, value)
    with pytest.raises(NotImplementedError, match="step 8b"):
        enc.open()


def test_encoder_runs_on_the_card_unless_told():
    enc = find_encoder("mpeg4")
    assert enc.DEVICE_PART and not find_encoder("rawvideo").DEVICE_PART
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg4",
                          width=32, height=32, pix_fmt="yuv420p")
    assert enc(par, device="cpu").device == CPU
    if torch.cuda.is_available():
        assert enc(par).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            enc(par)
    with pytest.raises(AVError, match="step 7"):
        find_encoder("h264")


def test_encode_probe_stages():
    """The timing tool's stage wrappers see every stage of an I/P/B
    encode, change no byte, and leave the encoder as they found it."""
    from libav_tpu_torch.codecs.mpeg4.enc import MPEG4Encoder
    from libav_tpu_torch.tools import encode_probe
    frames = _port_frames([pattern(48, 32, t) for t in range(4)])
    settings = {"b_frames": 2}
    want, _ = encode_probe.encode(CPU, frames, settings)
    before = dict(MPEG4Encoder.__dict__), dict(tmv.Recon.__dict__)
    with encode_probe.stages(CPU) as st:
        got, _ = encode_probe.encode(CPU, frames, settings)
    assert got == want
    assert (dict(MPEG4Encoder.__dict__), dict(tmv.Recon.__dict__)) == before
    # VOPs I, P, B, B: two anchors, two B-VOPs searched both ways
    assert {k: len(v) for k, v in st.items()} == {
        "P search (full + half pel)": 1,
        "B search (full + half pel), per direction": 4,
        "FDCT + quant": 4, "anchor recon (one K2 launch)": 2,
        "levels/MV/intra download": 4, "I/P host packing": 2,
        "B host packing": 2}


@pytest.mark.slow
def test_committed_transcode_matches_golden():
    """mpeg2_1080p_ipbb decoded and encoded by the port on the CPU: every
    packet and anchor reconstruction equals the JAX package's golden."""
    import hashlib
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.mpeg12 import MPEG2Decoder
    gold = testdata.load_golden(testdata.mpeg4_golden_path())
    datas = testdata.read_packets(
        testdata.stream_paths(testdata.MPEG4_SOURCE)[0])
    frames = MPEG2Decoder(device="cpu").decode_all(
        Packet(data=d, pts=i) for i, d in enumerate(datas))
    got, anchors = port_encode(frames, gold["settings"])
    assert [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
            for d in got] == gold["packets"]
    assert testdata.digest(anchors)["frames"] == gold["anchors"]
    assert hashlib.md5(b"".join(got)).hexdigest() == gold["cli"]["md5"]


def test_m4v_demuxer_matches_jax():
    frames = [pattern(32, 32, t) for t in range(6)]
    datas, _ = encode_mpeg4(frames, {"b_frames": 2})
    data = b"".join(datas)
    chunks = list(tm4v.split_vops(data))
    assert chunks == list(jm4v.split_vops(data)) == datas
    assert tm4v.M4VDemuxer._infer_timestamps(chunks) == \
        jm4v.M4VDemuxer._infer_timestamps(chunks)
    assert tm4v.M4VDemuxer.probe(data) == jm4v.M4VDemuxer.probe(data) == 70
