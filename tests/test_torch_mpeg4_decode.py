"""The PyTorch port's MPEG-4 part 2 decoder and its device programs held
against the JAX package.

Small streams (64x48 or 96x64, 4-6 frames) are encoded with the JAX
package's encoder from a seeded pattern: IPB, quarter-sample with the
MPEG quantiser and AC prediction, GMC S-VOPs with 1-3 warping points,
video packets with and without data partitioning, the SATD decision.
Streams the JAX encoder cannot write are assembled by hand with PutBits:
a VOL that loads its own quantiser matrices, and P-VOPs of INTER4V
macroblocks with nonzero 8x8 vectors (half- and quarter-sample) followed
by a B-VOP whose direct mode inherits them. A video packet cut in half
takes both decoders through their concealment. The JAX decoder and the
port's on the CPU must give `np.array_equal` frames; the device
programs (quarter-sample MC, the 4MV chroma rules, the GMC warp, the
MPEG matrix dequantiser, the Hadamard cost) are held against the JAX
functions op by op, and the port's avconv/avprobe against the JAX CLI's
output byte for byte.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.bitstream import PutBits
from libav_tpu.codecs.api import CodecParameters as JParams
from libav_tpu.codecs.api import MediaType as JMediaType
from libav_tpu.codecs.mpeg4 import MPEG4Decoder as JaxDecoder
from libav_tpu.codecs.mpeg4 import MPEG4Encoder as JaxEncoder
from libav_tpu.codecs.mpeg4 import tables as JT
from libav_tpu.codecs.mpeg4.dec import PICT_B, PICT_P, _VopPred
from libav_tpu.codecs.mpeg4.enc import encode_block_rl, encode_mv_component
from libav_tpu.ops import gmc as jgmc
from libav_tpu.ops import mc as jmc
from libav_tpu.ops import mecmp as jmecmp
from libav_tpu.ops import quant as jq
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu.tools import avprobe as jax_avprobe
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder, mpegvideo
from libav_tpu_torch.codecs.mpeg4 import MPEG4Decoder
from libav_tpu_torch.codecs.parsers import find_parser
from libav_tpu_torch.ops import gmc as tgmc
from libav_tpu_torch.ops import idct as tidct
from libav_tpu_torch.ops import mc as tmc
from libav_tpu_torch.ops import mecmp as tmecmp
from libav_tpu_torch.ops import quant as tq
from libav_tpu_torch.tools import avconv, avprobe
from tools.gen_torch_smoke_stream import encode_mpeg4, pattern

CPU = torch.device("cpu")
VOL = b"\x00\x00\x01\x20"
VOP = b"\x00\x00\x01\xB6"


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def jax_decode(datas):
    dec = JaxDecoder(JParams(codec_type=JMediaType.VIDEO, codec_id="mpeg4"))
    frames = dec.decode_all(JPacket(data=d, pts=i)
                            for i, d in enumerate(datas))
    return [[np.asarray(p) for p in f.planes] for f in frames]


def port_decode(datas):
    dec = find_decoder("mpeg4")(device="cpu")
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [f.to_host().planes for f in frames]


def assert_same(datas, nframes):
    """Both decoders on datas: the same frames, nframes of them."""
    want = jax_decode(datas)
    got = port_decode(datas)
    assert len(got) == len(want) == nframes
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            assert gp.dtype == np.uint8
            np.testing.assert_array_equal(gp, wp)
    return got


def moving_texture(w, h, n, seed=11):
    """n frames of a seeded random texture moving 3 px right and 1 down
    per frame (the JAX package's GMC parity input)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(16, 235, (h * 3 // 2, w)).astype(np.uint8)
    frames = []
    for t in range(n):
        fl = np.roll(np.roll(base, 3 * t, axis=1), t, axis=0)
        f = JFrame(width=w, height=h, format="yuv420p")
        f.planes = [fl[:h].copy(),
                    fl[h:h + h // 4].reshape(h // 2, w // 2).copy(),
                    fl[h + h // 4:].reshape(h // 2, w // 2).copy()]
        f.pts = t
        frames.append(f)
    return frames


# ---------------------------------------------------------------------- #
# whole streams from the JAX encoder


STREAMS = {
    "ipb": (64, 48, 5, {"b_frames": 2}),
    "qpel_mpegq_acpred": (64, 48, 4, {"qpel": 1, "mpegq": 1, "acpred": 1}),
    "mpegq_ipb": (64, 48, 5, {"mpegq": 1, "b_frames": 2}),
    "ps": (96, 64, 5, {"ps": 100, "b_frames": 2, "acpred": 1}),
    "ps_dp_satd": (96, 64, 5, {"ps": 100, "data_partitioning": 1,
                               "mbcmp": "satd", "b_frames": 2}),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jax(name):
    w, h, n, settings = STREAMS[name]
    datas, _ = encode_mpeg4([pattern(w, h, t) for t in range(n)], settings)
    assert_same(datas, n)


@pytest.mark.parametrize("points,acc,bf", [
    (1, 3, 0),   # translation fast path (gmc1), 1/16 pel
    (1, 0, 0),   # half-pel phases -> put_pixels fallback + RSHIFT amv
    (2, 3, 0),   # general affine warp
    (3, 1, 0),   # 3-point warp, 1/4 pel
    (3, 3, 2),   # GMC anchors with B-VOPs (amv colocated motion)
])
def test_gmc_decode_matches_jax(points, acc, bf):
    n = 6 if bf else 5
    datas, _ = encode_mpeg4(moving_texture(96, 64, n),
                            {"gmc": points, "gmc_acc": acc, "b_frames": bf,
                             "gop_size": n})
    assert [d[d.index(VOP) + 4] >> 6 for d in datas][1] == 3    # S-VOP
    assert_same(datas, n)


def _vol_loading_matrices(w, h, intra, inter_head):
    """A simple-profile VOL with quant_type 1 that loads all 64 intra
    matrix entries and the first len(inter_head) inter ones (the rest
    repeat the last, mpeg4videodec.c:1830), in zigzag order."""
    pb = PutBits()
    pb.put_bits(1, 0)           # random_accessible_vol
    pb.put_bits(8, 0x01)        # video_object_type_indication: simple
    pb.put_bits(1, 0)           # is_object_layer_identifier
    pb.put_bits(4, 1)           # aspect_ratio_info
    pb.put_bits(1, 0)           # vol_control_parameters
    pb.put_bits(2, 0)           # shape: rectangular
    pb.put_bits(1, 1)
    pb.put_bits(16, 25)         # time resolution, as the encoder's
    pb.put_bits(1, 1)
    pb.put_bits(1, 0)           # fixed_vop_rate
    pb.put_bits(1, 1)
    pb.put_bits(13, w)
    pb.put_bits(1, 1)
    pb.put_bits(13, h)
    pb.put_bits(1, 1)
    pb.put_bits(1, 0)           # interlaced
    pb.put_bits(1, 1)           # obmc_disable
    pb.put_bits(1, 0)           # sprite_enable
    pb.put_bits(1, 0)           # not_8_bit
    pb.put_bits(1, 1)           # quant_type: MPEG
    pb.put_bits(1, 1)           # load_intra_quant_mat
    for v in intra:
        pb.put_bits(8, int(v))
    pb.put_bits(1, 1)           # load_nonintra_quant_mat
    for v in inter_head:
        pb.put_bits(8, int(v))
    pb.put_bits(8, 0)           # end of the list
    pb.put_bits(1, 1)           # complexity_estimation_disable
    pb.put_bits(1, 1)           # resync_marker_disable
    pb.put_bits(1, 0)           # data_partitioned
    pb.put_bits(1, 0)           # scalability
    pb.put_bits(1, 0)           # next_start_code stuffing
    pb.align(pad_bit=1)
    return VOL + pb.flush()


def test_loaded_matrices_match_jax():
    """The JAX encoder writes only the default matrices: its VOL is
    replaced by one that loads others, and both decoders dequantise the
    same levels with them."""
    datas, _ = encode_mpeg4([pattern(64, 48, t) for t in range(4)],
                            {"mpegq": 1, "b_frames": 1, "acpred": 1})
    rng = np.random.default_rng(5)
    vol = _vol_loading_matrices(64, 48, rng.integers(8, 60, 64),
                                rng.integers(12, 40, 10))
    first = datas[0]
    a, b = first.index(VOL), first.index(VOP)
    datas = [first[:a] + vol + first[b:]] + datas[1:]
    got = assert_same(datas, 4)
    plain = port_decode([first] + datas[1:])
    assert not np.array_equal(got[0][0], plain[0][0])


@pytest.mark.parametrize("dp", [0, 1])
def test_truncated_packet_is_concealed(dp):
    """A P-VOP cut in half: both decoders conceal the lost macroblocks
    alike. Without data partitioning the VOP holds several video packets
    and the decoders resynchronise at the next marker; with it the JAX
    encoder sizes packets by partition A alone, so this VOP is one packet
    and all of it is concealed."""
    datas, _ = encode_mpeg4([pattern(96, 64, t) for t in range(5)],
                            {"ps": 60, "data_partitioning": dp,
                             "mbcmp": "satd", "b_frames": 2})
    assert datas[1][datas[1].index(VOP) + 4] >> 6 == 1     # a P-VOP
    whole = port_decode(datas)
    got = assert_same(testdata.cut_packet(datas, 1), 5)
    assert not np.array_equal(got[3][0], whole[3][0])
    if not dp:
        # the first packet survives: its macroblocks decode as before
        np.testing.assert_array_equal(got[3][0][:16], whole[3][0][:16])


# ---------------------------------------------------------------------- #
# 4MV, assembled by hand


def _mb_4mv_stream(qpel: bool):
    """I-VOP from the JAX encoder (its VOL: quarter_sample = qpel), then
    a hand-packed 4x3-MB P-VOP (INTER4V MBs with nonzero 8x8 vectors and
    coded blocks, 1MV MBs, one intra MB, skips) and a B-VOP of direct
    MBs, whose colocated 4MV MBs give 8x8 direct vectors."""
    w, h = 64, 48
    enc = JaxEncoder(JParams(codec_type=JMediaType.VIDEO, codec_id="mpeg4",
                             width=w, height=h, pix_fmt="yuv420p"))
    enc.set_opt("qscale", 5)
    enc.set_opt("qpel", int(qpel))
    i_vop = enc.encode_all([pattern(w, h, 0)])[0].data
    fcode = enc._fcode
    rng = np.random.default_rng(23 + qpel)
    mw, mh = w // 16, h // 16
    pred = _VopPred(mw, mh)
    kinds = ["4mv", "1mv", "skip", "4mv", "4mv", "intra", "1mv", "4mv",
             "skip", "4mv", "1mv", "4mv"]
    lim = 28 if qpel else 14

    pb = PutBits()
    enc._frame_idx = 3
    enc._vop_header(pb, PICT_P, 2)
    for idx, kind in enumerate(kinds):
        mb_x, mb_y = idx % mw, idx // mw
        if kind == "skip":
            pb.put_bits(1, 1)               # not_coded
            for k in range(4):
                pred.grid_put(mb_x, mb_y, k, 0, 0)
            continue
        pb.put_bits(1, 0)
        if kind == "intra":
            # INTRA, cbpc 0, ac_pred 0, cbpy 0, DC of every block 0
            i = 4 * JT.MBT_INTRA
            pb.put_bits(JT.INTER_MCBPC_BITS[i], JT.INTER_MCBPC_CODE[i])
            pb.put_bits(1, 0)
            code, bits = JT.CBPY[0]
            pb.put_bits(bits, code)
            for b in range(6):
                code, bits = (JT.DC_LUM if b < 4 else JT.DC_CHROM)[0]
                pb.put_bits(bits, code)
            for k in range(4):
                pred.grid_put(mb_x, mb_y, k, 0, 0)
            continue
        cbpc, cbpy = int(rng.integers(0, 4)), int(rng.integers(0, 16))
        group = JT.MBT_INTER4V if kind == "4mv" else JT.MBT_INTER
        i = 4 * group + cbpc
        pb.put_bits(JT.INTER_MCBPC_BITS[i], JT.INTER_MCBPC_CODE[i])
        code, bits = JT.CBPY[15 - cbpy]
        pb.put_bits(bits, code)
        vecs = rng.integers(-lim, lim + 1, (4 if kind == "4mv" else 1, 2))
        for k, (vx, vy) in enumerate(vecs):
            px, py = pred.grid_pred(mb_x, mb_y, k)
            encode_mv_component(pb, int(vx) - px, fcode)
            encode_mv_component(pb, int(vy) - py, fcode)
            if kind == "4mv":
                pred.grid_put(mb_x, mb_y, k, int(vx), int(vy))
        if kind == "1mv":
            for k in range(4):
                pred.grid_put(mb_x, mb_y, k, int(vecs[0, 0]),
                              int(vecs[0, 1]))
        cbp = (cbpy << 2) | cbpc
        for b in range(6):
            if cbp & (0x20 >> b):
                lv = np.where(rng.random(64) < 0.1,
                              rng.integers(-6, 7, 64), 0)
                lv[int(rng.integers(0, 64))] = 3
                encode_block_rl(pb, lv, 0, False)
    enc._stuff(pb)
    p_vop = VOP + pb.flush()

    pb = PutBits()
    enc._vop_header(pb, PICT_B, 1)
    for kind in kinds:
        if kind != "skip":                  # skipped colocated: no bits
            pb.put_bits(1, 1)               # modb 1: direct, no dMV
    enc._stuff(pb)
    return [i_vop, p_vop, VOP + pb.flush()]


@pytest.mark.parametrize("qpel", [False, True])
def test_4mv_vops_match_jax(qpel):
    datas = _mb_4mv_stream(qpel)
    got = assert_same(datas, 3)
    # the vectors move the picture: the P frame is no copy of the I
    assert not np.array_equal(got[2][0], got[0][0])


def test_one_idct_per_coded_vop(monkeypatch):
    """Every coded VOP's residual goes through one idct8x8_int call, and
    on the CPU no kernel is launched."""
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int(blocks)
    monkeypatch.setattr(mpegvideo, "idct8x8_int", counted)
    w, h, n, settings = STREAMS["ipb"]
    datas, _ = encode_mpeg4([pattern(w, h, t) for t in range(n)], settings)
    before = tidct.idct8x8_int.launches
    port_decode(datas)
    assert calls == [4 * 3 * 6] * n
    assert tidct.idct8x8_int.launches == before == 0


def test_find_decoder_runs_on_the_card_unless_told():
    assert find_decoder("mpeg4") is MPEG4Decoder
    assert find_decoder("mpeg4")(device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            find_decoder("mpeg4")()
    # the legacy decoders of step 8b and ProRes (step 11) resolve to the
    # port's classes
    from libav_tpu_torch.codecs.h263dec import FLV1Decoder, H263Decoder
    from libav_tpu_torch.codecs.msmpeg4dec import (MSMPEG4v3Decoder,
                                                   WMV1Decoder)
    for codec, cls in (("h263", H263Decoder), ("flv1", FLV1Decoder),
                       ("msmpeg4v3", MSMPEG4v3Decoder),
                       ("wmv1", WMV1Decoder)):
        assert find_decoder(codec) is cls
    from libav_tpu_torch.codecs.prores.dec import ProresDecoder
    assert find_decoder("prores") is ProresDecoder


def test_parser_splits_vops():
    datas, _ = encode_mpeg4([pattern(64, 48, t) for t in range(4)],
                            {"b_frames": 1})
    stream = b"".join(datas)
    parser = find_parser("mpeg4")()
    out = []
    for k in range(0, len(stream), 97):
        out += parser.parse(stream[k:k + 97])
    out += parser.parse(b"", eof=True)
    assert out == datas


# ---------------------------------------------------------------------- #
# the device programs, op by op


@pytest.mark.parametrize("no_rnd", [0, 1])
def test_mc_qpel_mpeg4(no_rnd):
    rng = np.random.default_rng(40 + no_rnd)
    H, W, B = 48, 64, 60
    padded = rng.integers(0, 256, (H + 2 * jmc.EDGE, W + 2 * jmc.EDGE)) \
        .astype(np.uint8)
    xs = rng.integers(0, W - 15, B).astype(np.int32)
    ys = rng.integers(0, H - 15, B).astype(np.int32)
    mvx = rng.integers(-90, 91, B).astype(np.int32)
    mvy = rng.integers(-90, 91, B).astype(np.int32)
    mvx[:4] = [-400, 400, 3, -7]            # clipped into the plane
    args = (padded, xs, ys, mvx, mvy)
    targs = [_t(a) for a in args]
    want = jmc.mc_qpel_mpeg4(*args, no_rnd=no_rnd)
    _eq(tmc.mc_qpel_mpeg4(*targs, no_rnd=no_rnd), want)
    inb = (np.abs(mvx) < 60) & (np.abs(mvy) < 60)
    _eq(want[inb], jmc.mc_qpel_mpeg4_ref(padded, xs[inb], ys[inb],
                                         mvx[inb], mvy[inb], no_rnd))
    _eq(tmc.mc_qpel_mpeg4_8(*targs, no_rnd=no_rnd),
        jmc.mc_qpel_mpeg4_8(*args, no_rnd=no_rnd))
    mv4 = rng.integers(-70, 71, (B, 4, 2)).astype(np.int32)
    _eq(tmc.mc_qpel_mpeg4_tiled8(targs[0], targs[1], targs[2], _t(mv4),
                                 no_rnd=no_rnd),
        jmc.mc_qpel_mpeg4_tiled8(padded, xs, ys, mv4, no_rnd=no_rnd))
    _eq(tmc.mc_hpel_tiled8(targs[0], targs[1], targs[2], _t(mv4),
                           1 - no_rnd),
        jmc.mc_hpel_tiled8(padded, xs, ys, mv4, 1 - no_rnd))
    np.testing.assert_array_equal(tmc._qpel_lowpass_matrix(8),
                                  jmc._qpel_lowpass_matrix(8))


def test_chroma_vector_rules():
    rng = np.random.default_rng(41)
    mv = rng.integers(-300, 301, (500, 2)).astype(np.int32)
    mv4 = rng.integers(-300, 301, (500, 4, 2)).astype(np.int32)
    _eq(tmc.chroma_mv_qpel(_t(mv)), jmc.chroma_mv_qpel(mv))
    _eq(tmc.chroma_mv_4mv_hpel(_t(mv4)), jmc.chroma_mv_4mv_hpel(mv4))
    _eq(tmc.chroma_mv_4mv_qpel(_t(mv4)), jmc.chroma_mv_4mv_qpel(mv4))
    _eq(tmc.chroma_mv_h263_4mv(_t(mv)), jmc.chroma_mv_h263_4mv(mv))


@pytest.mark.parametrize("qpel", [False, True])
def test_recon_4mv(qpel):
    """Recon(any_4mv=True) on random inputs, the mpeg4 and mpeg4mq kinds,
    both rounding modes (the smoke run repeats this at 1920x1088 on the
    card)."""
    from libav_tpu.codecs import mpegvideo as jmv
    from libav_tpu_torch.avutil.hwdevice import state_from_numpy
    for kind, rnd in (("mpeg4", 0), ("mpeg4mq", 1)):
        args, kw = testdata.recon_inputs(50 + qpel, 5, 4, True,
                                         four_mv=True)
        args[1] = np.clip(args[1], 1, 31).astype(np.int32)
        want = jmv.recon_jit(5, 4, kind, False, True, rnd, qpel=qpel,
                             any_4mv=True)(*args, **kw)
        got = mpegvideo.recon(5, 4, kind, False, True, rnd, qpel=qpel,
                              any_4mv=True, device=CPU)(
            *state_from_numpy(args, CPU), **state_from_numpy(kw, CPU))
        _eq(got, want)


def _gmc_params(points, acc, w, h, n):
    traj = [((2 * n) % 17 - 8, (3 * n) % 13 - 6),
            (1 + n % 2, n % 3 - 1), (n % 3 - 1, 1)][:points]
    off, dlt, shf, rp = jgmc.compute_warp_params(traj, points, acc, w, h)
    assert (off, dlt, shf, rp) == tgmc.compute_warp_params(traj, points,
                                                           acc, w, h)
    return (jgmc.GMCParams(off, dlt, shf, rp, acc, n & 1),
            tgmc.GMCParams(off, dlt, shf, rp, acc, n & 1))


@pytest.mark.parametrize("points,acc", [(1, 3), (1, 0), (2, 3), (2, 1),
                                        (3, 3), (3, 0)])
def test_warp_refs_and_amv(points, acc):
    rng = np.random.default_rng(60 + 4 * points + acc)
    mb_w, mb_h = 6, 4
    refs = testdata.padded_planes(rng, 16 * mb_h, 16 * mb_w)
    for n in (1, 6):
        jp, tp = _gmc_params(points, acc, 16 * mb_w, 16 * mb_h, n)
        _eq(tgmc.warp_refs([_t(r) for r in refs], tp, mb_w, mb_h),
            jgmc.warp_refs(refs, jp, mb_w, mb_h))
        for qs in (0, 1):
            for mb_x, mb_y in ((0, 0), (5, 3), (2, 1)):
                for comp in (0, 1):
                    assert tgmc.get_amv(tp, qs, 1, mb_x, mb_y, comp) == \
                        jgmc.get_amv(jp, qs, 1, mb_x, mb_y, comp)


@pytest.mark.parametrize("intra", [True, False])
def test_mq_dequant(intra):
    rng = np.random.default_rng(70 + intra)
    B = 300
    c = np.where(rng.random((B, 64)) < 0.3,
                 rng.integers(-2047, 2048, (B, 64)), 0).astype(np.int32)
    qs = rng.integers(1, 32, B).astype(np.int32)
    qmat = rng.integers(1, 256, 64).astype(np.int32)
    if intra:
        dcs = rng.integers(8, 47, B).astype(np.int32)
        want = jq.mpeg4_mq_dequant_intra(c, qs, qmat, dcs)
        got = tq.mpeg4_mq_dequant_intra(_t(c), _t(qs), _t(qmat), _t(dcs))
    else:
        want = jq.mpeg4_mq_dequant_inter(c, qs, qmat)
        got = tq.mpeg4_mq_dequant_inter(_t(c), _t(qs), _t(qmat))
    _eq(got, want)


def test_mecmp():
    """The encoder's SATD (butterflies) against the JAX einsum program,
    and each 8x8 quadrant against the reference's butterfly network."""
    rng = np.random.default_rng(80)
    a16 = rng.integers(0, 256, (20, 16, 16)).astype(np.int32)
    b16 = rng.integers(0, 256, (20, 16, 16)).astype(np.int32)
    got = tmecmp.satd16_of(_t(a16 - b16))
    assert got.dtype == torch.int32
    _eq(got, jmecmp.satd16(a16, b16))
    quad = tmecmp.hadamard8(_t(a16[:3, 8:, :8] - b16[:3, 8:, :8]))
    assert [int(x) for x in quad.abs().sum(dim=(-1, -2))] == \
        [jmecmp.hadamard8_diff_ref(a16[i, 8:, :8], b16[i, 8:, :8])
         for i in range(3)]


# ---------------------------------------------------------------------- #
# the CLI


@pytest.fixture(scope="module")
def asp_files(tmp_path_factory):
    """x.m4v (qpel, mpegq, acpred) and x.avi (FMP4, IPB from the JAX
    CLI's transcode of x.m4v)."""
    d = tmp_path_factory.mktemp("m4v")
    datas, _ = encode_mpeg4([pattern(64, 48, t) for t in range(5)],
                            {"qpel": 1, "mpegq": 1, "acpred": 1})
    m4v = str(d / "x.m4v")
    with open(m4v, "wb") as f:
        f.write(b"".join(datas))
    avi = str(d / "x.avi")
    assert jax_avconv.main(["-i", m4v, "-c:v", "mpeg4", "-g", "3", "-bf",
                            "2", avi]) == 0
    return {"m4v": m4v, "avi": avi}


def _framecrc(tool, src, dst, **kw):
    assert tool.main(["-i", src, "-f", "framecrc", dst], **kw) == 0
    with open(dst) as f:
        return f.read()


@pytest.mark.parametrize("name", ["m4v", "avi"])
def test_avconv_framecrc_matches_jax(name, asp_files, tmp_path):
    src = asp_files[name]
    want = _framecrc(jax_avconv, src, str(tmp_path / "jax.crc"))
    got = _framecrc(avconv, src, str(tmp_path / "port.crc"), device="cpu")
    assert got == want
    assert want.count("\n0, ") == 5


def test_avprobe_show_frames_matches_jax(asp_files):
    def probe(tool, **kw):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tool.main(["-show_frames", asp_files["avi"]], **kw) == 0
        return out.getvalue()
    want = probe(jax_avprobe)
    assert probe(avprobe, device="cpu") == want
    assert want.count("[frames.frame]") == 5
