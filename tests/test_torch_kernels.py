"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card (the plain versions are held against the JAX
package on the CPU in test_torch_h264_ops.py, test_torch_mpeg_ops.py and,
for P1 and P2, test_torch_tools.py; the first two import this module's
input makers).

This file imports no jax, so it runs on a host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: tests/conftest.py pins jax to the CPU and so imports it).
Elsewhere the `cuda` tests skip.
"""

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import timer
from libav_tpu_torch.codecs.h264 import device as tdev
from libav_tpu_torch.ops import h264deblock as tdb
from libav_tpu_torch.ops import h264intra
from libav_tpu_torch.ops import idct as tidct
from libav_tpu_torch.swscale import yuv2rgb as sws_yuv2rgb


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def edge_lines(seed, B=1500):
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 256, (B, 8)).astype(np.int32)
    # half the lines are smooth enough to pass the activity test
    lines[::2] = np.clip(lines[::2, :1] +
                         rng.integers(-6, 7, (B - B // 2, 8)), 0, 255)
    qp = rng.integers(0, 52, B).astype(np.int32)
    bs = rng.integers(0, 5, B).astype(np.int32)
    return lines, qp, bs


def deblock_inputs(seed, mb_w, mb_h, part):
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    bh, bw = 4 * mb_h, 4 * mb_w

    def blocky(h, w, s):
        lv = rng.integers(40, 220, (h // s, w // s))
        lv = lv + rng.integers(-2, 3, lv.shape).cumsum(1)
        img = np.repeat(np.repeat(lv, s, 0), s, 1)
        return np.clip(img + rng.integers(-2, 3, (h, w)), 0, 255) \
            .astype(np.int32)

    yp, up, vp = blocky(H, W, 4), blocky(H // 2, W // 2, 2), \
        blocky(H // 2, W // 2, 2)
    # neighbouring levels close enough to filter at these qps
    yp = np.clip(128 + (yp - 128) // 8, 0, 255).astype(np.int32)
    nmb = mb_w * mb_h
    intra = rng.random(nmb) < 0.3
    qp = rng.integers(20, 52, nmb).astype(np.int8)
    nnz = np.where(rng.random((bh, bw)) < 0.3,
                   rng.integers(1, 5, (bh, bw)), 0).astype(np.int8)
    t8 = rng.random(nmb) < 0.5
    if not part:
        mv = rng.integers(-6, 7, (nmb, 2)).astype(np.int16)
        return (yp, up, vp, intra, qp, nnz, mv), t8
    mv0 = rng.integers(-6, 7, (bh, bw, 2)).astype(np.int16)
    mv1 = rng.integers(-6, 7, (bh, bw, 2)).astype(np.int16)
    pid0 = rng.integers(-1, 2, (bh, bw)).astype(np.int8)
    pid1 = rng.integers(-1, 2, (bh, bw)).astype(np.int8)
    return (yp, up, vp, intra, qp, nnz, mv0, pid0, mv1, pid1), t8


def intra_inputs(seed, mb_w, mb_h):
    """Random inputs of the intra assembly (`ReconH264._wavefront`'s
    arguments, numpy): intra and inter MBs; I_16x16 and chroma in all 4
    modes, I_4x4 and I_8x8 in all 9, a few modes out of range; small
    residuals and a tenth of the MBs with large ones (both clamps); a
    twentieth I_PCM; slice starts in row_top."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    lm = rng.integers(0, 4, nmb)
    cm = rng.integers(0, 4, nmb)
    i4m = rng.integers(0, 9, (nmb, 16))
    odd = rng.random(nmb) < 0.05
    lm[odd] = rng.integers(-3, 8, odd.sum())
    cm[odd] = rng.integers(-3, 8, odd.sum())
    odd4 = rng.random((nmb, 16)) < 0.03
    i4m[odd4] = rng.integers(-12, 14, odd4.sum())
    big = rng.random((nmb, 1, 1)) < 0.1

    def samples(s):
        return rng.integers(0, 256, (nmb, s, s)).astype(np.int32)

    def resid(s):
        small = rng.integers(-12, 13, (nmb, s, s))
        return np.where(big, rng.integers(-300, 300, (nmb, s, s)),
                        small).astype(np.int32)
    row_top = rng.random(mb_h) >= 0.2
    row_top[0] = False
    return dict(
        intra=rng.random(nmb) < 0.8, luma_mode=lm.astype(np.int8),
        chroma_mode=cm.astype(np.int8), row_top=row_top,
        i4=rng.random(nmb) < 0.6, i4_modes=i4m.astype(np.int8),
        t8=rng.random(nmb) < 0.5,
        pred=(samples(16), samples(8), samples(8)),
        resid=(resid(16), resid(8), resid(8)),
        pcm=(rng.random(nmb) < 0.05,
             *(samples(s).astype(np.uint8) for s in (16, 8, 8))))


def intra_args(inputs, dev):
    """intra_inputs as `_wavefront`'s positional arguments on dev."""
    def t(a):
        return None if a is None else _t(a).to(dev)
    return tuple(tuple(t(a) for a in v) if isinstance(v, tuple) else t(v)
                 for v in inputs.values())


DEBLOCK_CASES = [
    # (part, any_t8, a_off, b_off, cqpo)
    (False, False, 0, 0, (0, 0)),
    (False, True, 3, -2, (0, 0)),
    (True, True, 0, 0, (2, -1)),
    (True, False, -4, 5, (0, 0)),
]


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    lines = torch.empty((4, 8), dtype=torch.int32, device=meta)
    v = torch.empty((4,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        tdb.h264_edge_filter_lines(lines, v, v)
    y = torch.empty((20, 20), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        tdb.h264_deblock_wave(y, y, y, y, 0, 1, 1, 0, 0)
    with pytest.raises(ValueError, match="no kernel"):
        tdb.h264_deblock_frame(y, y, y, y, 1, 1, 0, 0)
    blocks = torch.empty((4, 8, 8), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        tidct.idct8x8_int(blocks)
    with pytest.raises(ValueError, match="no kernel"):
        tidct.idct8x8_int_cm(blocks.reshape(4, 64).T)
    with pytest.raises(ValueError, match="no kernel"):
        tdb.h264_edge_filter_pm(lines.T, v, v)
    for dev in (meta, torch.device("cpu")):
        with pytest.raises(ValueError, match="no kernel"):
            h264intra.h264_intra_frame(1, 1, True, True, True, *intra_args(
                intra_inputs(0, 1, 1), dev))


def test_sws_yuv2rgb_refuses_devices_without_a_kernel():
    meta = torch.device("meta")
    y = torch.empty((4, 4), dtype=torch.uint8, device=meta)
    c = torch.empty((2, 2), dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        sws_yuv2rgb.yuv2rgb(y, c, c, 1, 1, False)


_needs_cuda = [pytest.mark.cuda,
               pytest.mark.skipif("not torch.cuda.is_available()",
                                  reason="needs a CUDA device")]


class TestKernelsOnCard:
    pytestmark = _needs_cuda

    @pytest.mark.parametrize("B", [1, 31, 33, 127, 4097, 49152, 100000,
                                   1 << 20])
    @pytest.mark.parametrize("chroma", [False, True])
    @pytest.mark.parametrize("offs", [(0, 0), (4, -2), (-6, 6)])
    def test_edge_filter_lines(self, chroma, offs, B):
        """K1's line kernel: whole and partial 32-line tiles, one tile to
        several per warp; one launch per call; equal to filter_edge_qp,
        and for luma without offsets to P2 on the transposed lines."""
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(80 + B, B=B))
        before = tdb.h264_edge_filter_lines.launches
        got = tdb.h264_edge_filter_lines(lines, qp, bs, chroma, *offs)
        torch.cuda.synchronize()
        assert tdb.h264_edge_filter_lines.launches == before + 1
        assert torch.equal(got, tdb.filter_edge_qp(lines, qp, bs, chroma,
                                                   *offs))
        if not chroma and offs == (0, 0):
            pm = tdb.h264_edge_filter_pm(lines.T.contiguous(), qp, bs)
            assert torch.equal(got, pm.T)

    def test_edge_filter_lines_needs_16_byte_rows(self):
        dev = torch.device("cuda", 0)
        buf = torch.zeros(64 * 8 + 1, dtype=torch.int32, device=dev)
        lines = buf[1:].view(64, 8)
        assert lines.is_contiguous() and lines.data_ptr() % 16
        v = torch.zeros(64, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="16-byte"):
            tdb.h264_edge_filter_lines(lines, v, v)

    @pytest.mark.parametrize("part,any_t8,a_off,b_off,cqpo", DEBLOCK_CASES)
    def test_deblock_wave(self, part, any_t8, a_off, b_off, cqpo):
        dev = torch.device("cuda", 0)
        mb_w, mb_h = 24, 17
        args, t8 = deblock_inputs(81, mb_w, mb_h, part)
        args = [_t(a).to(dev) for a in args]
        kw = {"t8": _t(t8).to(dev)} if any_t8 else {}
        fn = tdb.deblock_frame_exact(mb_w, mb_h, a_off, b_off, part=part,
                                     cqpo=cqpo, any_t8=any_t8)
        before = tdb.h264_deblock_wave.launches
        got = fn(*args, **kw, run=tdb.deblock_frame_waves)
        torch.cuda.synchronize()
        assert tdb.h264_deblock_wave.launches == \
            before + tdb.n_waves(mb_w, mb_h)
        want = fn(*args, **kw, run=tdb.deblock_frame_plain)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("mb_w,mb_h", [(1, 1), (1, 5), (5, 1), (7, 4),
                                           (4, 7), (120, 68)])
    @pytest.mark.parametrize("part,any_t8,a_off,b_off,cqpo", DEBLOCK_CASES)
    def test_deblock_frame(self, mb_w, mb_h, part, any_t8, a_off, b_off,
                           cqpo):
        """The frame kernel against its plain version and the wave kernel;
        20 more launches give identical planes (the race check)."""
        dev = torch.device("cuda", 0)
        args, t8 = deblock_inputs(85 + mb_w + mb_h, mb_w, mb_h, part)
        args = [_t(a).to(dev) for a in args]
        kw = {"t8": _t(t8).to(dev)} if any_t8 else {}
        fn = tdb.deblock_frame_exact(mb_w, mb_h, a_off, b_off, part=part,
                                     cqpo=cqpo, any_t8=any_t8)
        before = tdb.h264_deblock_frame.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert tdb.h264_deblock_frame.launches == before + 1
        for run in (tdb.deblock_frame_plain, tdb.deblock_frame_waves):
            want = fn(*args, **kw, run=run)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        for _ in range(20):
            again = fn(*args, **kw)
            for g, w in zip(again, got):
                assert torch.equal(g, w)

    @pytest.mark.parametrize("mb_w,mb_h", [(5, 2), (120, 34)])
    @pytest.mark.parametrize("part,any_t8,a_off,b_off,cqpo", DEBLOCK_CASES)
    def test_deblock_frame_field(self, mb_w, mb_h, part, any_t8, a_off,
                                 b_off, cqpo):
        """A field picture (120x34 MBs: a 1920x1088 stream's field) under
        the field bS rules: the frame kernel against its plain version,
        one launch, 20 more launches identical."""
        dev = torch.device("cuda", 0)
        args, t8 = deblock_inputs(95 + mb_w + mb_h, mb_w, mb_h, part)
        args = [_t(a).to(dev) for a in args]
        kw = {"t8": _t(t8).to(dev)} if any_t8 else {}
        fn = tdb.deblock_frame_exact(mb_w, mb_h, a_off, b_off, part=part,
                                     cqpo=cqpo, any_t8=any_t8, field=True)
        before = tdb.h264_deblock_frame.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert tdb.h264_deblock_frame.launches == before + 1
        want = fn(*args, **kw, run=tdb.deblock_frame_plain)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for _ in range(20):
            again = fn(*args, **kw)
            for g, w in zip(again, got):
                assert torch.equal(g, w)

    @pytest.mark.parametrize("mb_w,mb_h", [(1, 1), (1, 2), (2, 1), (2, 2),
                                           (1, 5), (5, 1), (2, 7), (7, 2),
                                           (120, 34), (120, 68)])
    @pytest.mark.parametrize("any_i4,any_i8,any_ipcm,row_top",
                             [(True, True, True, True),
                              (True, False, False, True),
                              (False, False, True, False)])
    def test_intra_frame(self, mb_w, mb_h, any_i4, any_i8, any_ipcm,
                         row_top):
        """The intra assembly kernel against its plain twin, byte for
        byte: one launch, one `h264.intra.kernel` count; at 120x34 and
        120x68 MBs, 20 more launches identical (the race check)."""
        dev = torch.device("cuda", 0)
        inputs = intra_inputs(100 + mb_w + 3 * mb_h, mb_w, mb_h)
        if not row_top:
            inputs["row_top"] = None
        args = intra_args(inputs, dev)
        flags = (any_i4, any_i8, any_ipcm)
        before = h264intra.h264_intra_frame.launches
        counted = timer.counters().get("h264.intra.kernel", 0)
        got = h264intra.h264_intra_frame(mb_w, mb_h, *flags, *args)
        torch.cuda.synchronize()
        assert h264intra.h264_intra_frame.launches == before + 1
        assert timer.counters()["h264.intra.kernel"] == counted + 1
        plain = tdev.ReconH264(mb_w, mb_h, any_i4=any_i4, any_i8=any_i8,
                               any_ipcm=any_ipcm).to(dev)
        want = plain._wavefront(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for _ in range(20 if mb_w * mb_h > 1000 else 0):
            again = h264intra.h264_intra_frame(mb_w, mb_h, *flags, *args)
            for g, w in zip(again, got):
                assert torch.equal(g, w)

    @pytest.mark.parametrize("name", ["h264_1080p_ipbb_cabac",
                                      "h264_1080p_ipcm", "h264_1088i_paff",
                                      "h264_1088i_mbaff"])
    def test_intra_frame_on_streams(self, monkeypatch, name):
        """The committed streams decode on the card to the JAX decoder's
        frames, one kernel launch per picture with an intra MB; on their
        first two all-intra pictures (frames, PAFF fields, MBAFF halves)
        the kernel equals its plain twin."""
        from libav_tpu_torch.avutil.frame import Packet
        from libav_tpu_torch.codecs.h264 import H264Decoder
        dev = torch.device("cuda", 0)
        path, golden = testdata.stream_paths(name)
        kernel, kept, calls = h264intra.h264_intra_frame, [], [0]

        def capturing(*args):
            calls[0] += 1
            out = kernel(*args)
            if len(kept) < 2 and bool(args[5].bool().all()):
                kept.append((args, [o.clone() for o in out]))
            return out
        monkeypatch.setattr(tdev, "h264_intra_frame", capturing)
        before = kernel.launches
        dec = H264Decoder(device=dev)
        try:
            frames = dec.decode_all(
                Packet(data=d, pts=i)
                for i, d in enumerate(testdata.read_packets(path)))
            host = [f.to_host().planes for f in frames]
        finally:
            dec.close()
        assert testdata.digest(host) == testdata.load_golden(golden)
        assert kernel.launches - before == calls[0] >= len(kept) >= 1
        for args, got in kept:
            mb_w, mb_h, any_i4, any_i8, any_ipcm = args[:5]
            plain = tdev.ReconH264(mb_w, mb_h, any_i4=any_i4,
                                   any_i8=any_i8,
                                   any_ipcm=any_ipcm).to(dev)
            want = plain._wavefront(*args[5:])
            for g, w in zip(got, want):
                assert torch.equal(g, w)

    @pytest.mark.parametrize("B", [1, 7, 3072, 48960])
    def test_idct8x8_int(self, B):
        dev = torch.device("cuda", 0)
        x = _t(testdata.idct_blocks(82 + B, B)).to(dev)
        before = tidct.idct8x8_int.launches
        got = tidct.idct8x8_int(x)
        torch.cuda.synchronize()
        assert tidct.idct8x8_int.launches == before + 1
        assert torch.equal(got, tidct.idct8x8_int_plain(x))

    @pytest.mark.parametrize("B", [1, 127, 128, 513, 48896])
    def test_idct8x8_int_cm(self, B):
        """P1, with the five input classes (values outside int16 and rows
        whose sums overflow int32 among them)."""
        dev = torch.device("cuda", 0)
        x = _t(testdata.idct_blocks(83 + B, B)).to(dev)
        xT = x.reshape(B, 64).T.contiguous()
        before = tidct.idct8x8_int_cm.launches
        got = tidct.idct8x8_int_cm(xT)
        torch.cuda.synchronize()
        assert tidct.idct8x8_int_cm.launches == before + 1
        assert torch.equal(got, tidct.idct8x8_int_cm_plain(xT))
        assert torch.equal(got.T.reshape(B, 8, 8), tidct.idct8x8_int(x))

    @pytest.mark.parametrize("b_frames", [0, 2])
    def test_mpeg4_encode(self, b_frames):
        """The MPEG-4 encoder on the card gives the CPU's packets, with one
        K2 launch per anchor (I/P VOP)."""
        from libav_tpu_torch.avutil.frame import Frame
        from libav_tpu_torch.codecs.api import CodecParameters, MediaType
        from libav_tpu_torch.codecs.mpeg4 import MPEG4Encoder
        w, h, n = 80, 48, 6
        frames = []
        for t in range(n):
            f = Frame(width=w, height=h, format="yuv420p")
            yy, xx = np.mgrid[0:h, 0:w]
            f.planes = [((xx // 2 + yy // 3 + 4 * t) % 256).astype(np.uint8),
                        np.full((h // 2, w // 2), 100 + t, np.uint8),
                        np.full((h // 2, w // 2), 140 - t, np.uint8)]
            f.pts = t
            frames.append(f)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg4",
                              width=w, height=h, pix_fmt="yuv420p")
        out = {}
        for dev in ("cpu", "cuda"):
            enc = MPEG4Encoder(par, device=dev)
            enc.set_opt("b_frames", b_frames)
            before = tidct.idct8x8_int.launches
            out[dev] = [p.data for p in enc.encode_all(frames)]
            launches = tidct.idct8x8_int.launches - before
        assert out["cuda"] == out["cpu"]
        assert launches == (n if b_frames == 0 else 3)

    @pytest.mark.parametrize("settings", [
        testdata.BENCH_SETTINGS, testdata.H264_EXT["h264_1088i_paff"][3],
        {"entropy": "cabac", "i4x4": 1, "deblock": 1, "refs": 1}])
    def test_h264_encode(self, settings):
        """The H.264 encoder on the card gives the CPU's packets, with one
        K1 launch per reference picture of its closed loop."""
        from libav_tpu_torch.avutil.frame import Frame
        from libav_tpu_torch.codecs.api import CodecParameters, MediaType
        from libav_tpu_torch.codecs.h264 import H264Encoder
        w, h, n = 64, 64, 5
        frames = []
        for t in range(n):
            f = Frame(width=w, height=h, format="yuv420p")
            f.planes = list(testdata.pattern(w, h, t))
            f.pts = t
            frames.append(f)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                              width=w, height=h, pix_fmt="yuv420p")
        out = {}
        for dev in ("cpu", "cuda"):
            enc = H264Encoder(par, device=dev)
            for k, v in settings.items():
                enc.set_opt(k, v)
            before = tdb.h264_deblock_frame.launches
            out[dev] = [p.data for p in enc.encode_all(frames)]
            launches = tdb.h264_deblock_frame.launches - before
        assert out["cuda"] == out["cpu"]
        # packets whose first NAL has a nonzero nal_ref_idc: not B
        refs = sum(1 for d in out["cuda"]
                   if d[d.index(b"\x00\x00\x01") + 3] & 0x60)
        assert launches == (refs if settings.get("deblock") else 0) > 0

    def test_mjpeg_encode(self):
        """The MJPEG encoder's plane program on the card gives the CPU's
        packets."""
        from libav_tpu_torch.avutil.frame import Frame
        from libav_tpu_torch.codecs.api import CodecParameters, MediaType
        from libav_tpu_torch.codecs.mjpeg import MJPEGEncoder
        w, h = 70, 38
        f = Frame(width=w, height=h, format="yuvj420p")
        f.planes = list(testdata.pattern(w, h, 3))
        f.pts = 0
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg",
                              width=w, height=h, pix_fmt="yuvj420p")
        out = [MJPEGEncoder(par, device=dev).encode_all([f])[0].data
               for dev in ("cpu", "cuda")]
        assert out[0] == out[1]

    @pytest.mark.parametrize("settings", [
        {"qpel": 1, "mpegq": 1, "acpred": 1},
        {"gmc": 3, "b_frames": 2},
        {"gmc": 1, "gmc_acc": 1},
        {"ps": 60, "data_partitioning": 1, "mbcmp": "satd", "b_frames": 2}])
    def test_mpeg4_asp_roundtrip(self, settings):
        """The MPEG-4 encoder's ASP options and the decoder on the card
        give the CPU's packets and frames, with one K2 launch per coded
        VOP in the decode."""
        from libav_tpu_torch.avutil.frame import Frame, Packet
        from libav_tpu_torch.codecs.api import CodecParameters, MediaType
        from libav_tpu_torch.codecs.mpeg4 import MPEG4Decoder, MPEG4Encoder
        w, h, n = 80, 48, 6
        rng = np.random.default_rng(7)
        base = rng.integers(16, 235, (h * 3 // 2, w)).astype(np.uint8)
        frames = []
        for t in range(n):
            fl = np.roll(np.roll(base, 3 * t, axis=1), t, axis=0)
            f = Frame(width=w, height=h, format="yuv420p")
            f.planes = [fl[:h].copy(),
                        fl[h:h + h // 4].reshape(h // 2, w // 2).copy(),
                        fl[h + h // 4:].reshape(h // 2, w // 2).copy()]
            f.pts = t
            frames.append(f)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mpeg4",
                              width=w, height=h, pix_fmt="yuv420p")
        pkts, planes = {}, {}
        for dev in ("cpu", "cuda"):
            enc = MPEG4Encoder(par, device=dev)
            for k, v in settings.items():
                enc.set_opt(k, v)
            pkts[dev] = [p.data for p in enc.encode_all(frames)]
            before = tidct.idct8x8_int.launches
            out = MPEG4Decoder(device=dev).decode_all(
                Packet(data=d, pts=i) for i, d in enumerate(pkts[dev]))
            torch.cuda.synchronize()
            launches = tidct.idct8x8_int.launches - before
            planes[dev] = [p.cpu() for f in out for p in f.planes]
        assert pkts["cuda"] == pkts["cpu"]
        assert all(torch.equal(a, b) for a, b in
                   zip(planes["cuda"], planes["cpu"]))
        assert len(planes["cuda"]) == 3 * n and launches == n

    @pytest.mark.parametrize("B", [1, 3, 127, 128, 255, 257, 513, 49152,
                                   200000, (1 << 20) - 4, 1 << 20,
                                   (1 << 20) + 3])
    def test_edge_filter_pm(self, B):
        """P2, qp 0-51 and bS 0-4: blocks of one span (B <= 135,168 on
        132 SMs) and blocks whose later spans come through the bulk-copy
        ring (B % 4 == 0) or per-thread loads, partial last spans; one
        launch."""
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(84 + B, B=B))
        xT = lines.T.contiguous()
        before = tdb.h264_edge_filter_pm.launches
        got = tdb.h264_edge_filter_pm(xT, qp, bs)
        torch.cuda.synchronize()
        assert tdb.h264_edge_filter_pm.launches == before + 1
        assert torch.equal(got, tdb.edge_filter_pm_plain(xT, qp, bs))
        assert torch.equal(got.T, tdb.h264_edge_filter_lines(lines, qp, bs))

    @pytest.mark.parametrize("view", ["narrowed", "offset", "offset_qp"])
    @pytest.mark.parametrize("B", [128, 1000, 49152])
    def test_edge_filter_pm_misaligned(self, view, B):
        """P2 on rows that are not 16-byte aligned: a narrow of an (8,
        B + 1) array made contiguous, the (8, B) array and its qp one
        int32 into their buffers (the per-thread path); one launch."""
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(41 + B, B=B))
        xT = lines.T.contiguous()
        if view == "narrowed":
            wide = torch.cat([xT, xT[:, :1]], dim=1)
            xT = wide.narrow(1, 0, B).contiguous()
        else:
            buf = torch.empty(8 * B + 1, dtype=torch.int32, device=dev)
            buf[1:] = xT.reshape(-1)
            xT = buf[1:].view(8, B)
            assert xT.is_contiguous() and xT.data_ptr() % 16 == 4
            if view == "offset_qp":
                qbuf = torch.empty(B + 1, dtype=torch.int32, device=dev)
                qbuf[1:] = qp
                qp = qbuf[1:]
        before = tdb.h264_edge_filter_pm.launches
        got = tdb.h264_edge_filter_pm(xT, qp, bs)
        torch.cuda.synchronize()
        assert tdb.h264_edge_filter_pm.launches == before + 1
        assert torch.equal(got, tdb.edge_filter_pm_plain(xT, qp, bs))

    def test_edge_filter_pm_refuses_strided(self):
        """A strided (8, B) view is refused, not copied."""
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(5, B=257))
        wide = lines.T.contiguous()
        before = tdb.h264_edge_filter_pm.launches
        with pytest.raises(ValueError):
            tdb.h264_edge_filter_pm(wide.narrow(1, 0, 256), qp[:256],
                                    bs[:256])
        assert tdb.h264_edge_filter_pm.launches == before

    @pytest.mark.parametrize("fmt", ["yuv444p", "yuvj444p", "yuv422p",
                                     "yuvj422p", "yuv420p", "yuvj420p"])
    @pytest.mark.parametrize("hw", [(1080, 1920), (37, 53), (71, 255)])
    def test_rgb_to_yuv_on_card(self, fmt, hw):
        """SwsContext's RGB -> YUV on the card gives the CPU's bytes (held
        to XLA's in test_torch_swscale.py) on testdata.rgb2yuv_frame."""
        from libav_tpu_torch import swscale as tsw
        h, w = hw
        rgb = torch.from_numpy(testdata.rgb2yuv_frame(h, w, fmt))
        planes = {}
        for dev in ("cpu", "cuda"):
            ctx = tsw.SwsContext(w, h, "rgb24", w, h, fmt, device=dev)
            out = ctx._rgb_to_yuv([rgb.to(dev)], "rgb24", fmt)
            assert all(p.device.type == dev for p in out)
            planes[dev] = [p.cpu() for p in out]
        assert all(torch.equal(a, b) for a, b in
                   zip(planes["cuda"], planes["cpu"]))

    @pytest.mark.parametrize("sub", [(1, 1), (1, 0), (0, 0)])
    @pytest.mark.parametrize("full", [False, True])
    @pytest.mark.parametrize("bgr", [False, True])
    @pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (480, 640),
                                    (37, 53), (33, 1934)])
    def test_sws_yuv2rgb(self, sub, full, bgr, hw):
        """sws_yuv2rgb against its plain version, byte for byte, one
        launch per call."""
        dev = torch.device("cuda", 0)
        (sw, sh), (h, w) = sub, hw
        rng = np.random.default_rng(90 + h)
        y = _t(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
        cshape = (-(-h >> sh), -(-w >> sw))
        u, v = (_t(rng.integers(0, 256, cshape, dtype=np.uint8)).to(dev)
                for _ in range(2))
        before = sws_yuv2rgb.yuv2rgb.launches
        got = sws_yuv2rgb.yuv2rgb(y, u, v, sw, sh, full, bgr)
        torch.cuda.synchronize()
        assert sws_yuv2rgb.yuv2rgb.launches == before + 1
        want = sws_yuv2rgb.yuv2rgb_plain(y, u, v, sw, sh, full, bgr)
        assert got.shape == (h, 3 * w) and torch.equal(got, want)

    @pytest.mark.parametrize("sub", [(2, 2), (2, 0), (0, 1)])
    @pytest.mark.parametrize("hw", [(720, 1280), (35, 70)])
    def test_sws_yuv2rgb_other_subsampling(self, sub, hw):
        """4:1:0, 4:1:1 and 4:4:0 (four pixels per chroma sample, two
        rows per thread)."""
        dev = torch.device("cuda", 0)
        (sw, sh), (h, w) = sub, hw
        rng = np.random.default_rng(97 + w)
        y = _t(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
        cshape = (-(-h >> sh), -(-w >> sw))
        u, v = (_t(rng.integers(0, 256, cshape, dtype=np.uint8)).to(dev)
                for _ in range(2))
        for full in (False, True):
            got = sws_yuv2rgb.yuv2rgb(y, u, v, sw, sh, full, True)
            want = sws_yuv2rgb.yuv2rgb_plain(y, u, v, sw, sh, full, True)
            assert torch.equal(got, want)

    @pytest.mark.parametrize("pitch,crop", [
        ((96, 48), (0, 0, 50, 70)), ((96, 48), (3, 16, 64, 64)),
        ((100, 50), (3, 16, 64, 64)), ((83, 41), (3, 16, 64, 64))])
    @pytest.mark.parametrize("sh", [1, 0])
    def test_sws_yuv2rgb_strided_planes(self, pitch, crop, sh):
        """Cropped views (row stride > width) need no copy: row strides a
        multiple of 16 or not (then some rows are 16-byte aligned and some
        not, and each lane picks its path), 4:2:0 and 4:2:2."""
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(pitch[0] + crop[0])
        (yp, cp), (r0, c0, h, w) = pitch, crop
        big = [_t(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
               for s in ((70, yp), (70 >> sh, cp), (70 >> sh, cp))]
        y = big[0][r0:r0 + h, c0:c0 + w]
        u, v = (b[r0 >> sh:(r0 >> sh) + (-(-h >> sh)),
                  c0 >> 1:(c0 >> 1) + (-(-w >> 1))] for b in big[1:])
        before = sws_yuv2rgb.yuv2rgb.launches
        got = sws_yuv2rgb.yuv2rgb(y, u, v, 1, sh, False)
        assert sws_yuv2rgb.yuv2rgb.launches == before + 1
        want = sws_yuv2rgb.yuv2rgb_plain(y.contiguous(), u.contiguous(),
                                         v.contiguous(), 1, sh, False)
        assert torch.equal(got, want)

    def test_imdct_on_card(self):
        """fftmdct.imdct runs on the card in float32 (TF32 off) and agrees
        with the CPU's float32 product to float32 rounding."""
        from libav_tpu_torch.ops import fftmdct
        rng = np.random.default_rng(96)
        for shape in ((1, 1024), (8, 128)):
            spec = _t(rng.standard_normal(shape).astype(np.float32) * 100)
            calls = fftmdct.imdct.calls
            got = fftmdct.imdct(spec.cuda())
            assert got.device.type == "cuda" and got.dtype == torch.float32
            assert fftmdct.imdct.calls == calls + 1
            want = fftmdct.imdct(spec)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)
