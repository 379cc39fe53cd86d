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
from libav_tpu_torch.ops import h264deblock as tdb
from libav_tpu_torch.ops import idct as tidct


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


_needs_cuda = [pytest.mark.cuda,
               pytest.mark.skipif("not torch.cuda.is_available()",
                                  reason="needs a CUDA device")]


class TestKernelsOnCard:
    pytestmark = _needs_cuda

    @pytest.mark.parametrize("chroma", [False, True])
    @pytest.mark.parametrize("offs", [(0, 0), (4, -2), (-6, 6)])
    def test_edge_filter_lines(self, chroma, offs):
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(80, B=100000))
        before = tdb.h264_edge_filter_lines.launches
        got = tdb.h264_edge_filter_lines(lines, qp, bs, chroma, *offs)
        torch.cuda.synchronize()
        assert tdb.h264_edge_filter_lines.launches == before + 1
        assert torch.equal(got, tdb.filter_edge_qp(lines, qp, bs, chroma,
                                                   *offs))

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

    @pytest.mark.parametrize("B", [1, 127, 128, 513, 49152])
    def test_edge_filter_pm(self, B):
        """P2, qp 0-51 and bS 0-4."""
        dev = torch.device("cuda", 0)
        lines, qp, bs = (_t(a).to(dev) for a in edge_lines(84 + B, B=B))
        xT = lines.T.contiguous()
        before = tdb.h264_edge_filter_pm.launches
        got = tdb.h264_edge_filter_pm(xT, qp, bs)
        torch.cuda.synchronize()
        assert tdb.h264_edge_filter_pm.launches == before + 1
        assert torch.equal(got, tdb.edge_filter_pm_plain(xT, qp, bs))
        assert torch.equal(got.T, tdb.h264_edge_filter_lines(lines, qp, bs))
