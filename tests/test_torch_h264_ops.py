"""The PyTorch port's H.264 device modules held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU; the Pallas edge-filter kernel in interpret mode) and its port
counterpart on the CPU. The codec is integer-exact, so the tolerance is
exact equality: any difference is a bug. The hand-written kernels are
held against these plain versions in test_torch_kernels.py, on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs.h264 import device as jdev
from libav_tpu.ops import h264deblock as jdb
from libav_tpu.ops import h264mc as jmc
from libav_tpu.ops import h264pred as jpred
from libav_tpu.ops import h264transform as jtr
from libav_tpu.ops.mc import EDGE
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.codecs.h264 import device as tdev
from libav_tpu_torch.ops import h264deblock as tdb
from libav_tpu_torch.ops import h264mc as tmc
from libav_tpu_torch.ops import h264pred as tpred
from libav_tpu_torch.ops import h264transform as ttr
from test_torch_kernels import DEBLOCK_CASES, deblock_inputs, edge_lines

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


# ---------------------------------------------------------------------- #
# transforms


class TestTransform:
    def test_idct4x4(self):
        rng = np.random.default_rng(1)
        x = rng.integers(-2000, 2000, (64, 4, 4)).astype(np.int32)
        got = ttr.idct4x4(_t(x))
        _eq(got, jtr.idct4x4(jnp.asarray(x)))
        _eq(got, jtr.idct4x4_ref(x))

    def test_idct8x8(self):
        rng = np.random.default_rng(2)
        x = rng.integers(-3000, 3000, (48, 8, 8)).astype(np.int32)
        got = ttr.idct8x8_h264(_t(x))
        _eq(got, jtr.idct8x8_h264(jnp.asarray(x)))
        _eq(got, jtr.idct8x8_h264_ref(x))

    def test_hadamard_and_chroma_dc(self):
        rng = np.random.default_rng(3)
        dc = rng.integers(-500, 500, (32, 4, 4)).astype(np.int32)
        _eq(ttr.hadamard4x4(_t(dc)), jtr.hadamard4x4_ref(dc))
        c = rng.integers(-500, 500, (32, 4)).astype(np.int32)
        # at qp 4 the golden scales the 2x2 butterfly by (16 << 0) >> 1
        f = ttr.chroma_dc_2x2(_t(c)).reshape(32, 2, 2)
        _eq(8 * f, jtr.chroma_dc_transform_ref(c.reshape(32, 2, 2), 4))


# ---------------------------------------------------------------------- #
# motion compensation


def _mc_inputs(seed, size, nref=None):
    rng = np.random.default_rng(seed)
    H, W = 48, 64
    shape = (H + 2 * EDGE, W + 2 * EDGE)
    if nref:
        shape = (nref,) + shape
    padded = rng.integers(0, 256, shape).astype(np.uint8)
    B = 40
    xs = (rng.integers(0, (W - size) // 4 + 1, B) * 4).astype(np.int32)
    ys = (rng.integers(0, (H - size) // 4 + 1, B) * 4).astype(np.int32)
    # half of the vectors point further than EDGE outside the frame,
    # where the JAX gather clamps its window start
    mvx = rng.integers(-40, 40, B).astype(np.int32)
    mvy = rng.integers(-40, 40, B).astype(np.int32)
    mvx[::2] = rng.integers(-400, 400, B // 2)
    mvy[1::2] = rng.integers(-400, 400, B // 2)
    ridx = rng.integers(-1, (nref or 1) + 1, B).astype(np.int32)
    return padded, xs, ys, mvx, mvy, ridx


class TestMC:
    @pytest.mark.parametrize("size", [16, 8, 4])
    def test_qpel(self, size):
        padded, xs, ys, mvx, mvy, _ = _mc_inputs(10 + size, size)
        got = tmc.qpel_mc(_t(padded), _t(xs), _t(ys), _t(mvx), _t(mvy), size)
        _eq(got, jmc.qpel_mc(jnp.asarray(padded), jnp.asarray(xs),
                             jnp.asarray(ys), jnp.asarray(mvx),
                             jnp.asarray(mvy), size))
        inside = (np.abs(mvx) < 4 * (EDGE - 4)) & (np.abs(mvy) < 4 * (EDGE - 4))
        _eq(got.numpy()[inside],
            jmc.qpel_mc_ref(padded, xs[inside], ys[inside], mvx[inside],
                            mvy[inside], size))

    @pytest.mark.parametrize("size", [8, 2])
    def test_chroma(self, size):
        padded, xs, ys, mvx, mvy, _ = _mc_inputs(20 + size, size)
        got = tmc.chroma_mc(_t(padded), _t(xs), _t(ys), _t(mvx), _t(mvy),
                            size)
        _eq(got, jmc.chroma_mc(jnp.asarray(padded), jnp.asarray(xs),
                               jnp.asarray(ys), jnp.asarray(mvx),
                               jnp.asarray(mvy), size))
        inside = (np.abs(mvx) < 8 * (EDGE - 4)) & (np.abs(mvy) < 8 * (EDGE - 4))
        _eq(got.numpy()[inside],
            jmc.chroma_mc_ref(padded, xs[inside], ys[inside], mvx[inside],
                              mvy[inside], size))

    def test_multi_reference(self):
        padded, xs, ys, mvx, mvy, ridx = _mc_inputs(30, 16, nref=3)
        args = (xs, ys, mvx, mvy)
        for tfn, jfn, size in ((tmc.qpel_mc, jmc.qpel_mc, 16),
                               (tmc.chroma_mc, jmc.chroma_mc, 8)):
            got = tfn(_t(padded), *map(_t, args), size, _t(ridx))
            _eq(got, jfn(jnp.asarray(padded), *map(jnp.asarray, args),
                         size, jnp.asarray(ridx)))


# ---------------------------------------------------------------------- #
# intra prediction


class TestIntraPred:
    def _common(self, seed, n, B=64):
        rng = np.random.default_rng(seed)
        top = rng.integers(0, 256, (B, n)).astype(np.int32)
        left = rng.integers(0, 256, (B, n)).astype(np.int32)
        tl = rng.integers(0, 256, B).astype(np.int32)
        at = rng.integers(0, 2, B).astype(bool)
        al = rng.integers(0, 2, B).astype(bool)
        return rng, top, left, tl, at, al

    def test_pred16x16(self):
        rng, top, left, tl, at, al = self._common(40, 16)
        mode = rng.integers(0, 4, len(tl)).astype(np.int8)
        args = (mode, top, left, tl, at, al)
        got = tpred.pred16x16(*map(_t, args))
        _eq(got, jpred.pred16x16(*map(jnp.asarray, args)))
        _eq(got, jpred.pred16x16_ref(*args))

    def test_pred8x8_chroma(self):
        rng, top, left, tl, at, al = self._common(41, 8)
        mode = rng.integers(0, 4, len(tl)).astype(np.int8)
        args = (mode, top, left, tl, at, al)
        got = tpred.pred8x8_chroma(*map(_t, args))
        _eq(got, jpred.pred8x8_chroma(*map(jnp.asarray, args)))
        _eq(got, jpred.pred8x8_chroma_ref(*args))

    def test_pred4x4(self):
        rng, t8, l4, tl, at, al = self._common(42, 8)
        l4 = l4[:, :4]
        mode = rng.integers(0, 9, len(tl)).astype(np.int8)
        args = (mode, t8, l4, tl, at, al)
        got = tpred.pred4x4(*map(_t, args))
        _eq(got, jpred.pred4x4(*map(jnp.asarray, args)))
        _eq(got, jpred.pred4x4_ref(*args))
        # out-of-range modes index the tables as jnp indexing does
        odd = rng.integers(-12, 20, len(tl)).astype(np.int32)
        args = (odd, t8, l4, tl, at, al)
        _eq(tpred.pred4x4(*map(_t, args)),
            jpred.pred4x4(*map(jnp.asarray, args)))

    def test_pred8x8_luma(self):
        rng, top, left, tl, at, al = self._common(43, 16)
        left = left[:, :8]
        mode = rng.integers(0, 9, len(tl)).astype(np.int8)
        atl = rng.integers(0, 2, len(tl)).astype(bool)
        atr = rng.integers(0, 2, len(tl)).astype(bool)
        args = (mode, top, left, tl, at, al, atl, atr)
        got = tpred.pred8x8_luma(*map(_t, args))
        _eq(got, jpred.pred8x8_luma(*map(jnp.asarray, args)))
        _eq(got, jpred.pred8x8_luma_ref(*args))


# ---------------------------------------------------------------------- #
# deblocking: K1's line contract and the frame deblock


class TestEdgeFilter:
    @pytest.mark.parametrize("chroma", [False, True])
    @pytest.mark.parametrize("offs", [(0, 0), (4, -2), (-6, 6)])
    def test_plain_vs_jax(self, chroma, offs):
        lines, qp, bs = edge_lines(50)
        got = tdb.filter_edge_qp(_t(lines), _t(qp), _t(bs), chroma, *offs)
        _eq(got, jdb.filter_edge_qp(jnp.asarray(lines), jnp.asarray(qp),
                                    jnp.asarray(bs), chroma, *offs))

    @pytest.mark.parametrize("offs", [(0, 0), (4, -2), (-6, 6)])
    def test_plain_vs_pallas_interpret(self, offs):
        lines, qp, bs = edge_lines(51, B=700)
        got = tdb.filter_edge_qp(_t(lines), _t(qp), _t(bs), False, *offs)
        _eq(got, jdb._filter_edge_qp_pallas(
            jnp.asarray(lines), jnp.asarray(qp), jnp.asarray(bs), *offs,
            interpret=True))

    @pytest.mark.parametrize("chroma", [False, True])
    def test_plain_vs_golden(self, chroma):
        lines, _, bs = edge_lines(52)
        for qp in (18, 30, 44, 51):
            got = tdb.filter_edge_qp(_t(lines), torch.full((len(bs),), qp),
                                     _t(bs), chroma)
            _eq(got, jdb.filter_edge_ref(lines, qp, bs, chroma))

    def test_wrapper_on_cpu_is_plain(self):
        lines, qp, bs = edge_lines(53, B=200)
        before = tdb.h264_edge_filter_lines.launches
        got = tdb.h264_edge_filter_lines(_t(lines), _t(qp), _t(bs), True,
                                         2, -1)
        _eq(got, tdb.filter_edge_qp(_t(lines), _t(qp), _t(bs), True, 2, -1))
        assert tdb.h264_edge_filter_lines.launches == before == 0


# frame sizes in MBs (mb_w, mb_h) and (part, any_t8, (a_off, b_off)) of
# the frame deblock's parity tests
FRAME_SIZES = [(1, 1), (1, 5), (5, 1), (7, 4), (4, 7)]
FRAME_CASES = [(False, False, (0, 0)), (True, True, (1, -1)),
               (False, True, (-6, 6))]


class TestDeblockFrame:
    @pytest.mark.parametrize("part,any_t8,a_off,b_off,cqpo", DEBLOCK_CASES)
    def test_vs_jax(self, part, any_t8, a_off, b_off, cqpo):
        mb_w, mb_h = 5, 4
        args, t8 = deblock_inputs(60, mb_w, mb_h, part)
        kw = {"t8": t8} if any_t8 else {}
        want = jdb.deblock_frame_exact_jit(
            mb_w, mb_h, a_off, b_off, part=part, cqpo=cqpo,
            any_t8=any_t8)(*map(jnp.asarray, args), **kw)
        got = tdb.deblock_frame_exact(
            mb_w, mb_h, a_off, b_off, part=part, cqpo=cqpo,
            any_t8=any_t8)(*map(_t, args), **{k: _t(v) for k, v in
                                              kw.items()})
        for g, w in zip(got, want):
            _eq(g, w)
        # the filter did act on this input
        assert not np.array_equal(got[0].numpy(), args[0])

    @pytest.mark.parametrize("part,any_t8", [(False, False), (False, True),
                                             (True, False), (True, True)])
    def test_field_vs_jax(self, part, any_t8):
        """Field pictures: vertical MV limit 2, horizontal MB edges never
        bS 4 (spec 8.7.2.1); the rules change this input's output."""
        mb_w, mb_h = 5, 4
        args, t8 = deblock_inputs(64 + 2 * part + any_t8, mb_w, mb_h, part)
        kw = {"t8": t8} if any_t8 else {}
        want = jdb.deblock_frame_exact_jit(
            mb_w, mb_h, 1, -1, part=part, any_t8=any_t8,
            field=True)(*map(jnp.asarray, args), **kw)
        tkw = {k: _t(v) for k, v in kw.items()}
        got = tdb.deblock_frame_exact(mb_w, mb_h, 1, -1, part=part,
                                      any_t8=any_t8, field=True)(
            *map(_t, args), **tkw)
        for g, w in zip(got, want):
            _eq(g, w)
        frame = tdb.deblock_frame_exact(mb_w, mb_h, 1, -1, part=part,
                                        any_t8=any_t8)(*map(_t, args),
                                                       **tkw)
        assert not torch.equal(got[0], frame[0])

    def test_vs_golden(self):
        mb_w, mb_h = 3, 3
        args, _ = deblock_inputs(61, mb_w, mb_h, False)
        got = tdb.deblock_frame_exact(mb_w, mb_h, 1, -1)(*map(_t, args))
        want = jdb.deblock_frame_exact_ref(*args, mb_w, mb_h, 1, -1)
        for g, w in zip(got, want):
            _eq(g, w)

    def test_wave_wrapper_on_cpu_is_plain(self):
        mb_w, mb_h = 5, 4
        args, _ = deblock_inputs(62, mb_w, mb_h, False)
        fn = tdb.deblock_frame_exact(mb_w, mb_h)
        kernels = (tdb.h264_deblock_frame, tdb.h264_deblock_wave)
        before = tuple(k.launches for k in kernels)
        got = fn(*map(_t, args))
        for run in (tdb.deblock_frame_waves, tdb.deblock_frame_plain):
            want = fn(*map(_t, args), run=run)
            for g, w in zip(got, want):
                _eq(g, w)
        assert tuple(k.launches for k in kernels) == before == (0, 0)

    @pytest.mark.parametrize("mb_w,mb_h", FRAME_SIZES)
    @pytest.mark.parametrize("part,any_t8,offs", FRAME_CASES)
    def test_frame_plain_vs_jax(self, mb_w, mb_h, part, any_t8, offs):
        """The frame kernel's plain version against the JAX frame deblock
        (the Pallas edge filter in interpret mode) and, where it applies
        (part=False, no 8x8 rule), the numpy golden."""
        args, t8 = deblock_inputs(63 + mb_w + 7 * mb_h, mb_w, mb_h, part)
        kw = {"t8": t8} if any_t8 else {}
        want = jdb.deblock_frame_exact_jit(
            mb_w, mb_h, *offs, part=part,
            any_t8=any_t8)(*map(jnp.asarray, args), **kw)
        got = tdb.deblock_frame_exact(mb_w, mb_h, *offs, part=part,
                                      any_t8=any_t8)(
            *map(_t, args), run=tdb.deblock_frame_plain,
            **{k: _t(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            _eq(g, w)
        if not part and not any_t8:
            ref = jdb.deblock_frame_exact_ref(*args, mb_w, mb_h, *offs)
            for g, r in zip(got, ref):
                _eq(g, r)


# ---------------------------------------------------------------------- #
# the whole frame program, the three variants the bench stream builds


def _recon_case(variant, seed=70, mb_w=5, mb_h=4):
    """(key flags, numpy args) for recon_h264_sparse[_jit]."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    bh, bw = 4 * mb_h, 4 * mb_w

    def coded(rows, frac):
        idx = np.flatnonzero(rng.random(rows) < frac).astype(np.int32)
        vals = np.where(rng.random((len(idx), 16)) < 0.4,
                        rng.integers(-40, 41, (len(idx), 16)), 0)
        return idx, vals.astype(np.int16)

    yidx, ysrc = coded(nmb * 16, 0.5)
    cidx, csrc = coded(nmb * 8, 0.4)
    ycap, ccap = jdev.sparse_caps(mb_w, mb_h, len(yidx), len(cidx))
    # padding rows keep garbage and all point at the dropped sentinel
    yvals = rng.integers(-999, 999, (ycap, 16)).astype(np.int16)
    yvals[:len(yidx)] = ysrc
    cvals = rng.integers(-999, 999, (ccap, 16)).astype(np.int16)
    cvals[:len(cidx)] = csrc
    ypad = np.full(ycap, nmb * 16, np.int32)
    ypad[:len(yidx)] = yidx
    cpad = np.full(ccap, nmb * 8, np.int32)
    cpad[:len(cidx)] = cidx

    def ref_planes():
        y = rng.integers(0, 256, (H + 2 * EDGE, W + 2 * EDGE))
        c = rng.integers(0, 256, (2, H // 2 + 2 * EDGE, W // 2 + 2 * EDGE))
        return y.astype(np.uint8), c[0].astype(np.uint8), \
            c[1].astype(np.uint8)

    def wtab(n):
        """(n refs, 3 planes, [w, o]) signed weights and offsets."""
        return np.stack([rng.integers(-128, 128, (n, 3)),
                         rng.integers(-128, 128, (n, 3))], -1) \
            .astype(np.int32)

    ry, ru, rv = ref_planes()
    t8 = rng.random(nmb) < 0.5
    args = dict(luma_mode=rng.integers(0, 4, nmb).astype(np.int8),
                chroma_mode=rng.integers(0, 4, nmb).astype(np.int8),
                mv=rng.integers(-300, 300, (nmb, 2)).astype(np.int16),
                qp=rng.integers(0, 52, nmb).astype(np.int8),
                luma_dc=rng.integers(-60, 61, (nmb, 16)).astype(np.int16),
                yvals=yvals, yidx=ypad, cvals=cvals, cidx=cpad,
                chroma_dc=rng.integers(-60, 61, (nmb, 2, 4))
                .astype(np.int16),
                ry=ry, ru=ru, rv=rv,
                nnz=np.where(rng.random((bh, bw)) < 0.4, 2, 0)
                .astype(np.int8))
    key = dict(ycap=ycap, ccap=ccap, crop=(0, 0, 0, 4, W, H - 8),
               deblock=True, db_offsets=(0, 0))
    if variant == "I":
        i4 = rng.random(nmb) < 0.7
        args.update(intra=np.ones(nmb, bool), i4=i4,
                    i4_modes=rng.integers(0, 9, (nmb, 16)).astype(np.int8),
                    t8=t8, row_top=np.array([False, True, False, True]))
        key.update(any_intra=True, any_i4=True, any_t8=True,
                   any_i8=bool(np.any(i4 & t8)))
    elif variant == "P":
        args.update(intra=np.zeros(nmb, bool), t8=t8)
        key.update(any_intra=False, any_t8=True, db_offsets=(2, -1))
    elif variant == "Pwmat":
        # scaling matrices and chroma qp offsets (High profile PPS/SPS)
        args.update(intra=np.zeros(nmb, bool), t8=t8)
        key.update(any_intra=False, any_t8=True, cqpo=(2, -3),
                   wmat=(tuple(tuple(int(v) for v in rng.integers(4, 40, 16))
                               for _ in range(6)),
                         tuple(tuple(int(v) for v in rng.integers(4, 40, 64))
                               for _ in range(2))))
    elif variant == "Pmulti":
        args.update(intra=np.zeros(nmb, bool),
                    ref_idx=rng.integers(0, 2, nmb).astype(np.int8))
        args["ry"], args["ru"], args["rv"] = zip(ref_planes(),
                                                 (ry, ru, rv))
        key.update(any_intra=False, nrefs=2, deblock=False)
    elif variant in ("B", "Bwexp", "Bwimp"):
        nr = 1 if variant == "B" else 2
        ry1, ru1, rv1 = ref_planes()
        args.update(intra=np.zeros(nmb, bool),
                    bmv0=rng.integers(-300, 300, (bh, bw, 2))
                    .astype(np.int16),
                    bref0=rng.integers(0, nr, (bh, bw)).astype(np.int8),
                    bsel=rng.integers(0, 3, (bh, bw)).astype(np.int8),
                    bmv1=rng.integers(-300, 300, (bh, bw, 2))
                    .astype(np.int16),
                    bref1=rng.integers(0, nr, (bh, bw)).astype(np.int8),
                    pid0=rng.integers(-1, 2, (bh, bw)).astype(np.int8),
                    pid1=rng.integers(-1, 2, (bh, bw)).astype(np.int8),
                    ry1=ry1, ru1=ru1, rv1=rv1)
        key.update(any_intra=False, bpred=True, part=True)
        if nr > 1:
            args["ry"], args["ru"], args["rv"] = zip(ref_planes(),
                                                     (ry, ru, rv))
            args["ry1"], args["ru1"], args["rv1"] = zip((ry1, ru1, rv1),
                                                        ref_planes())
            key.update(nrefs=2, nrefs1=2)
        if variant == "Bwexp":
            # explicit weighted bi-prediction, signed weights and offsets
            args.update(wtab0=wtab(2), wtab1=wtab(2))
            key.update(weighted=("e", 5, 3))
        elif variant == "Bwimp":
            # implicit weights: w0 = 64 - DistScaleFactor >> 2 lies in
            # [-64, 128] (spec 8.4.2.3.2)
            args["w0tab"] = rng.integers(-64, 129, (2, 2)).astype(np.int32)
            key.update(weighted="i")
    elif variant.startswith("Pwexp"):
        # explicit weighted P (block-granular, as the host forces it),
        # two references, signed weights and offsets; the logWDs of
        # luma and chroma are in the variant's name
        dy, dc = int(variant[5]), int(variant[6])
        args.update(intra=np.zeros(nmb, bool),
                    bmv0=rng.integers(-300, 300, (bh, bw, 2))
                    .astype(np.int16),
                    bref0=rng.integers(0, 2, (bh, bw)).astype(np.int8),
                    bsel=np.zeros((bh, bw), np.int8),
                    bmv1=np.zeros((bh, bw, 2), np.int16),
                    pid0=rng.integers(0, 2, (bh, bw)).astype(np.int8),
                    pid1=np.full((bh, bw), -1, np.int8),
                    wtab0=wtab(2))
        args["ry"], args["ru"], args["rv"] = zip(ref_planes(),
                                                 (ry, ru, rv))
        key.update(any_intra=False, part=True, nrefs=2,
                   weighted=("e", dy, dc))
    elif variant == "Ipcm":
        # I_PCM MBs among I_16x16/I_4x4/I_8x8 ones, inside the wavefront
        i4 = rng.random(nmb) < 0.5
        args.update(intra=np.ones(nmb, bool), i4=i4,
                    i4_modes=rng.integers(0, 9, (nmb, 16)).astype(np.int8),
                    t8=t8, row_top=np.array([False, True, True, True]),
                    ipcm=rng.random(nmb) < 0.3,
                    ipcm_y=rng.integers(0, 256, (nmb, 16, 16))
                    .astype(np.uint8),
                    ipcm_u=rng.integers(0, 256, (nmb, 8, 8))
                    .astype(np.uint8),
                    ipcm_v=rng.integers(0, 256, (nmb, 8, 8))
                    .astype(np.uint8))
        key.update(any_intra=True, any_i4=True, any_t8=True,
                   any_i8=bool(np.any(i4 & t8)), any_ipcm=True)
    elif variant == "Pcdy":
        # PAFF cross-parity chroma offset on the 16x16 path: per-MB cdy
        # from the reference's parity, two references, some intra MBs
        args.update(intra=rng.random(nmb) < 0.2,
                    ref_idx=rng.integers(0, 2, nmb).astype(np.int8),
                    cdy=rng.choice([-2, 0, 2], nmb).astype(np.int32))
        args["ry"], args["ru"], args["rv"] = zip(ref_planes(),
                                                 (ry, ru, rv))
        key.update(any_intra=True, nrefs=2, any_cdy=True, field=True,
                   db_offsets=(-2, 3))
    elif variant in ("Ifield", "Pfield"):
        # a field picture with deblock: vertical MV limit 2 and no bS 4
        # on horizontal MB edges; small MVs so the limit decides bS
        intra = (np.ones(nmb, bool) if variant == "Ifield"
                 else rng.random(nmb) < 0.3)
        args.update(intra=intra,
                    mv=rng.integers(-6, 7, (nmb, 2)).astype(np.int16),
                    t8=t8)
        key.update(any_intra=True, any_t8=True, field=True)
    return key, args


# the variants of the formerly refused features: explicit weighted P at
# three (luma, chroma) logWD pairs, explicit and implicit weighted B,
# I_PCM, the PAFF cross-parity chroma offset, field pictures
EXT_VARIANTS = ["Pwexp53", "Pwexp07", "Pwexp70", "Bwexp", "Bwimp", "Ipcm",
                "Pcdy", "Ifield", "Pfield"]
DENSE_KEYS = ("any_intra", "nrefs", "any_i4", "bpred", "part", "nrefs1",
              "weighted", "wmat", "cqpo", "any_t8", "any_i8", "any_ipcm",
              "any_cdy")


def _dense_case(variant, mb_w=5, mb_h=4):
    """_recon_case's inputs for the dense program recon_h264[_jit]: the
    coefficients scattered on the host, the deblock's inputs dropped."""
    key, args = _recon_case(variant, mb_w=mb_w, mb_h=mb_h)
    nmb = mb_w * mb_h
    luma_ac = np.zeros((nmb * 16 + 1, 16), np.int16)
    luma_ac[args.pop("yidx")] = args.pop("yvals")
    chroma_ac = np.zeros((nmb * 8 + 1, 16), np.int16)
    chroma_ac[args.pop("cidx")] = args.pop("cvals")
    args.update(luma_ac=luma_ac[:nmb * 16].reshape(nmb, 16, 16),
                chroma_ac=chroma_ac[:nmb * 8].reshape(nmb, 8, 16))
    for k in ("nnz", "pid0", "pid1"):
        args.pop(k, None)
    return {k: v for k, v in key.items() if k in DENSE_KEYS}, args


class TestRecon:
    @pytest.mark.parametrize("variant", ["I", "P", "B", "Pmulti", "Pwmat"]
                             + EXT_VARIANTS)
    def test_sparse_vs_jax(self, variant):
        mb_w, mb_h = 5, 4
        key, args = _recon_case(variant)
        want_planes, want_padded = jdev.recon_h264_sparse_jit(
            mb_w, mb_h, **key)(**args)
        got_planes, got_padded = tdev.recon_h264_sparse(
            mb_w, mb_h, **key, device=CPU)(
                **state_from_numpy(args, CPU))
        for g, w in zip(got_planes + got_padded, want_planes + want_padded):
            assert g.dtype == torch.uint8
            _eq(g, w)

    @pytest.mark.parametrize("variant", EXT_VARIANTS)
    def test_dense_vs_jax(self, variant):
        mb_w, mb_h = 5, 4
        key, args = _dense_case(variant)
        want = jdev.recon_h264_jit(mb_w, mb_h, **key)(**args)
        got = tdev.recon_h264(mb_w, mb_h, **key, device=CPU)(
            **state_from_numpy(args, CPU))
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            _eq(g, w)

    @pytest.mark.parametrize("variant", ["I", "Ipcm"])
    def test_dense_one_mb_wide_vs_jax(self, variant):
        """A 1-MB-wide picture with I_4x4/I_8x8: the x+2y order leaves
        every other wave empty, which the wave loop skips."""
        mb_w, mb_h = 1, 4
        key, args = _dense_case(variant, mb_w=mb_w, mb_h=mb_h)
        assert key["any_i4"]
        want = jdev.recon_h264_jit(mb_w, mb_h, **key)(**args)
        got = tdev.recon_h264(mb_w, mb_h, **key, device=CPU)(
            **state_from_numpy(args, CPU))
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            _eq(g, w)

    def test_unported_flags_raise(self):
        """The flags the port refused before (weighted prediction, I_PCM,
        the cross-parity chroma offset, field pictures) build programs
        that act: each changes the picture against the same inputs
        without it, and equals the JAX program with it."""
        mb_w, mb_h = 5, 4
        for variant, drop in (("Pwexp53", {"weighted": None}),
                              ("Bwimp", {"weighted": None}),
                              ("Ipcm", {"any_ipcm": False}),
                              ("Pcdy", {"any_cdy": False}),
                              ("Pfield", {"field": False})):
            key, args = _recon_case(variant)
            t = state_from_numpy(args, CPU)
            got = tdev.recon_h264_sparse(mb_w, mb_h, **key, device=CPU)(**t)
            base = tdev.recon_h264_sparse(mb_w, mb_h, **{**key, **drop},
                                          device=CPU)(**t)
            assert any(not torch.equal(g, b) for g, b in zip(got[0],
                                                             base[0]))
            want = jdev.recon_h264_sparse_jit(mb_w, mb_h, **key)(**args)
            for g, w in zip(got[0], want[0]):
                _eq(g, w)

    def test_zero_refs(self):
        want = jdev.zero_refs_h264(3, 2)
        got = tdev.zero_refs_h264(3, 2, device=CPU)
        for g, w in zip(got, want):
            _eq(g, w)
