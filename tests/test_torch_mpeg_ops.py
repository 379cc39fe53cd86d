"""The PyTorch port's MPEG-1/2 device modules held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU, where `idct8x8_int` takes its einsum path, which the JAX package
holds bit-identical to its Pallas kernel) and its port counterpart on the
CPU. The codec is integer-exact, so the tolerance is exact equality: any
difference is a bug. Kernel K2 is held against `idct8x8_int_plain` in
test_torch_kernels.py, on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs import mpegvideo as jmv
from libav_tpu.ops import idct as jidct
from libav_tpu.ops import mc as jmc
from libav_tpu.ops import quant as jq
from libav_tpu.ops.mc import EDGE
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.codecs import mpegvideo as tmv
from libav_tpu_torch.ops import idct as tidct
from libav_tpu_torch.ops import mc as tmc
from libav_tpu_torch.ops import quant as tq

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
        assert got.dtype == torch.uint8
        _eq(got, want)


# ---------------------------------------------------------------------- #
# K2 and its plain version


class TestIdct:
    def test_plain_matches_jax_and_golden(self):
        x = testdata.idct_blocks(20, 500)
        got = tidct.idct8x8_int_plain(_t(x))
        assert got.dtype == torch.int32
        _eq(got, jidct.idct8x8_int(jnp.asarray(x)))
        _eq(got, jidct.idct8x8_int_ref(x))

    def test_inputs_reach_every_class(self):
        """The input classes do hit the DC shortcut, the int16 wrap and
        int32 overflow of the row sums."""
        x = testdata.idct_blocks(21, 500).astype(np.int64)
        w = jidct._wrap16_np(x)
        rows = np.einsum("bij,kj->bik", w, jidct.simple_idct_matrix())
        assert (np.abs(rows + 1024) >= 2 ** 31).any()
        assert (w != x).any()
        dc_only = (w[..., 1:] == 0).all(-1) & (w[..., 0] != 0)
        assert dc_only.sum() > 100
        assert (np.abs(w).reshape(len(w), -1).max(1) == 0).sum() >= 100

    def test_wrapper_takes_the_plain_version_on_the_cpu(self):
        x = testdata.idct_blocks(22, 50)
        before = tidct.idct8x8_int.launches
        _eq(tidct.idct8x8_int(_t(x)), jidct.idct8x8_int_ref(x))
        assert tidct.idct8x8_int.launches == before

    def test_idct_put_and_add(self):
        rng = np.random.default_rng(23)
        x = np.where(rng.random((64, 8, 8)) < 0.3,
                     rng.integers(-600, 600, (64, 8, 8)), 0).astype(np.int32)
        x[:, 0, 0] = rng.integers(-200, 1400, 64)
        pred = rng.integers(0, 256, (64, 8, 8)).astype(np.uint8)
        for bias in (0, 128):
            got = tidct.idct_put(_t(x), bias)
            assert got.dtype == torch.uint8
            _eq(got, jidct.idct_put(jnp.asarray(x), bias))
        got = tidct.idct_add(_t(x), _t(pred))
        assert got.dtype == torch.uint8
        _eq(got, jidct.idct_add(jnp.asarray(x), jnp.asarray(pred)))


# ---------------------------------------------------------------------- #
# dequantisation


def _levels(seed, B=300):
    rng = np.random.default_rng(seed)
    c = np.where(rng.random((B, 64)) < 0.4,
                 rng.integers(-2047, 2048, (B, 64)), 0)
    c[:5] = rng.choice([-32768, 32767, -1, 1], (5, 64))
    return (c.astype(np.int16), rng.integers(1, 113, B).astype(np.int32),
            rng.integers(1, 256, 64).astype(np.int32))


@pytest.mark.parametrize("name", ["mpeg1_dequant_intra",
                                  "mpeg1_dequant_inter",
                                  "mpeg2_dequant_intra",
                                  "mpeg2_dequant_inter"])
def test_dequant(name):
    c, q, m = _levels(30)
    got = getattr(tq, name)(_t(c), _t(q), _t(m))
    assert got.dtype == torch.int32
    _eq(got, getattr(jq, name)(jnp.asarray(c), jnp.asarray(q),
                               jnp.asarray(m)))
    if name.startswith("mpeg1"):
        _eq(got, getattr(jq, name + "_ref")(c, q, m))


def test_mismatch_control():
    rng = np.random.default_rng(31)
    b = rng.integers(-300, 300, (400, 8, 8)).astype(np.int32)
    b[:100, 7, 7] = 0
    got = tq.mpeg2_mismatch_control(_t(b))
    _eq(got, jq.mpeg2_mismatch_control(jnp.asarray(b)))
    # every block ends with an odd sum
    assert (got.reshape(400, 64).sum(1) % 2 == 1).all()


# ---------------------------------------------------------------------- #
# half-pel motion compensation


def _mc_inputs(seed, size, B=200, H=48, W=64):
    rng = np.random.default_rng(seed)
    padded = rng.integers(0, 256, (H + 2 * EDGE, W + 2 * EDGE)) \
        .astype(np.uint8)
    xs = (rng.integers(0, W // size, B) * size).astype(np.int32)
    ys = (rng.integers(0, H // size, B) * size).astype(np.int32)
    mv = rng.integers(-20, 21, (B, 2))
    # a quarter of the vectors point past the margin, some far enough
    # that lax.dynamic_slice's negative start wraps
    far = rng.random(B) < 0.25
    mv[far] = rng.integers(-300, 300, (int(far.sum()), 2))
    return padded, xs, ys, mv.astype(np.int32)


@pytest.mark.parametrize("size,rnd", [(16, 1), (8, 1), (16, 0)])
def test_mc_hpel(size, rnd):
    padded, xs, ys, mv = _mc_inputs(40 + size, size)
    # all four half-pel phases are present
    assert len({(a & 1, b & 1) for a, b in mv}) == 4
    got = tmc.mc_hpel(_t(padded), _t(xs), _t(ys), _t(mv[:, 0]),
                      _t(mv[:, 1]), size, rnd)
    want = jmc.mc_hpel(jnp.asarray(padded), jnp.asarray(xs),
                       jnp.asarray(ys), jnp.asarray(mv[:, 0]),
                       jnp.asarray(mv[:, 1]), size, rnd)
    _eq(got, want)
    near = np.abs(mv).max(1) <= 2 * EDGE - 2 * size
    _eq(got[near], jmc.mc_hpel_ref(padded, xs[near], ys[near], mv[near, 0],
                                   mv[near, 1], size, rnd))


def test_mc_hpel_from_a_stack_picks_per_block():
    p0, xs, ys, mv = _mc_inputs(50, 16)
    p1 = np.random.default_rng(51).integers(0, 256, p0.shape) \
        .astype(np.uint8)
    sel = np.random.default_rng(52).integers(0, 2, len(xs))
    got = tmc.mc_hpel(_t(np.stack([p0, p1])), _t(xs), _t(ys),
                      _t(mv[:, 0]), _t(mv[:, 1]), 16, 1, _t(sel))
    one = [jmc.mc_hpel(jnp.asarray(p), jnp.asarray(xs), jnp.asarray(ys),
                       jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]), 16, 1)
           for p in (p0, p1)]
    _eq(got, np.where(sel[:, None, None] == 0, one[0], one[1]))


def test_chroma_mv_div2_and_avg():
    mv = np.arange(-41, 42, dtype=np.int32).reshape(-1, 1).repeat(2, 1)
    got = tmc.chroma_mv_div2(_t(mv))
    _eq(got, jmc.chroma_mv_div2(jnp.asarray(mv)))
    _eq(got, jmc.chroma_mv_div2_ref(mv))
    a, b = np.arange(0, 256, dtype=np.int32), np.arange(255, -1, -1,
                                                         dtype=np.int32)
    _eq(tmc.avg_pred(_t(a), _t(b)), jmc.avg_pred(a, b))


# ---------------------------------------------------------------------- #
# whole-picture programs


RECON_CASES = [
    # (mb_w, mb_h, quant_kind, alt_scan, inter, rounding, interlaced, dual)
    (4, 2, "mpeg1", False, False, 0, False, False),      # I
    (5, 3, "mpeg1", False, True, 0, False, False),       # P / B
    (6, 4, "mpeg2", True, False, 0, False, False),       # I, alternate scan
    (8, 6, "mpeg2", False, True, 0, False, False),       # P / B
    (4, 4, "mpeg2", False, True, 1, True, False),        # field MC + DCT
    (6, 4, "mpeg2", True, True, 0, True, True),          # + dual prime
    (4, 2, "mpeg2", False, False, 0, True, False),       # I, field DCT
]


@pytest.mark.parametrize(
    "mb_w,mb_h,quant_kind,alt_scan,inter,rounding,interlaced,dual",
    RECON_CASES)
def test_recon(mb_w, mb_h, quant_kind, alt_scan, inter, rounding,
               interlaced, dual):
    args, kw = testdata.recon_inputs(60 + mb_w * mb_h, mb_w, mb_h, inter,
                                     interlaced, dual)
    want = jmv.recon_jit(mb_w, mb_h, quant_kind, alt_scan, inter, rounding,
                         interlaced=interlaced, dual=dual)(*args, **kw)
    prog = tmv.recon(mb_w, mb_h, quant_kind, alt_scan, inter, rounding,
                     interlaced=interlaced, dual=dual, device=CPU)
    got = prog(*state_from_numpy(args, CPU), **state_from_numpy(kw, CPU))
    _eq_tree(got, want)


@pytest.mark.parametrize("mb_w,mb_h_f,alt_scan,inter,dual", [
    (4, 2, False, False, False),
    (5, 3, True, True, False),
    (6, 3, False, True, True),
])
def test_recon_field(mb_w, mb_h_f, alt_scan, inter, dual):
    args, kw = testdata.recon_field_inputs(70 + mb_w * mb_h_f, mb_w, mb_h_f,
                                           inter, dual)
    want = jmv.recon_field_jit(mb_w, mb_h_f, alt_scan, inter, dual)(*args,
                                                                     **kw)
    got = tmv.recon_field(mb_w, mb_h_f, alt_scan, inter, dual, device=CPU)(
        *state_from_numpy(args, CPU), **state_from_numpy(kw, CPU))
    _eq_tree(got, want)


def test_fields_of_frame_and_weave():
    rng = np.random.default_rng(80)
    mb_w, mb_h = 5, 4
    frame = testdata.padded_planes(rng, 16 * mb_h, 16 * mb_w)
    want = jmv.fields_of_frame_jit(mb_w, mb_h)(*frame)
    got = tmv.fields_of_frame(mb_w, mb_h, device=CPU)(
        *state_from_numpy(frame, CPU))
    _eq_tree(got, want)
    top, bot = ([p[EDGE:-EDGE, EDGE:-EDGE]
                 for p in testdata.padded_planes(rng, 8 * mb_h, 16 * mb_w)]
                for _ in range(2))
    want = jmv.weave_fields_jit(mb_w, mb_h)(*top, *bot)
    got = tmv.weave_fields(mb_w, mb_h, device=CPU)(
        *state_from_numpy(top + bot, CPU))
    _eq_tree(got, want)


def test_zero_pad_refs():
    got = tmv.zero_pad_refs(3, 2, device=CPU)
    _eq_tree(got, jmv.zero_pad_refs(3, 2))


@pytest.mark.parametrize("flags", [dict(quant_kind="h263sh"),
                                   dict(qpel=True), dict(any_4mv=True),
                                   dict(quant_kind="wmv1"),
                                   dict(quant_kind="mpeg4"),
                                   dict(quant_kind="mpeg4mq")])
def test_mpeg4_family_is_refused(flags):
    """The H.263/MPEG-4 quantisers but 'h263' (ported with the MPEG-4
    encoder, tests/test_torch_mpeg4_encode.py), qpel and 4MV."""
    key = dict(quant_kind="mpeg2", alt_scan=False, inter_frame=True)
    key.update(flags)
    with pytest.raises(NotImplementedError, match="step 8b"):
        tmv.recon(4, 2, device=CPU, **key)
