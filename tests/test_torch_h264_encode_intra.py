"""The PyTorch port's H.264 encoder: its transforms and intra programs
held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU) and its counterpart in the port on the CPU: the forward 4x4
transform and quantiser with their numpy twins, the float32 8x8 forward
transform against XLA's (tools/check_fdct8_order.py at a small batch),
and the I_16x16, I_4x4 and I_8x8 wavefront programs (EncodeI16, EncodeI4,
EncodeI8) against _encode_i_jit, _encode_i4_jit and _encode_i8_jit, with
and without slice rows. The integer programs are exact and so is the
float32 transform's order, so the tolerance is exact equality: levels,
modes and the reconstruction `np.array_equal`.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs.h264 import enc as jenc
from libav_tpu.ops import h264transform as jtr
from libav_tpu_torch.codecs.h264 import encdev
from libav_tpu_torch.ops import h264transform as ttr

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import check_fdct8_order  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------- #
# transforms and quantisers


def test_fdct4x4_and_quant():
    rng = np.random.default_rng(1)
    x = rng.integers(-255, 256, (200, 4, 4)).astype(np.int32)
    w = ttr.fdct4x4(_t(x))
    _eq(w, jtr.fdct4x4(jnp.asarray(x)))
    _eq(w, jtr.fdct4x4_ref(x))
    _eq(w, ttr.fdct4x4_ref(x))
    for qp in (0, 17, 28, 51):
        for intra in (True, False):
            lv = ttr.quant4x4(w, qp, intra)
            _eq(lv, jtr.quant4x4(jnp.asarray(w.numpy()), qp, intra))
            _eq(lv, ttr.quant4x4_ref(w.numpy(), qp, intra))
            _eq(ttr.dequant4x4(lv, qp),
                jtr.dequant4x4_ref(lv.numpy(), qp))
            _eq(ttr.dequant4x4(lv, qp), ttr.dequant4x4_ref(lv.numpy(), qp))


def test_tables_equal_jax():
    for qp in range(52):
        _eq(ttr.quant_mf(qp), jtr.quant_mf(qp))
        _eq(ttr.dequant_scale(qp), jtr.dequant_scale(qp))
        _eq(ttr.dequant8x8_tab(qp), jtr.dequant8x8_tab(qp))
    _eq(ttr._V, jtr._V)
    np.testing.assert_array_equal(ttr._idct8_matrix(), jtr._idct8_matrix())
    np.testing.assert_array_equal(ttr._fdct8_matrix(), jtr._fdct8_matrix())
    x = np.random.default_rng(2).integers(-255, 256, (5, 8, 8))
    np.testing.assert_array_equal(ttr.fdct8x8_h264_ref(x),
                                  jtr.fdct8x8_h264_ref(x))


def test_fdct8_order_matches_xla():
    """The written-out float32 order gives XLA's coefficients and levels
    bit for bit, for both einsum forms, at a few qps on random and
    near-tie residuals (the tool's full run: 2^20 blocks at qp 0-51)."""
    lines = []
    assert check_fdct8_order.check(4096, [0, 11, 28, 37, 51],
                                   out=lines.append) == 0
    assert len(lines) == 10 and all(" 0 float32 c8 and 0 levels" in s
                                    for s in lines)


def test_fdct8_order_matters():
    """A plain float32 einsum sums in another order and flips levels on
    the near-tie residuals: the written-out order is what makes them
    equal."""
    x = check_fdct8_order.residuals(4096, 28, 7)
    _, want = check_fdct8_order.xla("bij", x, 28)
    F8 = torch.as_tensor(ttr._fdct8_matrix().astype(np.float32))
    c8 = torch.einsum("ki,bij,lj->bkl", F8, _t(x), F8)
    plain = torch.round(c8 / _t(ttr.step8(28))).to(torch.int32).numpy()
    assert np.count_nonzero(plain != want) > 0
    _eq(ttr.fdct8x8_h264_xla(_t(x), 28), want)


# ---------------------------------------------------------------------- #
# the intra wavefront programs


def _planes(seed, mb_w, mb_h):
    """Source planes: a smooth gradient, edges and noise, so that every
    intra mode wins somewhere."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    yy, xx = np.mgrid[0:H, 0:W]
    y = (xx * 3 + yy * 2 + 40 * (((xx // 7) + (yy // 5)) % 2)
         + rng.integers(0, 24, (H, W))) % 256
    yy, xx = np.mgrid[0:H // 2, 0:W // 2]
    u = (128 + 60 * np.sin(xx / 3.0) + rng.integers(0, 9, xx.shape))
    v = (100 + 2 * yy + rng.integers(0, 30, xx.shape)) % 256
    return [a.astype(np.uint8) for a in (y, u, v)]


def _unwave(outs, waves):
    """The JAX program's wave-layout outputs scattered to MB order."""
    wave_idx, wave_mask = waves
    flat, mask = wave_idx.reshape(-1), wave_mask.reshape(-1)
    res = []
    for o in outs:
        o = np.asarray(o)
        o = o.reshape(-1, *o.shape[2:])
        out = np.zeros((int(flat.max()) + 1, *o.shape[1:]), o.dtype)
        out[flat[mask]] = o[mask]
        res.append(out)
    return res


INTRA = {"i16": (jenc._encode_i_jit, encdev.encode_i16),
         "i4": (jenc._encode_i4_jit, encdev.encode_i4),
         "i8": (jenc._encode_i8_jit, encdev.encode_i8)}


@pytest.mark.parametrize("kind,mb_w,mb_h,qp,rows", [
    ("i16", 4, 3, 28, None), ("i16", 7, 4, 12, (0, 2)),
    ("i4", 5, 3, 28, None), ("i4", 6, 4, 36, (0, 2)),
    ("i8", 4, 3, 28, None), ("i8", 8, 4, 20, (0, 1, 3))])
def test_intra_program_matches_jax(kind, mb_w, mb_h, qp, rows):
    src = _planes(10 + mb_w + qp, mb_w, mb_h)
    row_top = None
    if rows is not None:
        row_top = np.ones(mb_h, bool)
        row_top[list(rows)] = False
    jit, factory = INTRA[kind]
    fn, waves = jit(mb_w, mb_h, qp)
    want_outs, want_recon = fn(*(jnp.asarray(p) for p in src),
                               row_top=row_top)
    got_outs, got_recon = factory(mb_w, mb_h, qp, device=CPU)(
        *(_t(p) for p in src),
        row_top=None if row_top is None else _t(row_top))
    for g, w in zip(got_outs, _unwave(want_outs, waves)):
        _eq(g, w)
    for g, w in zip(got_recon, want_recon):
        assert g.dtype == torch.uint8
        _eq(g, w)
    if kind != "i16":
        # the mode decision is exercised: several modes win
        assert len(np.unique(got_outs[0].numpy())) >= 4


def test_first_min_keeps_the_first_tie():
    costs = [torch.tensor([5, 3, 7, 2]), torch.tensor([5, 1, 7, 2]),
             torch.tensor([4, 1, 7, 9])]
    pick, best = encdev.first_min(costs)
    _eq(pick, np.argmin(np.stack([c.numpy() for c in costs]), axis=0))
    _eq(best, [4, 1, 7, 2])
