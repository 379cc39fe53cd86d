"""The PyTorch port's H.264 encoder: its P and B programs and the closed
loop's reconstruction held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU; the deblock's Pallas edge filter in interpret mode) and its
counterpart in the port on the CPU (the frame deblock through its plain
version, as K1 takes CPU tensors): the full-pel search the encoder calls,
EncodeP (one reference, the PAFF chroma offset, two references, the 8x8
transform's levels) against _encode_p_jit, EncodeB against _encode_b_jit,
and recon_h264_deblock (I_4x4/I_8x8, P with the 8x8 transform, field
pictures, the chroma offset) against recon_h264_deblock_jit. All integer
or in XLA's float32 order, so the tolerance is exact equality.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libav_tpu.codecs.h264 import device as jdev
from libav_tpu.codecs.h264 import enc as jenc
from libav_tpu.ops import me as jme
from libav_tpu.ops.mc import EDGE
from libav_tpu_torch.avutil.hwdevice import state_from_numpy
from libav_tpu_torch.codecs.h264 import device as tdev
from libav_tpu_torch.codecs.h264 import encdev
from libav_tpu_torch.ops import h264deblock as tdb
from libav_tpu_torch.ops import me as tme

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


def _scene(seed, mb_w, mb_h, shifts):
    """A smooth texture seen through several (fractional) shifts: the
    current picture (first shift) and edge-padded references (the
    others), so that the search finds real vectors, sub-pel ones and
    some reaching past the picture."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for k, (dx, dy) in enumerate(shifts):
        x, y_ = xx + dx, yy + dy
        y = (128 + 0.6 * x + 0.4 * y_ + 50 * np.sin(x / 5.0)
             * np.cos(y_ / 4.0) + rng.integers(0, 3, xx.shape))
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = ((y[::2, ::2].astype(np.int32) + 40 + k) % 256).astype(np.uint8)
        v = ((255 - y[1::2, 1::2].astype(np.int32) + k) % 256) \
            .astype(np.uint8)
        out.append((y, u, v) if k == 0 else
                   tuple(np.pad(p, EDGE, mode="edge") for p in (y, u, v)))
    return out


@pytest.mark.parametrize("mb_w,mb_h,shift,search_range", [
    (4, 3, (-5, 3), 12), (6, 4, (9, -13), 12), (5, 3, (2, 2), 15)])
def test_search_is_the_encoders(mb_w, mb_h, shift, search_range):
    """The encoder calls ops/me.py's search, the port of _search_jit: no
    second search."""
    (cur, _, _), (ry, _, _) = _scene(3 + mb_w, mb_w, mb_h, [(0, 0), shift])
    cur_mbs = (cur.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)
               .reshape(-1, 16, 16).astype(np.int32))
    want = jme._search_jit(mb_w, mb_h, search_range)(jnp.asarray(cur_mbs),
                                                     jnp.asarray(ry))
    got = tme.search(mb_w, mb_h, search_range, device=CPU)(_t(cur_mbs),
                                                           _t(ry))
    for g, w in zip(got, want):
        _eq(g, w)
    assert np.any(np.asarray(want[0]) != 0)


@pytest.mark.parametrize("mb_w,mb_h,qp,cdy,nrefs,dct8", [
    (4, 3, 28, 0, 1, False), (5, 4, 22, 2, 1, False),
    (4, 3, 30, 0, 2, False), (6, 3, 28, 0, 1, True),
    (5, 4, 40, 0, 2, True)])
def test_p_program_matches_jax(mb_w, mb_h, qp, cdy, nrefs, dct8):
    shifts = [(0, 0), (3.25, -2.5), (-7.5, 5.75)][:nrefs + 1]
    src, *refs = _scene(40 + qp, mb_w, mb_h, shifts)
    if nrefs == 1:
        ref = refs[0]
    else:
        ref = tuple(np.stack([r[k] for r in refs]) for k in range(3))
    want = jenc._encode_p_jit(mb_w, mb_h, qp, cdy=cdy, nrefs=nrefs,
                              dct8=dct8)(*(jnp.asarray(p) for p in src),
                                         *(jnp.asarray(p) for p in ref))
    got = encdev.encode_p(mb_w, mb_h, qp, cdy=cdy, nrefs=nrefs, dct8=dct8,
                          device=CPU)(*(_t(p) for p in src),
                                      *(_t(p) for p in ref))
    assert len(got) == len(want) == (8 if dct8 else 7)
    for g, w in zip(got, want):
        _eq(g, w)
    assert np.any(np.asarray(want[0]) % 4 != 0)      # sub-pel vectors
    if nrefs > 1:
        assert len(np.unique(np.asarray(want[6]))) == 2


@pytest.mark.parametrize("mb_w,mb_h,qp", [(4, 3, 28), (6, 4, 24)])
def test_b_program_matches_jax(mb_w, mb_h, qp):
    src, r0, r1 = _scene(70 + qp, mb_w, mb_h, [(0, 0), (4.5, 3.25),
                                               (-4.25, -3.5)])
    want = jenc._encode_b_jit(mb_w, mb_h, qp)(
        *(jnp.asarray(p) for p in src + r0 + r1))
    got = encdev.encode_b(mb_w, mb_h, qp, device=CPU)(
        *(_t(p) for p in src + r0 + r1))
    for g, w in zip(got, want):
        _eq(g, w)


def _recon_inputs(seed, mb_w, mb_h, kind):
    """The encoder's closed-loop inputs to recon_h264_deblock[_jit]: (key,
    numpy args) for an I_4x4/I_8x8 picture or a P picture with some 8x8
    transform MBs."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w

    def sparse(shape, frac, lim):
        return np.where(rng.random(shape) < frac,
                        rng.integers(-lim, lim + 1, shape), 0) \
            .astype(np.int16)
    ry = rng.integers(0, 256, (H + 2 * EDGE, W + 2 * EDGE)).astype(np.uint8)
    ru, rv = (rng.integers(0, 256, (H // 2 + 2 * EDGE, W // 2 + 2 * EDGE))
              .astype(np.uint8) for _ in range(2))
    args = dict(luma_mode=np.full(nmb, 2, np.int8),
                chroma_mode=np.zeros(nmb, np.int8),
                mv=rng.integers(-12, 13, (nmb, 2)).astype(np.int32),
                qp=np.full(nmb, 28, np.int32),
                luma_dc=sparse((nmb, 16), 0.3, 20),
                luma_ac=sparse((nmb, 16, 16), 0.15, 12),
                chroma_dc=sparse((nmb, 2, 4), 0.3, 20),
                chroma_ac=sparse((nmb, 8, 16), 0.1, 8),
                nnz=(rng.random((4 * mb_h, 4 * mb_w)) < 0.4).astype(np.int8),
                ry=ry, ru=ru, rv=rv)
    t8 = rng.random(nmb) < 0.5
    if kind == "I":
        args.update(intra=np.ones(nmb, bool), i4=np.ones(nmb, bool),
                    i4_modes=rng.integers(0, 9, (nmb, 16)).astype(np.int8),
                    t8=t8)
        key = dict(any_intra=True, any_i4=True, any_t8=True,
                   any_i8=bool(t8.any()))
    else:
        args.update(intra=np.zeros(nmb, bool), t8=t8)
        key = dict(any_intra=False, any_t8=True)
    return key, args


@pytest.mark.parametrize("kind,field,cdy", [
    ("I", False, 0), ("P", False, 0), ("I", True, 0), ("P", True, 2)])
def test_recon_deblock_matches_jax(kind, field, cdy):
    mb_w, mb_h = 5, 4
    key, args = _recon_inputs(90 + len(kind) + cdy, mb_w, mb_h, kind)
    if cdy:
        args.pop("t8")
        key = dict(any_intra=False)
    want = jdev.recon_h264_deblock_jit(mb_w, mb_h, **key, field=field,
                                       cdy=cdy)(**args)
    module = tdev.recon_h264_deblock(mb_w, mb_h, **key, field=field,
                                     cdy=cdy, device=CPU)
    t = state_from_numpy(args, CPU)
    got = module(**t)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == torch.uint8
        _eq(g, w)
    # the plain twin is what CPU tensors take: the same picture
    plain = module(**t, run=tdb.deblock_frame_plain)
    for g, w in zip(plain[0], got[0]):
        assert torch.equal(g, w)
    # deblocking acts: the dense recon alone differs
    dense = tdev.recon_h264(mb_w, mb_h, **key, any_cdy=bool(cdy),
                            device=CPU)
    del t["nnz"]
    if cdy:
        t["cdy"] = torch.full((mb_w * mb_h,), cdy, dtype=torch.int32)
    undeblocked = dense(**t)[0]
    assert any(not torch.equal(a, b) for a, b in zip(undeblocked, got[0]))


def test_recon_deblock_takes_k1_by_default():
    """On a card the closed loop's deblock is kernel K1: the default run
    of the module is h264_deblock_frame, which launches it for CUDA
    tensors (and takes its plain version for CPU ones)."""
    run = inspect.signature(tdev.ReconH264Deblock.forward) \
        .parameters["run"].default
    assert run is tdb.h264_deblock_frame
