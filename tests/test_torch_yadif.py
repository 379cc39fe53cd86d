"""The port's yadif (libav_tpu_torch/ops/yadif.py and the yadif filter)
against the JAX package's, on the CPU.

`yadif_plane` is held against `libav_tpu.ops.yadif.yadif_plane` (the
jitted XLA program, run on the JAX CPU) on seeded uint8 planes in all
four modes, both parities and both field orders, at even, odd and tiny
shapes; the filter is held against the JAX filter through both packages'
filter graphs in every mode, with the parity forced or detected (auto),
`auto=1` on a mix of interlaced and progressive frames, and the EOF
flush. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from libav_tpu.ops import yadif as jyadif
from libav_tpu_torch.ops import yadif
from test_torch_filters_video import assert_same, frames_of, run_both


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _planes(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w))
    # three frames of one moving, noisy picture: the temporal terms and
    # the edge search both get work
    return [np.clip(np.roll(base, t, axis=1) +
                    rng.integers(-40, 41, (h, w)), 0, 255).astype(np.uint8)
            for t in range(3)]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("parity,tff", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("shape", [(48, 64), (23, 37)],
                         ids=lambda s: "%dx%d" % s)
def test_yadif_plane_matches_jax(mode, parity, tff, shape):
    prev, cur, nxt = _planes(*shape, seed=mode * 4 + parity * 2 + tff)
    want = jyadif.yadif_plane(prev, cur, nxt, parity, tff, mode)
    got = yadif.yadif_plane(*(torch.from_numpy(p) for p in
                              (prev, cur, nxt)), parity, tff, mode)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 9), (2, 5), (3, 8), (4, 3), (5, 7)],
                         ids=lambda s: "%dx%d" % s)
def test_yadif_plane_tiny_matches_jax(shape):
    """Planes of fewer rows than the filter's taps and narrower than its
    column search: the row gathers clamp as XLA's do."""
    prev, cur, nxt = _planes(*shape, seed=sum(shape))
    for mode, parity, tff in ((0, 1, 1), (1, 0, 1)):
        want = jyadif.yadif_plane(prev, cur, nxt, parity, tff, mode)
        got = yadif.yadif_plane(*(torch.from_numpy(p) for p in
                                  (prev, cur, nxt)), parity, tff, mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("parity", [-1, 0, 1])
@pytest.mark.parametrize("tff", [True, False])
def test_yadif_filter_matches_jax(mode, parity, tff):
    """The filter's window, parity choice, pts doubling and EOF flush:
    every output frame and its timestamp."""
    pairs = frames_of("yuv420p", 40, 24, n=4, seed=mode,
                      interlaced=True, tff=tff)
    jouts, touts = run_both(f"yadif=mode={mode}:parity={parity}", pairs)
    assert len(jouts) == 4 * (1 + (mode & 1))
    assert_same(jouts, touts)


@pytest.mark.parametrize("mode", [0, 1])
def test_yadif_auto_matches_jax(mode):
    """auto=1 deinterlaces only the frames marked interlaced."""
    pairs = frames_of("yuv420p", 40, 24, n=5, seed=7, interlaced=True)
    for jf, tf in pairs[1::2]:
        jf.interlaced_frame = tf.interlaced_frame = False
    assert_same(*run_both(f"yadif=mode={mode}:auto=1", pairs))


@pytest.mark.parametrize("fmt", ["yuv422p", "yuv444p", "gray"])
def test_yadif_formats_match_jax(fmt):
    pairs = frames_of(fmt, 37, 23, n=3, seed=3, interlaced=True)
    assert_same(*run_both("yadif=1", pairs))
