"""Holds the port's float32 8x8 forward transform of the H.264 encoder
(`libav_tpu_torch/ops/h264transform.py` fdct8x8_h264_xla) against the
JAX encoder's, as XLA compiles it on this CPU:

    JAX_PLATFORMS=cpu python tools/check_fdct8_order.py [blocks] [qp,...]

The JAX encoder computes `einsum(F8, resid, F8)` in float32 and then
`round(c8 / step8)`, in two forms: "ki,bij,lj->bkl" over (B, 8, 8)
residuals (I_8x8, libav_tpu/codecs/h264/enc.py _encode_i8_jit) and
"ki,nbij,lj->nbkl" over (N, 4, 8, 8) (the P pictures' dct8x8 levels,
_encode_p_jit). For each form and each qp (default 0-51) the script runs
`blocks` residuals (default 2^20) through both: a random half in [-255,
255], and a half built near ties, blocks whose exact float64 coefficient
lies within a few float32 ulps of a rounding boundary. It prints per form
and qp the count of float32 coefficients and of levels that differ, and
exits 1 if any does.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def residuals(n: int, qp: int, seed: int) -> np.ndarray:
    """(n, 8, 8) float32 residuals: half random in [-255, 255], half
    nudged so that some coefficient of each sits near a rounding tie of
    round(c8 / step8)."""
    from libav_tpu_torch.ops.h264transform import (_fdct8_matrix,
                                                   fdct8x8_h264_ref, step8)
    rng = np.random.default_rng(seed)
    half = n // 2
    x = rng.integers(-255, 256, size=(n, 8, 8)).astype(np.float64)
    # near ties: move one residual sample so that coefficient (k, l)
    # lands on (m + 1/2) * step, then round to integers (the residual
    # is an integer), which leaves it within a fraction of a step of it
    F = _fdct8_matrix()
    st = step8(qp).astype(np.float64)
    c = fdct8x8_h264_ref(x[half:])
    k = rng.integers(0, 8, size=n - half)
    l_ = rng.integers(0, 8, size=n - half)
    i = rng.integers(0, 8, size=n - half)
    j = rng.integers(0, 8, size=n - half)
    idx = np.arange(n - half)
    ckl = c[idx, k, l_]
    target = (np.floor(ckl / st[k, l_]) + 0.5) * st[k, l_]
    gain = F[k, i] * F[l_, j]
    ok = np.abs(gain) > 1e-3
    delta = np.where(ok, (target - ckl) / np.where(ok, gain, 1), 0)
    x[half + idx, i, j] = np.clip(np.round(x[half + idx, i, j] + delta),
                                  -255, 255)
    return x.astype(np.float32)


def xla(form: str, x: np.ndarray, qp: int):
    """The JAX encoder's c8 and levels for residuals x (n, 8, 8)."""
    import jax
    import jax.numpy as jnp
    from libav_tpu.ops.h264transform import _fdct8_matrix
    from libav_tpu_torch.ops.h264transform import step8
    F8 = np.asarray(_fdct8_matrix(), np.float32)
    st = step8(qp)
    if form == "bij":
        def fn(r):
            c8 = jnp.einsum("ki,bij,lj->bkl", jnp.asarray(F8), r,
                            jnp.asarray(F8))
            return c8, jnp.round(c8 / jnp.asarray(st)).astype(jnp.int32)
        c8, lv = jax.jit(fn)(x)
    else:
        def fn(r):
            c8 = jnp.einsum("ki,nbij,lj->nbkl", jnp.asarray(F8), r,
                            jnp.asarray(F8))
            return c8, jnp.round(c8 / jnp.asarray(st)).astype(jnp.int32)
        c8, lv = jax.jit(fn)(x.reshape(-1, 4, 8, 8))
    return (np.asarray(c8).reshape(-1, 8, 8),
            np.asarray(lv).reshape(-1, 8, 8))


def port(x: np.ndarray, qp: int, form: str):
    import torch
    from libav_tpu_torch.ops.h264transform import fdct8x8_h264_xla
    t = torch.as_tensor(x)
    if form == "nbij":
        t = t.reshape(-1, 4, 8, 8)
    c8, lv = fdct8x8_h264_xla(t, qp, with_coefficients=True)
    return c8.numpy().reshape(-1, 8, 8), lv.numpy().reshape(-1, 8, 8)


def check(blocks: int, qps, out=print) -> int:
    """Runs the comparison; returns the count of differing values."""
    blocks -= blocks % 8
    bad = 0
    for form in ("bij", "nbij"):
        for qp in qps:
            x = residuals(blocks, qp, 1000 + qp)
            jc, jl = xla(form, x, qp)
            tc, tl = port(x, qp, form)
            dc = int(np.count_nonzero(jc.view(np.int32) !=
                                      tc.view(np.int32)))
            dl = int(np.count_nonzero(jl != tl))
            bad += dc + dl
            out(f"{form} qp {qp}: {blocks} blocks, {dc} float32 c8 and "
                f"{dl} levels differ from XLA's")
    return bad


def main(argv):
    blocks = int(argv[0]) if argv else 1 << 20
    qps = ([int(q) for q in argv[1].split(",")] if len(argv) > 1
           else list(range(52)))
    bad = check(blocks, qps)
    print(f"total differing: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
