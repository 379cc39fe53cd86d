"""Which order XLA's CPU code sums the chroma blocks of the JAX package's
RGB -> YUV program in (`libav_tpu/swscale/__init__.py`
SwsContext._rgb_to_yuv, `reshape(ch, fh, cw, fw).mean(axis=(1, 3))`), at
each frame shape asked for, against the port's `mean_order`:

    JAX_PLATFORMS=cpu python tools/check_rgb2yuv_order.py yuv410p \\
        [HxW,HxW,...]

Each frame is built so that the candidate orders below give different
bytes: every chroma block is one found by a random search on which they
disagree, its edge-padded copies included (the blocks at a padded edge
are searched with the same padding). For each shape the script prints
the candidates that give XLA's bytes and whether `mean_order` names one
of them (exit 1 if not). The candidates, over the block's values p[i][j]
(row i, column j):

    rows      sum from 0, row by row, left to right (scalar)
    pairs     one lane per row, each summing its row left to right, the
              lanes then added in pairs: halves, then halves again
    columns   sum from 0, column by column
    colpairs  one lane per column, then the lanes in pairs
    adjacent  each row in adjacent pairs ((p0 + p1) + (p2 + p3)), the
              rows then in turn

The per-pixel values are the port's rule (tools/gen_rgb2yuv_samples.py
`component`). Without shapes it checks a default set of 935 (heights
1-1081, widths 1-1921), about half an hour for yuv410p on one CPU.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from gen_rgb2yuv_samples import component  # noqa: E402

F32 = np.float32
SUB = {"yuv420p": (2, 2), "yuvj420p": (2, 2), "yuv410p": (4, 4),
       "yuv411p": (1, 4), "yuvj411p": (1, 4), "yuv440p": (2, 1),
       "yuvj440p": (2, 1)}
ORDERS = ("rows", "pairs", "columns", "colpairs", "adjacent")
DEFAULT_SHAPES = ([(h, w) for h in (1, 2, 3, 4, 5, 8)
                   for w in range(1, 141)] +
                  [(h, w) for h in (4, 16, 64, 1080, 1081)
                   for w in (1, 3, 5, 53, 121, 123, 124, 125, 127, 128, 129,
                             255, 256, 257, 1023, 1024, 1918, 1920, 1921)])


def _halves(vals):
    while len(vals) > 1:
        half = len(vals) // 2
        vals = [vals[k] + vals[k + half] for k in range(half)]
    return vals[0]


def _in_turn(vals):
    s = vals[0]
    for v in vals[1:]:
        s = s + v
    return s


def block_sum(q: np.ndarray, order: str) -> np.ndarray:
    """q (ch, fh, cw, fw) float32 -> (ch, cw) float32 block sums."""
    fh, fw = q.shape[1], q.shape[3]

    def p(i, j):
        return q[:, i, :, j]
    if order == "rows":
        return _in_turn([np.zeros_like(p(0, 0))] +
                        [p(i, j) for i in range(fh) for j in range(fw)])
    if order == "columns":
        return _in_turn([np.zeros_like(p(0, 0))] +
                        [p(i, j) for j in range(fw) for i in range(fh)])
    if order == "pairs":
        return _halves([_in_turn([p(i, j) for j in range(fw)])
                        for i in range(fh)])
    if order == "colpairs":
        return _halves([_in_turn([p(i, j) for i in range(fh)])
                        for j in range(fw)])
    if order == "adjacent":
        def adj(vals):
            while len(vals) > 1:
                vals = [vals[k] + vals[k + 1]
                        for k in range(0, len(vals), 2)]
            return vals[0]
        return _in_turn([adj([p(i, j) for j in range(fw)])
                         for i in range(fh)])
    raise ValueError(order)


def _chroma(rgb, full, comp):
    x = rgb.astype(F32)
    return component(comp, full, "port", x[..., 0], x[..., 1], x[..., 2])


def _bytes(s, n):
    return np.clip(np.rint(s * F32(1.0 / n)), 0, 255).astype(np.uint8)


def predict(rgb, fh, fw, full, order):
    """The U and V planes of an (h, w, 3) frame summed in `order`."""
    h, w, _ = rgb.shape
    ch, cw = -(-h // fh), -(-w // fw)
    rows = np.minimum(np.arange(ch * fh), h - 1)
    cols = np.minimum(np.arange(cw * fw), w - 1)
    out = []
    for comp in ("U", "V"):
        q = _chroma(rgb, full, comp)[rows][:, cols].reshape(ch, fh, cw, fw)
        out.append(_bytes(block_sum(q, order), fh * fw))
    return out


@functools.lru_cache(maxsize=None)
def pool(fh, fw, rr, rc, full, want=64):
    """RGB blocks (fh, fw, 3), an rr x rc corner random and the rest
    edge-repeated, on which ORDERS give different U or V bytes."""
    rng = np.random.default_rng(1 + 100 * rr + 10 * rc + full)
    ri = np.minimum(np.arange(fh), rr - 1)
    ci = np.minimum(np.arange(fw), rc - 1)
    found = []
    for _ in range(8):
        m = 1 << 17
        blk = rng.integers(0, 256, (m, fh, fw, 3), dtype=np.uint8)
        blk = blk[:, ri][:, :, ci]
        for comp in ("U", "V"):
            q = _chroma(blk, full, comp).reshape(m, fh, 1, fw)
            b = np.stack([_bytes(block_sum(q, o)[:, 0], fh * fw)
                          for o in ORDERS])
            found.extend(blk[np.flatnonzero((b != b[0]).any(axis=0))])
        if len(found) >= want:
            break
    return np.stack(found) if found else np.zeros((0, fh, fw, 3), np.uint8)


def frame(h, w, fh, fw, full):
    """An (h, w, 3) uint8 frame whose chroma blocks all come from
    `pool` (those no candidates disagree on stay random)."""
    rng = np.random.default_rng(7 * h + w)
    out = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for bi in range(-(-h // fh)):
        rr = min(fh, h - bi * fh)
        for bj in range(-(-w // fw)):
            rc = min(fw, w - bj * fw)
            p = pool(fh, fw, rr, rc, full)
            if len(p):
                out[bi * fh:bi * fh + rr, bj * fw:bj * fw + rc] = \
                    p[rng.integers(len(p))][:rr, :rc]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fmt = argv[0]
    shapes = ([tuple(int(v) for v in s.split("x"))
               for s in argv[1].split(",")] if len(argv) > 1
              else DEFAULT_SHAPES)
    from libav_tpu import swscale as jsw
    from libav_tpu_torch.swscale import mean_order
    fh, fw = SUB[fmt]
    full = fmt.startswith("yuvj")
    lw, lh = fw.bit_length() - 1, fh.bit_length() - 1
    bad = 0
    for h, w in shapes:
        rgb = frame(h, w, fh, fw, full)
        want = jsw.SwsContext(w, h, "rgb24", w, h, fmt)._rgb_to_yuv(
            [rgb.reshape(h, 3 * w)], "rgb24", fmt)[1:]
        match = [o for o in ORDERS if all(
            np.array_equal(a, np.asarray(b))
            for a, b in zip(predict(rgb, fh, fw, full, o), want))]
        port = mean_order(h, w, lw, lh, full)
        ok = port in match
        bad += not ok
        print(f"{fmt} {h}x{w}: XLA's bytes from {match}; mean_order "
              f"{port} {'ok' if ok else 'WRONG'}", flush=True)
    print(f"{len(shapes) - bad} of {len(shapes)} shapes ok", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
