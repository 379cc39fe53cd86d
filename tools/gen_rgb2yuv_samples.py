"""Search for RGB inputs on which the rounding steps of XLA's CPU code for
the JAX package's RGB -> YUV program (`libav_tpu/swscale/__init__.py`
SwsContext._rgb_to_yuv) and other plausible orders of the same float32
arithmetic give different bytes, and write them to
`libav_tpu_torch/testdata/rgb2yuv_samples.json`:

    python tools/gen_rgb2yuv_samples.py [per_case]

The port's rule (`libav_tpu_torch/swscale/__init__.py` `_rgb2yuv`),
for each component with coefficients (k0, k1, k2) on (r, g, b):

    t = fma(k2, b, fma(k0, r, k1*g))
    limited range: fma(t, K, 16 or 128), K = f32(219 or 224 * f32(1/255))
    full range:    t (Y), t + 128 (U, V)

then, for subsampled chroma, the mean of each block (1x2, 2x1, 2x2, 1x4
or 4x4) summed row by row from 0, ((p00 + p01) + p10) + p11 at 2x2,
times 1/2, 1/4 or 1/16 (`mean_order` picks this "rows" sum or the
vectorised "pairs" one by shape; the units here tell the two apart). The
alternatives searched against it:

    unfused      every product and sum rounded: (k0*r + k1*g) + k2*b,
                 limited t*K + offset
    swapped      the other product of the first add fused:
                 fma(k2, b, fma(k1, g, k0*r))
    outer        only the second add fused: fma(k2, b, k0*r + k1*g)
    final_mul    (limited) the last step unfused: t*K + offset
    old_div      (limited) the port's rule before its repair:
                 fma(t*219|224, f32(1/255), offset)
    exact_const  (limited) K = f32(219|224 / 255)
    pairs        (4:2:0, 4:1:0) each row summed, the row sums added in
                 pairs: (p00 + p01) + (p10 + p11) at 2x2, (r0 + r2) +
                 (r1 + r3) at 4x4
    columns      (4:2:0, 4:1:0) column by column from 0
    halves       (4:1:1) (p0 + p2) + (p1 + p3)
    adjacent     (4:1:1) (p0 + p1) + (p2 + p3)

For every range, subsampling, component and alternative it finds up to
`per_case` (default 3) units, a pixel (Y, 4:4:4 chroma) or a chroma
block (4:2:2, 4:4:0, 4:2:0, 4:1:1, 4:1:0), on which the two give
different bytes:
every one of the 2^24 pixels is evaluated, and pairs and quads are
completed by a search for the partner that puts the block's sum next
to a rounding tie. Pixels for Y are packed 1, 2, 4 or 16 to a unit.
`testdata.rgb2yuv_frame` tiles the units into frames. Deterministic
(seed 10); numpy only; about three minutes and 2 GB.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

F32 = np.float32
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "libav_tpu_torch", "testdata", "rgb2yuv_samples.json")
COEFFS = {"Y": (0.299, 0.587, 0.114), "U": (-0.168736, -0.331264, 0.5),
          "V": (0.5, -0.418688, -0.081312)}
# (rows, cols) of a chroma block by subsampling
BLOCK = {"444": (1, 1), "422": (1, 2), "420": (2, 2), "440": (2, 1),
         "411": (1, 4), "410": (4, 4)}
PIXEL_ALTS = ("unfused", "swapped", "outer", "final_mul", "old_div",
              "exact_const")
LIMITED_ONLY = ("final_mul", "old_div", "exact_const")
# the other summation orders searched, by subsampling
SUB_ORDER_ALTS = {"420": ("pairs", "columns"), "410": ("pairs", "columns"),
                  "411": ("halves", "adjacent")}
ORDER_ALTS = ("pairs", "columns", "halves", "adjacent")


def fma(a, b, c):
    """float32 a*b+c rounded once (the product is exact in float64; the
    float64 sum then rounds to float32 as one rounding on these inputs,
    checked on all 2^24 of them by tests/test_torch_swscale.py)."""
    return (np.asarray(a, np.float64) * np.float64(b) +
            np.asarray(c, np.float64)).astype(F32)


def component(comp: str, full: bool, form: str, r, g, b) -> np.ndarray:
    """float32 value of component comp ("Y", "U", "V") before any mean,
    for float32 arrays r, g, b, by form ("port" or one of PIXEL_ALTS)."""
    k0, k1, k2 = (F32(k) for k in COEFFS[comp])
    if form == "unfused":
        t = (r * k0 + g * k1) + b * k2
    elif form == "swapped":
        t = fma(b, k2, fma(g, k1, r * k0))
    elif form == "outer":
        t = fma(b, k2, r * k0 + g * k1)
    else:
        t = fma(b, k2, fma(r, k0, g * k1))
    off = F32(16 if comp == "Y" else 128)
    if full:
        return t if comp == "Y" else t + off
    scale = 219.0 if comp == "Y" else 224.0
    inv255 = F32(1.0 / 255.0)
    k = F32(scale * inv255)
    if form in ("unfused", "final_mul"):
        return t * k + off
    if form == "old_div":
        return fma(t * F32(scale), inv255, off)
    if form == "exact_const":
        return fma(t, F32(scale / 255.0), off)
    return fma(t, k, off)


def pixel_values(comp: str, full: bool, form: str) -> np.ndarray:
    """`component` for all 2^24 pixels, index r << 16 | g << 8 | b."""
    v = np.arange(1 << 24, dtype=np.uint32)
    r = (v >> 16).astype(F32)
    g = ((v >> 8) & 255).astype(F32)
    b = (v & 255).astype(F32)
    del v
    return component(comp, full, form, r, g, b)


def to_byte(x):
    return np.clip(np.rint(x), 0, 255)


def block_mean(vals, shape, order="rows"):
    """vals: (n, rows * cols) float32 block values in row-major order,
    shape (rows, cols) -> the float32 mean as the port's "rows" sum gives
    it, or another order."""
    fh, fw = shape
    n = fh * fw
    if n == 1:
        return vals[:, 0]

    def p(i, j):
        return vals[:, i * fw + j]
    if order == "pairs":
        lanes = []
        for i in range(fh):
            s = p(i, 0)
            for j in range(1, fw):
                s = s + p(i, j)
            lanes.append(s)
        while len(lanes) > 1:
            half = len(lanes) // 2
            lanes = [lanes[k] + lanes[k + half] for k in range(half)]
        s = lanes[0]
    elif order == "halves":
        s = (p(0, 0) + p(0, 2)) + (p(0, 1) + p(0, 3))
    elif order == "adjacent":
        s = (p(0, 0) + p(0, 1)) + (p(0, 2) + p(0, 3))
    else:
        s = F32(0)
        idx = [(i, j) for j in range(fw) for i in range(fh)] \
            if order == "columns" else \
            [(i, j) for i in range(fh) for j in range(fw)]
        for i, j in idx:
            s = s + p(i, j)
    return s * F32(1.0 / n)


def find_blocks(A, B, shape, rng, want, order="rows", tries=6):
    """Up to `want` blocks of shape (rows, cols) pixel indices, row-major,
    whose byte differs between values A (the port's) and B (an
    alternative's values; with order, A's values summed in that
    order)."""
    n = shape[0] * shape[1]
    found = []
    if n == 1:
        diff = np.flatnonzero(to_byte(A) != to_byte(B))
        if len(diff):
            found = list(rng.choice(diff, min(want, len(diff)),
                                    replace=False)[:, None])
        return found
    order_idx = np.argsort(A, kind="stable")
    sorted_a = A[order_idx]
    lo, hi = float(sorted_a[0]), float(sorted_a[-1])
    moved = np.flatnonzero(A != B) if order == "rows" else None
    period = n                          # a tie: sum = period * k + period/2
    for _ in range(tries):
        m = 1 << 16
        if moved is not None and len(moved):
            first = rng.choice(moved, m)
        else:
            first = rng.integers(0, 1 << 24, m)
        others = rng.integers(0, 1 << 24, (m, n - 2))
        head = np.concatenate([first[:, None], others], axis=1)
        s = A[head[:, 0]]
        for j in range(1, n - 1):
            s = s + A[head[:, j]]
        # the last pixel: its value next to a tie minus the partial sum
        s64 = s.astype(np.float64)
        k_lo = np.ceil((s64 + lo - period / 2) / period).astype(np.int64)
        k_hi = np.floor((s64 + hi - period / 2) / period).astype(np.int64)
        k = k_lo + (rng.random(m) * (k_hi - k_lo + 1)).astype(np.int64)
        target = period * k + period / 2 - s64
        pos = np.searchsorted(sorted_a, target)
        for d in range(-3, 4):
            last = order_idx[np.clip(pos + d, 0, len(sorted_a) - 1)]
            blk = np.concatenate([head, last[:, None]], axis=1)
            got = block_mean(A[blk], shape)
            alt = block_mean(A[blk], shape, order) if order != "rows" \
                else block_mean(B[blk], shape)
            hit = np.flatnonzero(to_byte(got) != to_byte(alt))
            found.extend(blk[hit][:want - len(found)])
            if len(found) >= want:
                return found
    return found


def rgb_of(index):
    index = int(index)
    return [index >> 16, (index >> 8) & 255, index & 255]


def search(per_case: int = 3, seed: int = 10):
    rng = np.random.default_rng(seed)
    # the 4:4:0, 4:1:1 and 4:1:0 searches draw from a stream of their own,
    # so the other subsamplings' units stay those written before them
    rng_new = np.random.default_rng(seed + 1)
    out = {}
    for full in (False, True):
        rng_name = "full" if full else "limited"
        alts = [a for a in PIXEL_ALTS if not (full and a in LIMITED_ONLY)]
        units = {sub: [] for sub in BLOCK}
        for comp in ("Y", "U", "V"):
            A = pixel_values(comp, full, "port")
            for alt in alts + (list(ORDER_ALTS) if comp != "Y" else []):
                B = pixel_values(comp, full, alt) if alt in alts else A
                for sub, (fh, fw) in BLOCK.items():
                    if comp == "Y" and sub != "444":
                        continue        # Y singles serve every layout
                    shape = (1, 1) if comp == "Y" else (fh, fw)
                    if alt in ORDER_ALTS and \
                            alt not in SUB_ORDER_ALTS.get(sub, ()):
                        continue
                    order = alt if alt in ORDER_ALTS else "rows"
                    blocks = find_blocks(
                        A, B, shape, rng if sub in ("444", "422", "420")
                        else rng_new, per_case, order)
                    print(f"{rng_name} {sub} {comp} {alt}: {len(blocks)}",
                          file=sys.stderr)
                    if comp == "Y":
                        for s2, (h2, w2) in BLOCK.items():
                            px = [rgb_of(b[0]) for b in blocks]
                            size = h2 * w2
                            for i in range(0, len(px), size):
                                unit = px[i:i + size]
                                unit += unit[:1] * (size - len(unit))
                                units[s2].append({"what": f"Y {alt}",
                                                  "rgb": unit})
                    else:
                        units[sub].extend(
                            {"what": f"{comp} {alt}",
                             "rgb": [rgb_of(i) for i in b]}
                            for b in blocks)
                del B
            del A
        out[rng_name] = units
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    per_case = int(argv[0]) if argv else 3
    samples = search(per_case)
    with open(OUT, "w") as f:
        json.dump({"note": "written by tools/gen_rgb2yuv_samples.py: RGB "
                           "blocks (row-major, 1x1 / 1x2 / 2x1 / 2x2 / "
                           "1x4 / 4x4 by subsampling) on which the "
                           "port's RGB -> YUV rounding and the named "
                           "alternative give different bytes",
                   "samples": samples}, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {OUT}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
