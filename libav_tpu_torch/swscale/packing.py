"""Pixel format pack/unpack layer (reference role: swscale's input
unpackers lumToYV12/chrToYV12 and output packers yuv2packedX /
swscale_unscaled.c fast paths).

Normalizes any supported format to a canonical working form (8-bit
planar yuv / interleaved rgb24 / gray) so the conversion+scale core
handles one representation, then re-packs to the destination.  Pure
rearrangements (nv12, yuyv, gbrp, alpha-RGB orders) are lossless and
bit-exact; bit-depth changes shift with rounding.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.pixfmt import FLAG_RGB, pixdesc

# canonical planar-yuv geometry per (log2_w, log2_h)
_SUB_TO_YUV = {(1, 1): "yuv420p", (1, 0): "yuv422p", (0, 0): "yuv444p",
               (0, 1): "yuv440p", (2, 2): "yuv410p", (2, 0): "yuv411p"}

_CANONICAL = {"yuv420p", "yuv422p", "yuv444p", "yuv440p", "yuv410p",
              "yuv411p", "yuvj420p", "yuvj422p", "yuvj444p",
              "rgb24", "bgr24", "gray"}

# alpha-RGB byte orders: (r, g, b, a) positions within the 4-byte pixel
_ALPHA_RGB = {"rgba": (0, 1, 2, 3), "bgra": (2, 1, 0, 3),
              "argb": (1, 2, 3, 0), "abgr": (3, 2, 1, 0)}


def is_canonical(fmt: str) -> bool:
    return fmt in _CANONICAL


def canonical_of(fmt: str) -> str:
    """The canonical format `fmt` unpacks to / packs from."""
    if fmt in _CANONICAL:
        return fmt
    d = pixdesc(fmt)
    if d.flags & FLAG_RGB or fmt in ("rgb565le", "rgb555le", "bgr565le",
                                     "bgr555le", "rgb8", "bgr8"):
        return "rgb24"
    if fmt.startswith("gray") or fmt == "ya8":
        return "gray"
    if fmt in ("nv12", "nv21"):
        return "yuv420p"
    if fmt in ("nv16", "yuyv422", "uyvy422"):
        return "yuv422p"
    if fmt.startswith(("yuv", "yuva")):
        return _SUB_TO_YUV.get((d.log2_chroma_w, d.log2_chroma_h),
                               "yuv444p")
    raise AVError(EINVAL, f"swscale: no unpacker for {fmt}")


def _depth_to8(a: np.ndarray, depth: int, be: bool) -> np.ndarray:
    """High-depth -> 8 bit: take the top 8 bits (the exact inverse of
    the bit-replication expansion; matches swscale's MSB take)."""
    x = np.asarray(a)
    if x.dtype == np.uint8:
        x = x.view(np.uint16)
    if x.dtype != np.uint16:
        x = x.astype(np.uint16)
    if be:
        x = x.byteswap()
    return (x >> (depth - 8)).astype(np.uint8)


def unpack(planes, fmt: str, w: int, h: int):
    """-> (canonical_fmt, planes) in 8-bit canonical form."""
    if fmt in _CANONICAL:
        return fmt, list(planes)
    d = pixdesc(fmt)
    be = fmt.endswith("be")
    a = [np.asarray(p) for p in planes]

    if fmt in ("nv12", "nv21", "nv16"):
        c = a[1].reshape(a[1].shape[0], -1, 2)
        u, v = c[..., 0], c[..., 1]
        if fmt == "nv21":
            u, v = v, u
        return canonical_of(fmt), [a[0], np.ascontiguousarray(u),
                                   np.ascontiguousarray(v)]
    if fmt in ("yuyv422", "uyvy422"):
        pk = a[0].reshape(h, -1, 4)
        if fmt == "yuyv422":
            y = pk[:, :, (0, 2)].reshape(h, -1)
            u, v = pk[:, :, 1], pk[:, :, 3]
        else:
            y = pk[:, :, (1, 3)].reshape(h, -1)
            u, v = pk[:, :, 0], pk[:, :, 2]
        return "yuv422p", [np.ascontiguousarray(y),
                           np.ascontiguousarray(u),
                           np.ascontiguousarray(v)]
    if fmt.startswith("yuva"):
        return canonical_of(fmt), [a[0], a[1], a[2]]    # drop alpha
    if fmt.startswith("yuv") and d.comp[0].depth > 8:
        dep = d.comp[0].depth
        return canonical_of(fmt), [_depth_to8(p, dep, be) for p in a[:3]]
    if fmt.startswith("gbrp") or fmt == "gbrap":
        dep = d.comp[0].depth
        g, b, r = a[0], a[1], a[2]
        if dep > 8:
            g, b, r = (_depth_to8(p, dep, be) for p in (g, b, r))
        return "rgb24", [np.ascontiguousarray(
            np.stack([r, g, b], axis=-1).reshape(h, -1))]
    if fmt in ("0rgb", "rgb0", "0bgr", "bgr0"):
        px = a[0].reshape(h, -1, 4)
        order = {"0rgb": (1, 2, 3), "rgb0": (0, 1, 2),
                 "0bgr": (3, 2, 1), "bgr0": (2, 1, 0)}[fmt]
        return "rgb24", [np.ascontiguousarray(
            px[:, :, order].reshape(h, -1))]
    if fmt in _ALPHA_RGB:
        px = a[0].reshape(h, -1, 4)
        r, g, b, _al = _ALPHA_RGB[fmt]
        return "rgb24", [np.ascontiguousarray(
            px[:, :, (r, g, b)].reshape(h, -1))]
    if fmt in ("rgb48le", "rgb48be", "bgr48le", "rgba64le"):
        ncomp = 4 if fmt == "rgba64le" else 3
        px = a[0].view(np.uint16).reshape(h, -1, ncomp)
        if be:
            px = px.byteswap()
        rgb = px[:, :, :3].astype(np.int32) >> 8   # MSB take
        if fmt.startswith("bgr"):
            rgb = rgb[:, :, ::-1]
        return "rgb24", [np.ascontiguousarray(
            rgb.astype(np.uint8).reshape(h, -1))]
    if fmt in ("rgb565le", "bgr565le", "rgb555le", "bgr555le"):
        px = a[0].view(np.uint16).reshape(h, -1).astype(np.int32)
        if "565" in fmt:
            r = (px >> 11) & 31
            g = (px >> 5) & 63
            b = px & 31
            r = (r << 3) | (r >> 2)
            g = (g << 2) | (g >> 4)
            b = (b << 3) | (b >> 2)
        else:
            r = (px >> 10) & 31
            g = (px >> 5) & 31
            b = px & 31
            r = (r << 3) | (r >> 2)
            g = (g << 3) | (g >> 2)
            b = (b << 3) | (b >> 2)
        if fmt.startswith("bgr"):
            r, b = b, r
        return "rgb24", [np.ascontiguousarray(
            np.stack([r, g, b], axis=-1).astype(np.uint8).reshape(h, -1))]
    if fmt.startswith("gray") and fmt != "gray":
        dep = d.comp[0].depth
        return "gray", [_depth_to8(a[0], dep, be)]
    if fmt == "ya8":
        px = a[0].reshape(h, -1, 2)
        return "gray", [np.ascontiguousarray(px[:, :, 0])]
    raise AVError(EINVAL, f"swscale: no unpacker for {fmt}")


def pack(planes, canonical: str, fmt: str, w: int, h: int):
    """Canonical 8-bit planes -> destination format planes."""
    if fmt in _CANONICAL:
        return list(planes)
    d = pixdesc(fmt)
    be = fmt.endswith("be")
    a = [np.asarray(p) for p in planes]

    def to_depth(p, dep):
        # 8 -> N expansion: plain shift for 9..15 bits, bit replication
        # at 16 (matches the reference's 15/19-bit output chains)
        x = p.astype(np.uint16)
        if dep == 16:
            x = (x << 8) | x
        else:
            x = x << (dep - 8)
        return x.byteswap() if be else x

    if fmt in _ALPHA_RGB:
        px = a[0].reshape(h, -1, 3)
        out = np.full((h, px.shape[1], 4), 255, np.uint8)
        r, g, b, _al = _ALPHA_RGB[fmt]
        out[:, :, r] = px[:, :, 0]
        out[:, :, g] = px[:, :, 1]
        out[:, :, b] = px[:, :, 2]
        return [np.ascontiguousarray(out.reshape(h, -1))]
    if fmt in ("nv12", "nv21", "nv16"):
        u, v = (a[2], a[1]) if fmt == "nv21" else (a[1], a[2])
        c = np.stack([u, v], axis=-1).reshape(u.shape[0], -1)
        return [a[0], np.ascontiguousarray(c)]
    if fmt in ("yuyv422", "uyvy422"):
        y = a[0].reshape(h, -1, 2)
        if fmt == "yuyv422":
            px = np.stack([y[:, :, 0], a[1], y[:, :, 1], a[2]], axis=-1)
        else:
            px = np.stack([a[1], y[:, :, 0], a[2], y[:, :, 1]], axis=-1)
        return [np.ascontiguousarray(px.reshape(h, -1))]
    if fmt.startswith("yuva"):
        alpha = np.full_like(a[0], 255)
        return [a[0], a[1], a[2], alpha]
    if fmt.startswith("yuv") and d.comp[0].depth > 8:
        dep = d.comp[0].depth
        return [to_depth(p, dep) for p in a[:3]]
    if fmt.startswith("gbrp") or fmt == "gbrap":
        px = a[0].reshape(h, -1, 3)
        r, g, b = px[:, :, 0], px[:, :, 1], px[:, :, 2]
        dep = d.comp[0].depth
        if dep > 8:
            out = [to_depth(np.ascontiguousarray(x), dep)
                   for x in (g, b, r)]
        else:
            out = [np.ascontiguousarray(g), np.ascontiguousarray(b),
                   np.ascontiguousarray(r)]
        if fmt == "gbrap":
            out.append(np.full_like(out[0], 255))
        return out
    if fmt in ("0rgb", "rgb0", "0bgr", "bgr0"):
        px = a[0].reshape(h, -1, 3)
        z = np.zeros_like(px[:, :, :1])
        r, g, b = (px[:, :, i:i + 1] for i in range(3))
        order = {"0rgb": (z, r, g, b), "rgb0": (r, g, b, z),
                 "0bgr": (z, b, g, r), "bgr0": (b, g, r, z)}[fmt]
        return [np.ascontiguousarray(
            np.concatenate(order, axis=-1).reshape(h, -1))]
    if fmt in ("rgb48le", "rgb48be", "bgr48le", "rgba64le"):
        px = a[0].reshape(h, -1, 3).astype(np.uint16)
        px = (px << 8) | px
        if fmt.startswith("bgr"):
            px = px[:, :, ::-1]
        if fmt == "rgba64le":
            alpha = np.full_like(px[:, :, :1], 0xFFFF)
            px = np.concatenate([px, alpha], axis=-1)
        if be:
            px = px.byteswap()
        return [np.ascontiguousarray(px.reshape(h, -1).view(np.uint8))]
    if fmt in ("rgb565le", "bgr565le", "rgb555le", "bgr555le"):
        px = a[0].reshape(h, -1, 3).astype(np.uint16)
        r, g, b = px[:, :, 0], px[:, :, 1], px[:, :, 2]
        if fmt.startswith("bgr"):
            r, b = b, r
        if "565" in fmt:
            v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
        else:
            v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
        return [np.ascontiguousarray(v.view(np.uint8))]
    if fmt.startswith("gray") and fmt != "gray":
        return [to_depth(a[0], d.comp[0].depth)]
    if fmt == "ya8":
        alpha = np.full_like(a[0], 255)
        return [np.ascontiguousarray(
            np.stack([a[0], alpha], axis=-1).reshape(h, -1))]
    raise AVError(EINVAL, f"swscale: no packer for {fmt}")
