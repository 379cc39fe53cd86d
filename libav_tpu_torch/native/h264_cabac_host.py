"""Adapter for the native H.264 CABAC slice decoder (cabac.c).

All per-frame outputs live in ONE contiguous int32 arena (layout
mirrored in cabac.c) plus an int16 coefficient buffer holding the
sparse AC lists; numpy views expose the per-field arrays."""

from __future__ import annotations

import numpy as np

ARENA_WORDS_PER_MB = 297          # + 6 tail words
ARENA_TAIL = 6


def available() -> bool:
    from libav_tpu_torch.native.build import get_lib, _present
    if not any(s == "cabac.c" for s, _ in _present()):
        return False
    return get_lib() is not None


def alloc(nmb: int):
    """(arena, coeffs) buffers."""
    return (np.zeros(nmb * ARENA_WORDS_PER_MB + ARENA_TAIL,
                     dtype=np.int32),
            np.zeros((nmb * 24) * 16, dtype=np.int16))


def views(arena: np.ndarray, coeffs: np.ndarray, nmb: int, mb_w: int,
          mb_h: int) -> dict:
    o = 0

    def take(n, shape):
        nonlocal o
        v = arena[o:o + n].reshape(shape)
        o += n
        return v

    bw, bh = 4 * mb_w, 4 * mb_h
    d = dict(
        intra=take(nmb, (nmb,)),
        i4=take(nmb, (nmb,)),
        intra16=take(nmb, (nmb,)),
        luma_mode=take(nmb, (nmb,)),
        chroma_mode=take(nmb, (nmb,)),
        qp=take(nmb, (nmb,)),
        coded=take(nmb, (nmb,)),
        skip=take(nmb, (nmb,)),
        direct=take(nmb, (nmb,)),
        cbp=take(nmb, (nmb,)),
        mcslice=take(nmb, (nmb,)),
        mv=take(2 * nmb, (nmb, 2)),
        ref_idx=take(nmb, (nmb,)),
        sel=take(nmb, (nmb,)),
        i4_modes=take(16 * nmb, (nmb, 16)),
        luma_dc=take(16 * nmb, (nmb, 16)),
        chroma_dc=take(8 * nmb, (nmb, 2, 4)),
        nnz_y=take(16 * nmb, (bh, bw)),
        nnz_u=take(4 * nmb, (2 * mb_h, 2 * mb_w)),
        nnz_v=take(4 * nmb, (2 * mb_h, 2 * mb_w)),
        bref=take(2 * 16 * nmb, (2, bh, bw)),
        bmv=take(2 * 16 * nmb * 2, (2, bh, bw, 2)),
        bmvd=take(2 * 16 * nmb * 2, (2, bh, bw, 2)),
        bdirect=take(16 * nmb, (bh, bw)),
        gslice=take(nmb, (nmb,)),
        i4grid=take(16 * nmb, (bh, bw)),
        transform8=take(nmb, (nmb,)),
        flags=take(4, (4,)),
        sctx=take(2 + 24 * nmb, (2 + 24 * nmb,)),
    )
    d["yvals"] = coeffs[:nmb * 16 * 16].reshape(nmb * 16, 16)
    d["cvals"] = coeffs[nmb * 16 * 16:].reshape(nmb * 8, 16)
    return d


def reset_arena(v: dict):
    """Frame-start arena init (numpy-side so parallel slice jobs can
    launch in any order)."""
    for k in ("intra", "i4", "intra16", "luma_mode", "chroma_mode",
              "qp", "coded", "skip", "direct", "cbp", "mv", "ref_idx",
              "sel", "luma_dc", "chroma_dc", "nnz_y", "nnz_u", "nnz_v",
              "bmv", "bmvd", "bdirect", "transform8", "flags"):
        v[k][:] = 0
    v["mcslice"][:] = -1
    v["gslice"][:] = -1
    v["i4_modes"][:] = 2
    v["bref"][:] = -2
    v["i4grid"][:] = -1
    v["sctx"][0] = 0
    v["sctx"][1] = 0


def _check_grids(bref, bmv, nnz_y=None):
    """The arena's int32 block grids, checked before their pointers go
    to C (cffi refuses a buffer that is not C-contiguous)."""
    ok = (bref.dtype == bmv.dtype == np.int32 and bref.ndim == 3
          and bmv.shape == bref.shape + (2,))
    if nnz_y is not None:
        ok = ok and nnz_y.dtype == np.int32 and nnz_y.shape == bref.shape[1:]
    if not ok:
        raise ValueError("block grids must be the int32 arena views: "
                         f"bref {bref.dtype} {bref.shape}, bmv {bmv.dtype} "
                         f"{bmv.shape}")


def col_pack(bref: np.ndarray, bmv: np.ndarray, l0pocs: np.ndarray,
             l1pocs: np.ndarray) -> np.ndarray:
    """One-pass packed colocated-motion export: (bh, bw, 4) int32 rows
    of (ref, mvx, mvy, refpoc).  bref (2, bh, bw) / bmv (2, bh, bw, 2)
    are the contiguous int32 arena views; l0pocs/l1pocs carry a
    trailing-0 sentinel."""
    from libav_tpu_torch.native.build import get_lib, get_ffi
    _check_grids(bref, bmv)
    lib = get_lib()
    ffi = get_ffi()
    _, bh, bw = bref.shape
    out = np.empty((bh, bw, 4), np.int32)
    lib.h264_col_pack(
        ffi.cast("const int*", ffi.from_buffer(bref)),
        ffi.cast("const int*", ffi.from_buffer(bmv)),
        ffi.cast("const int*", ffi.from_buffer(l0pocs)), len(l0pocs),
        ffi.cast("const int*", ffi.from_buffer(l1pocs)), len(l1pocs),
        bh * bw,
        ffi.cast("int*", ffi.from_buffer(out)))
    return out


def decode_slice(arena: np.ndarray, coeffs: np.ndarray, data: bytes,
                 mb_w: int, mb_h: int, first_mb: int, slice_type: int,
                 qp: int, cabac_init_idc: int, nref0: int, nref1: int,
                 cur_slice: int, reset: bool, col=None,
                 sctx=None, ycap: int = 0, t8mode: int = 0,
                 d8x8inf: int = 1, field: int = 0) -> int:
    """Run the C CABAC MB loop. col = packed int32 (bh*bw, 3) colocated
    (ref, mvx, mvy) for spatial direct, or None. With sctx/ycap the
    sparse outputs go to private per-slice buffers (parallel slice
    decode); `coeffs` is then [ycap*16 yvals | cvals] int16. field: the
    slice is a field picture's (field_pic_flag); its coefficient rows
    come out in the zigzag layout a frame's have."""
    from libav_tpu_torch.native.build import get_lib, get_ffi
    lib = get_lib()
    ffi = get_ffi()
    params = np.array([mb_w, mb_h, first_mb, slice_type, qp,
                       cabac_init_idc, nref0, nref1, cur_slice,
                       1 if reset else 0, 0 if col is None else 1,
                       ycap, t8mode, d8x8inf, 1 if field else 0],
                      dtype=np.int32)
    cg = ffi.NULL if col is None else \
        ffi.cast("const int*", ffi.from_buffer(col))
    sc = ffi.NULL if sctx is None else \
        ffi.cast("int*", ffi.from_buffer(sctx))
    return lib.h264_cabac_decode_slice(
        ffi.cast("const unsigned char*", ffi.from_buffer(data)), len(data),
        ffi.cast("const int*", ffi.from_buffer(params)),
        cg,
        ffi.cast("short*", ffi.from_buffer(coeffs)),
        ffi.cast("int*", ffi.from_buffer(arena)),
        ffi.NULL, sc)


def export_blocks(bref, bmv, nnz_y, nrefs, nrefs1, l0pid, l1pid,
                  want_b, want_pid, want_nnz, zero_bmv1):
    """One C pass packing the block-granular device transport from the
    int32 arena grids (bref (2,bh,bw), bmv (2,bh,bw,2)) into the final
    dtypes the recon program consumes.  Returns the kw fragment."""
    from libav_tpu_torch.native.build import get_lib, get_ffi
    _check_grids(bref, bmv, nnz_y if want_nnz else None)
    lib = get_lib()
    ffi = get_ffi()
    _, bh, bw = bref.shape
    ncell = bh * bw
    bmv0 = np.empty((bh, bw, 2), np.int16)
    bref0 = np.empty((bh, bw), np.int8)
    bsel = np.empty((bh, bw), np.int8)
    need_bmv1 = want_b or zero_bmv1
    bmv1 = np.empty((bh, bw, 2), np.int16) if need_bmv1 else None
    bref1 = np.empty((bh, bw), np.int8) if want_b else None
    pid0 = np.empty((bh, bw), np.int8) if want_pid else None
    pid1 = np.empty((bh, bw), np.int8) if want_pid else None
    nnz8 = np.empty((bh, bw), np.int8) if want_nnz else None
    l0 = np.ascontiguousarray(l0pid, np.int32) if l0pid is not None \
        else np.zeros(1, np.int32)
    l1 = np.ascontiguousarray(l1pid, np.int32) if l1pid is not None \
        else np.zeros(1, np.int32)

    def ip(a, t):
        return ffi.NULL if a is None else ffi.cast(t, ffi.from_buffer(a))

    lib.h264_export_blocks(
        ip(bref, "const int*"), ip(bmv, "const int*"),
        ip(nnz_y if want_nnz else None, "const int*"), ncell,
        int(nrefs), int(nrefs1),
        ip(l0, "const int*"), len(l0), ip(l1, "const int*"), len(l1),
        1 if want_b else 0, 1 if want_pid else 0,
        1 if want_nnz else 0, 1 if zero_bmv1 else 0,
        ip(bmv0, "short*"), ip(bref0, "signed char*"),
        ip(bsel, "signed char*"), ip(bmv1, "short*"),
        ip(bref1, "signed char*"), ip(pid0, "signed char*"),
        ip(pid1, "signed char*"), ip(nnz8, "signed char*"))
    out = {"bmv0": bmv0, "bref0": bref0, "bsel": bsel}
    if need_bmv1:
        out["bmv1"] = bmv1
    if want_b:
        out["bref1"] = bref1
    if want_pid:
        out["pid0"] = pid0
        out["pid1"] = pid1
    if want_nnz:
        out["nnz"] = nnz8
    return out
