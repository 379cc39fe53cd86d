"""Adapter for the native MPEG-1/2 slice decoder (mpeg12_slice.c).

One C call decodes one slice straight into the picture's MBData arrays,
byte-identical to MPEG1Decoder._decode_slice_py, the Python twin. The
picture's parameters go in as one int32 array (`_params`), the Annex B
tables as one int32 array built from codecs/mpeg12/tables.py (`tables`).
A nonzero return raises what the twin raises at the same macroblock.
"""

from __future__ import annotations

import functools

import numpy as np

from libav_tpu_torch.avutil.error import AVError, INVALIDDATA

# return codes: the twin's AVError messages (getbits.py, vlc.py, dec.py)
ERRORS = {1: "bitstream overread", 2: "invalid VLC code",
          3: "MB address out of range", 4: "bad I-MB type code",
          5: "zero CBP invalid in MPEG-1",
          6: "motion_type 0 in field picture", 7: "AC index overflow"}
DC_RANGE = 8            # an intra DC outside int16: the twin's numpy raises

# MBData arrays in the C call's order: C element type, shape after the MB
# axis
ARRAYS = (("coeffs", "short", (6, 64)), ("qscale", "int", ()),
          ("intra", "unsigned char", ()), ("use_fwd", "unsigned char", ()),
          ("use_bwd", "unsigned char", ()), ("mv_fwd", "int", (2,)),
          ("mv_bwd", "int", (2,)), ("coded", "unsigned char", ()),
          ("ok", "unsigned char", ()), ("field_mc", "unsigned char", ()),
          ("dct_field", "unsigned char", ()), ("mv_fwd2", "int", (2, 2)),
          ("mv_bwd2", "int", (2, 2)), ("sel_fwd", "int", (2,)),
          ("sel_bwd", "int", (2,)), ("dp", "unsigned char", ()),
          ("mv_dp2", "int", (2, 2)), ("sel_dp", "int", (2,)))
_DTYPES = {"short": np.int16, "int": np.int32, "unsigned char": np.bool_}


def available() -> bool:
    from libav_tpu_torch.native import build
    return not build.disabled() and build.get_lib() is not None


@functools.lru_cache(maxsize=None)
def tables() -> np.ndarray:
    """[(offset, root bits) per VLC, RUN, LEVEL and NON_LINEAR_QSCALE
    offsets | each VLC's flattened (value, length) pairs | RUN | LEVEL |
    NON_LINEAR_QSCALE], int32; the VLC order is mpeg12_slice.c's."""
    from libav_tpu_torch.codecs.mpeg12 import tables as T
    vlcs = (T.mb_addr_vlc(), T.mb_ptype_vlc(), T.mb_btype_vlc(),
            T.cbp_vlc(), T.motion_vlc(), T.dc_lum_vlc(), T.dc_chroma_vlc(),
            T.dct_vlc(False), T.dct_vlc(True))
    head = []
    parts = []
    off = 2 * len(vlcs) + 3
    for v in vlcs:
        pairs = np.stack([v.flat_values.astype(np.int32),
                          v.flat_lengths.astype(np.int32)], 1).ravel()
        head += [off, v.bits]
        parts.append(pairs)
        off += pairs.size
    for arr in (T.RUN_LEVEL[0], T.RUN_LEVEL[1], T.NON_LINEAR_QSCALE):
        head.append(off)
        parts.append(np.asarray(arr, dtype=np.int32))
        off += len(arr)
    return np.concatenate([np.asarray(head, dtype=np.int32)] + parts)


def _params(seq, pic, mb_h: int, mb_y: int) -> np.ndarray:
    # in the order of mpeg12_slice.c's P_* names
    (fx, fy), (bx, by) = pic.f_code
    return np.array([seq.mb_width, mb_h, mb_y, seq.mpeg2, pic.pict_type,
                     pic.picture_structure, pic.frame_pred_frame_dct,
                     pic.concealment_mvs, pic.q_scale_type,
                     pic.intra_vlc_format, pic.intra_dc_precision,
                     pic.top_field_first, pic.full_pel[0], pic.full_pel[1],
                     fx, fy, bx, by], dtype=np.int32)


def decode_slice(seg: bytes, mb, seq, pic, mb_h: int, mb_y: int) -> None:
    """Decode the slice `seg` (the bytes after its start code) into the
    MBData `mb`, as the twin does, with the picture's SeqContext and
    PicContext; mb_h: MB rows of the current picture, mb_y: the slice's
    first row. Raises the twin's AVError (or, for an intra DC outside
    int16, numpy's OverflowError) where the twin raises."""
    from libav_tpu_torch.native.build import get_ffi, get_lib
    lib, ffi = get_lib(), get_ffi()
    par = _params(seq, pic, mb_h, mb_y)
    nmb = seq.mb_width * mb_h
    ptrs = []
    for name, ctype, shape in ARRAYS:
        arr = getattr(mb, name)
        if arr.dtype != _DTYPES[ctype] or not arr.flags.c_contiguous or \
                arr.shape[1:] != shape or arr.shape[0] < nmb:
            raise ValueError(f"MBData.{name}: {arr.dtype} {arr.shape}, "
                             f"contiguous {arr.flags.c_contiguous}; the "
                             f"picture has {nmb} MBs")
        ptrs.append(ffi.from_buffer(ctype + "[]", arr))
    info = np.zeros(3, dtype=np.int32)
    rc = lib.mpeg12_decode_slice(
        ffi.from_buffer("unsigned char[]", seg), len(seg),
        ffi.from_buffer("int[]", par), ffi.from_buffer("int[]", tables()),
        *ptrs, ffi.from_buffer("int[]", info))
    if rc == 0:
        return
    if rc == DC_RANGE:
        idx, blk, value = (int(x) for x in info)
        mb.coeffs[idx, blk, 0] = value      # numpy's OverflowError
        raise OverflowError(f"Python integer {value} out of bounds for "
                            f"int16")
    raise AVError(INVALIDDATA, ERRORS[rc])
