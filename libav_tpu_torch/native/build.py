"""On-demand cffi build of the native host library.

One shared library aggregates every C hot loop; the first call to get_lib()
compiles it into libav_tpu_torch/native/_build/ (cached by source hash). If
compilation fails (no compiler), get_lib() returns None and the Python
reference paths are used instead.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_BUILD = _HERE / "_build"

# (source file, C declaration) — a function is only built/declared when its
# source file exists, so new native loops are added by dropping in a .c file
# and a row here.
_COMPONENTS = [
    ("mjpeg_scan.c", r"""
int mjpeg_decode_scan(
    const unsigned char **segs, const long long *seg_lens, int n_segs,
    const int *comp_meta, int n_comp,
    const int **dc_vals, const signed char **dc_lens,
    const int **ac_vals, const signed char **ac_lens,
    short **out,
    int mcus_x, int mcus_y, int ns, int restart_interval);
"""),
    ("jpeg_enc.c", r"""
int jpeg_encode_scan(
    const short **levels, const int *comp_meta, int n_comp,
    const unsigned int **dc_codes, const unsigned char **dc_sizes,
    const unsigned int **ac_codes, const unsigned char **ac_sizes,
    int mcus_x, int mcus_y,
    unsigned char *out_buf, long long out_cap, long long *out_len);
"""),
    ("mpeg12_slice.c", r"""
int mpeg12_decode_slice(
    const unsigned char *buf, long long buf_size,
    const int *params, const int *tables,
    short *coeffs, int *qscale, unsigned char *intra,
    unsigned char *use_fwd, unsigned char *use_bwd,
    int *mv_fwd, int *mv_bwd, unsigned char *coded, unsigned char *ok,
    unsigned char *field_mc, unsigned char *dct_field,
    int *mv_fwd2, int *mv_bwd2, int *sel_fwd, int *sel_bwd,
    unsigned char *dp, int *mv_dp2, int *sel_dp, int *info);
"""),
    ("mpeg4_enc.c", r"""
int mpeg4_encode_mbs(
    const short *levels, const int *mb_meta, const short *mvs,
    int mb_width, int mb_height, int params0, int params1,
    unsigned char *out_buf, long long out_cap, long long *out_len);
"""),
    ("h264_cavlc.c", r"""
int h264_cavlc_decode_slice(
    const unsigned char *buf, long long buf_size,
    const int *params, const int *ctx_in,
    short *coeffs, int *mb_meta, short *mvs, int *ctx_out);
"""),
    ("cabac.c", r"""
int h264_cabac_decode_slice(
    const unsigned char *buf, long long buf_size,
    const int *params, const int *ctx_in,
    short *coeffs, int *mb_meta, short *mvs, int *ctx_out);
void h264_col_pack(
    const int *bref, const int *bmv,
    const int *l0pocs, int n0, const int *l1pocs, int n1,
    long long ncell, int *out);
void h264_export_blocks(
    const int *bref, const int *bmv, const int *nnz_y, long long ncell,
    int nrefs, int nrefs1,
    const int *l0pid, int nl0, const int *l1pid, int nl1,
    int want_b, int want_pid, int want_nnz, int zero_bmv1,
    short *bmv0, signed char *bref0, signed char *bsel,
    short *bmv1, signed char *bref1,
    signed char *pid0, signed char *pid1, signed char *nnz8);
"""),
]

_lock = threading.Lock()
_lib = None
_ffi = None
_tried = False


_present_cache = None


def _present():
    # cached: called on every native-path availability check, and the
    # component set cannot change within a process lifetime
    global _present_cache
    if _present_cache is None:
        _present_cache = [(s, d) for (s, d) in _COMPONENTS
                          if (_HERE / s).exists()]
    return _present_cache


def _source_hash() -> str:
    h = hashlib.sha256()
    for s, d in _present():
        h.update(d.encode())
        h.update((_HERE / s).read_bytes())
    hdr = _HERE / "bitreader.h"
    if hdr.exists():
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _compile() -> str:
    import cffi
    ffibuilder = cffi.FFI()
    present = _present()
    ffibuilder.cdef("\n".join(d for _, d in present))
    source = "\n".join(f'#include "{s}"' for s, _ in present)
    modname = f"_libav_tpu_native_{_source_hash()}"
    ffibuilder.set_source(
        modname, source,
        include_dirs=[str(_HERE)],
        extra_compile_args=["-O3", "-fno-strict-aliasing",
                            "-march=native", "-funroll-loops"],
    )
    _BUILD.mkdir(exist_ok=True)
    ffibuilder.compile(tmpdir=str(_BUILD), verbose=False)
    return modname


def disabled() -> bool:
    """Whether LIBAV_TPU_NO_NATIVE asks for the Python paths. Read on
    every call: tests set it after the library has loaded, to run the
    H.264 decoder's Python twin."""
    return bool(os.environ.get("LIBAV_TPU_NO_NATIVE"))


def get_lib():
    global _lib, _ffi, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if disabled():
            return None
        modname = f"_libav_tpu_native_{_source_hash()}"
        sys.path.insert(0, str(_BUILD))
        try:
            mod = __import__(modname)
        except ImportError:
            try:
                # serialize concurrent builders across processes (bench
                # encode child, pytest workers) — a half-written .so from
                # a sibling process must not be imported
                _BUILD.mkdir(exist_ok=True)
                import fcntl
                with open(_BUILD / ".buildlock", "w") as lk:
                    fcntl.flock(lk, fcntl.LOCK_EX)
                    # importlib caches per-directory listings with 1s mtime
                    # granularity: a .so written after our first (failed)
                    # import attempt is invisible without this
                    import importlib
                    importlib.invalidate_caches()
                    try:
                        mod = __import__(modname)
                    except ImportError:
                        _compile()
                        importlib.invalidate_caches()
                        mod = __import__(modname)
            except Exception as e:  # pragma: no cover - no-compiler fallback
                sys.stderr.write(f"[libav_tpu_torch.native] build failed, using "
                                 f"Python paths: {e}\n")
                return None
        finally:
            sys.path.remove(str(_BUILD))
        _lib = mod.lib
        _ffi = mod.ffi
        return _lib


def get_ffi():
    get_lib()
    return _ffi
