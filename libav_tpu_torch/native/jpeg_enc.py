"""Loader/adapter for the native JPEG scan packer (native/jpeg_enc.c)."""

from __future__ import annotations

import numpy as np


def available() -> bool:
    from libav_tpu_torch.native.build import get_lib, _present
    if not any(s == "jpeg_enc.c" for s, _ in _present()):
        return False
    return get_lib() is not None


def encode_scan(levels, comp_dims, sampling, dc_tabs, ac_tabs,
                mcus_x, mcus_y):
    """Pack all MCUs; returns unstuffed scan bytes or None on failure.
    Must be bit-identical to MJPEGEncoder._encode_scan_py."""
    from libav_tpu_torch.native.build import get_lib, get_ffi
    lib = get_lib()
    if lib is None:
        return None
    ffi = get_ffi()

    n_comp = len(sampling)
    comp_meta = np.zeros((n_comp, 4), dtype=np.int32)
    lv_ptrs = []
    keep = []
    dc_c, dc_s, ac_c, ac_s = [], [], [], []
    for ci, (h, v) in enumerate(sampling):
        bh, bw = comp_dims[ci]
        comp_meta[ci] = (h, v, bw, bh)
        arr = np.ascontiguousarray(levels[ci], dtype=np.int16)
        keep.append(arr)
        lv_ptrs.append(ffi.cast("const short*", ffi.from_buffer(arr)))
        t = 0 if ci == 0 else 1
        for tab, lst, ct in ((dc_tabs[t][0], dc_c, "const unsigned int*"),
                             (dc_tabs[t][1], dc_s, "const unsigned char*"),
                             (ac_tabs[t][0], ac_c, "const unsigned int*"),
                             (ac_tabs[t][1], ac_s, "const unsigned char*")):
            a = np.ascontiguousarray(tab)
            keep.append(a)
            lst.append(ffi.cast(ct, ffi.from_buffer(a)))

    # worst case ~ 16 bits per coefficient
    cap = sum(l.size for l in levels) * 4 + 65536
    out_buf = ffi.new(f"unsigned char[{cap}]")
    out_len = ffi.new("long long*")

    rc = lib.jpeg_encode_scan(
        ffi.new("const short*[]", lv_ptrs),
        ffi.cast("const int*", ffi.from_buffer(comp_meta)), n_comp,
        ffi.new("const unsigned int*[]", dc_c),
        ffi.new("const unsigned char*[]", dc_s),
        ffi.new("const unsigned int*[]", ac_c),
        ffi.new("const unsigned char*[]", ac_s),
        mcus_x, mcus_y, out_buf, cap, out_len)
    if rc != 0:
        return None
    return bytes(ffi.buffer(out_buf, out_len[0]))
