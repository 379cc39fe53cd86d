"""Apple ProRes decoder (counterpart of `libav_tpu/codecs/prores/dec.py`;
reference: libavcodec/proresdec.c — frame atom parse :715, frame header
:99, picture header :217, slice entropy :301/:345/:374, slice recon :557).

Host, the JAX package's code, copied and changed only in its imports:
the frame/picture headers and the entropy decode of every slice's
rice/exp-Golomb DC+AC codewords into one (nblocks, 64) raster-order
coefficient array per plane, with each block's slice scale factor.

Device, on the decoder's torch device (`ProresDecoder(params,
device="cuda")` by default; "cpu" runs the same program on the CPU):
`ReconPlane` per plane — dequant, the 10-bit simple_idct
(ops/prores_dct.py prores_idct), bias/clip and the block scatter, the
JAX `_recon_plane_jit` program, in int32 (torch.uint16 has few CUDA
operations). An interlaced frame's two field pictures are woven there
too, and the finished planes are cast to uint16: the output frame stays
on the device, as the port's other video decoders leave theirs, and
`Frame.to_host` gives the uint16 planes of yuv422p10le/yuv444p10le.

Supports 422/444, progressive and interlaced (two pictures per frame,
woven fields). Alpha (4444 alpha_info != 0) is rejected with the JAX
decoder's error.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.ops.prores_dct import prores_idct
from libav_tpu_torch.codecs.prores.tables import (AC_CODEBOOK, DC_CODEBOOK,
                                            FIRST_DC_CB, FRAME_ID,
                                            INTERLACED_SCAN,
                                            LEV_TO_CB_INDEX,
                                            PROGRESSIVE_SCAN,
                                            RUN_TO_CB_INDEX)

MAX_PADDING = 16


def _w16(x: int) -> int:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def decode_vlc_codeword(gb: GetBits, codebook: int) -> int:
    """reference: proresdec.c:301 — adaptive rice/exp-Golomb codeword."""
    switch_bits = (codebook & 3) + 1
    rice_order = codebook >> 5
    exp_order = (codebook >> 2) & 7
    buf = gb.show_bits(32)
    log = 32 - buf.bit_length() if buf else 31   # 31 - av_log2(buf)
    if log < switch_bits:                     # rice
        if not rice_order:
            gb.skip_bits(log + 1)
            return log
        prefix_len = log + 1
        code = ((log << rice_order) +
                (((buf << prefix_len) & 0xFFFFFFFF) >> (32 - rice_order)))
        gb.skip_bits(prefix_len + rice_order)
        return code
    ln = (log << 1) - switch_bits + exp_order + 1
    if ln > 32:
        raise AVError(INVALIDDATA, "prores: oversized codeword")
    code = (buf >> (32 - ln)) - (1 << exp_order) + (switch_bits << rice_order)
    gb.skip_bits(ln)
    return code


def decode_dc_coeffs(gb: GetBits, out: np.ndarray, nblocks: int):
    """reference: proresdec.c:345 — DPCM DC chain with adaptive codebook.
    out: flat (nblocks*64,) int array, DCs land at block*64."""
    code = decode_vlc_codeword(gb, FIRST_DC_CB)
    prev_dc = _w16((code >> 1) ^ -(code & 1))
    out[0] = prev_dc
    delta = 3
    for i in range(1, nblocks):
        code = decode_vlc_codeword(gb, DC_CODEBOOK[min(abs(delta), 3)])
        sign = -(((delta >> 15) & 1) ^ (code & 1))
        delta = _w16((((code + 1) >> 1) ^ sign) - sign)
        prev_dc = _w16(prev_dc + delta)
        out[i * 64] = prev_dc


def decode_ac_coeffs(gb: GetBits, out: np.ndarray, blocks_per_slice: int,
                     plane_size_factor: int, scan: np.ndarray):
    """reference: proresdec.c:374 — interleaved run/level AC decode over
    all the slice's blocks at once (position-major), adaptive codebooks."""
    run, level = 4, 2
    max_coeffs = blocks_per_slice << 6
    block_mask = blocks_per_slice - 1
    pos = blocks_per_slice - 1
    while pos < max_coeffs:
        run_cb = AC_CODEBOOK[RUN_TO_CB_INDEX[min(run, 15)]]
        lev_cb = AC_CODEBOOK[LEV_TO_CB_INDEX[min(level, 9)]]
        bits_left = gb.bits_left()
        if bits_left <= 0 or (bits_left <= MAX_PADDING and
                              not gb.show_bits(bits_left)):
            return
        run = decode_vlc_codeword(gb, run_cb)
        bits_left = gb.bits_left()
        if bits_left <= 0 or (bits_left <= MAX_PADDING and
                              not gb.show_bits(bits_left)):
            raise AVError(INVALIDDATA, "prores: truncated AC data")
        level = decode_vlc_codeword(gb, lev_cb) + 1
        pos += run + 1
        if pos >= max_coeffs:
            break
        sign = -gb.get_bits(1)
        out[((pos & block_mask) << 6) +
            int(scan[pos >> plane_size_factor])] = (level ^ sign) - sign


def slice_layout(mb_width: int, mbs_per_slice: int):
    """(x_mb, width_mbs) per slice in one MB row — slice width halves at
    the right edge (proresdec.c:690-696 / proresenc.c:1020-1025)."""
    out = []
    sw = mbs_per_slice
    x = 0
    while x < mb_width:
        while mb_width - x < sw:
            sw >>= 1
        out.append((x, sw))
        x += sw
    return out


@functools.lru_cache(maxsize=32)
def _block_positions(mb_width: int, mb_height: int, mbs_per_slice: int,
                     chroma_422: bool, chroma: bool):
    """Per-decoded-block (by, bx) block coordinates for one picture plane,
    in slice/MB/block decode order (proresdec.c:452-480 block walks)."""
    by, bx = [], []
    row = slice_layout(mb_width, mbs_per_slice)
    for y in range(mb_height):
        for (x0, w) in row:
            for i in range(w):
                mx = x0 + i
                if chroma and chroma_422:
                    # 2 blocks per MB: top, bottom
                    by += [2 * y, 2 * y + 1]
                    bx += [mx, mx]
                elif chroma:
                    # 444 chroma: TL, BL, TR, BR (proresdec.c:468)
                    by += [2 * y, 2 * y + 1, 2 * y, 2 * y + 1]
                    bx += [2 * mx, 2 * mx, 2 * mx + 1, 2 * mx + 1]
                else:
                    # luma: TL, TR, BL, BR (proresdec.c:453)
                    by += [2 * y, 2 * y, 2 * y + 1, 2 * y + 1]
                    bx += [2 * mx, 2 * mx + 1, 2 * mx, 2 * mx + 1]
    return np.asarray(by, np.int32), np.asarray(bx, np.int32)


@functools.lru_cache(maxsize=32)
def _device_positions(mb_width: int, mb_height: int, mbs_per_slice: int,
                      chroma_422: bool, chroma: bool, device: torch.device):
    """_block_positions as int64 tensors on device, uploaded once."""
    return tuple(torch.tensor(a.astype(np.int64), device=device)
                 for a in _block_positions(mb_width, mb_height,
                                           mbs_per_slice, chroma_422,
                                           chroma))


class ReconPlane(nn.Module):
    """One program per plane: (N, 64) coefficients and each block's
    slice scale factor -> dequant (the 64-entry matrix times the factor,
    int16-wrapped like the reference's int16_t qmat_luma_scaled,
    proresdec.c:637) -> prores 10-bit IDCT -> bias/clip -> the (bh*8,
    bw*8) int32 plane, each block at its (by, bx) (replaces
    proresdec.c's per-slice idct_put loop; the JAX `_recon_plane_jit`)."""

    def __init__(self, bh: int, bw: int):
        super().__init__()
        self.bh, self.bw = bh, bw

    def forward(self, coeffs, qmat, sf, by, bx):
        qrows = ((qmat[None, :] * sf[:, None] + 0x8000) & 0xFFFF) - 0x8000
        pix = prores_idct(coeffs, qrows)             # (N, 8, 8) int32
        plane = torch.zeros((self.bh, self.bw, 8, 8), dtype=torch.int32,
                            device=coeffs.device)
        plane[by, bx] = pix
        return plane.permute(0, 2, 1, 3).reshape(self.bh * 8, self.bw * 8)


@register_codec
class ProresDecoder(Decoder):
    NAME = "prores"
    TYPE = MediaType.VIDEO
    LONG_NAME = "Apple ProRes (PyTorch reconstruction)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """ProresDecoder(params, options, device=...) — the planes of the
        output frames are uint16 tensors on `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._qmat_luma = np.full(64, 4, np.int64)
        self._qmat_chroma = np.full(64, 4, np.int64)

    def _decode(self, pkt: Packet) -> List[Frame]:
        buf = pkt.data
        if len(buf) < 28 or len(buf) < int.from_bytes(buf[:4], "big") or \
                int.from_bytes(buf[4:8], "big") != FRAME_ID:
            raise AVError(INVALIDDATA, "prores: invalid frame atom")
        buf = buf[8:]
        hdr = self._frame_header(buf)
        buf = buf[hdr["hdr_size"]:]
        interlaced = hdr["frame_type"] != 0
        w, h = hdr["width"], hdr["height"]
        scan = INTERLACED_SCAN if interlaced else PROGRESSIVE_SCAN
        npics = 2 if interlaced else 1
        fields = []
        for pic_num in range(npics):
            planes, pic_size = self._decode_picture(buf, hdr, scan, pic_num)
            fields.append(planes)
            buf = buf[pic_size:]
        cw = w if hdr["chroma_factor"] == 3 else (w + 1) >> 1
        out_planes = []
        for p in range(3):
            pw = w if p == 0 else cw
            if interlaced:
                # weave the two field pictures on the device
                # (proresdec.c:590-603: picture gets +linesize when
                # !(pic_num ^ top_field_first))
                tff = 1 if hdr["frame_type"] == 1 else 0
                plane = torch.zeros((h, pw), dtype=torch.int32,
                                    device=self.device)
                for pic_num in range(2):
                    off = 1 if (pic_num ^ tff) == 0 else 0
                    nrows = (h - off + 1) // 2
                    rows = fields[pic_num][p][:nrows, :pw]
                    plane[off::2][:rows.shape[0]] = rows
            else:
                plane = fields[0][p][:h, :pw]
            out_planes.append(plane.to(torch.uint16).contiguous())
        fmt = "yuv444p10le" if hdr["chroma_factor"] == 3 else "yuv422p10le"
        f = Frame(width=w, height=h, format=fmt,
                  pict_type=PictureType.I, key_frame=True,
                  interlaced_frame=interlaced,
                  top_field_first=hdr["frame_type"] == 1)
        f.planes = out_planes
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        return [f]

    # ------------------------------------------------------------------ #

    def _frame_header(self, buf: bytes) -> dict:
        """reference: proresdec.c:99 decode_frame_header."""
        hdr_size = int.from_bytes(buf[:2], "big")
        if hdr_size > len(buf) or hdr_size < 20:
            raise AVError(INVALIDDATA, "prores: frame header too small")
        version = int.from_bytes(buf[2:4], "big")
        if version >= 2:
            raise AVError(INVALIDDATA, f"prores: header version {version}")
        width = int.from_bytes(buf[8:10], "big")
        height = int.from_bytes(buf[10:12], "big")
        frame_type = (buf[12] >> 2) & 3
        if frame_type > 2:
            raise AVError(INVALIDDATA, f"prores: frame type {frame_type}")
        chroma_factor = (buf[12] >> 6) & 3
        if chroma_factor not in (2, 3):
            raise AVError(INVALIDDATA,
                          f"prores: picture format {chroma_factor}")
        alpha_info = buf[17] & 0xF
        if alpha_info:
            raise AVError(INVALIDDATA, "prores: alpha planes not supported")
        flags = buf[19]
        ptr = 20
        if flags & 2:
            if ptr > hdr_size - 64:
                raise AVError(INVALIDDATA, "prores: header data too small")
            self._qmat_luma = np.frombuffer(
                buf[ptr:ptr + 64], np.uint8).astype(np.int64)
            ptr += 64
        else:
            self._qmat_luma = np.full(64, 4, np.int64)
        if flags & 1:
            if ptr > hdr_size - 64:
                raise AVError(INVALIDDATA, "prores: header data too small")
            self._qmat_chroma = np.frombuffer(
                buf[ptr:ptr + 64], np.uint8).astype(np.int64)
        else:
            self._qmat_chroma = np.full(64, 4, np.int64)
        return {"hdr_size": hdr_size, "width": width, "height": height,
                "frame_type": frame_type, "chroma_factor": chroma_factor}

    def _decode_picture(self, buf: bytes, hdr: dict, scan: np.ndarray,
                        pic_num: int):
        """reference: proresdec.c:217 decode_picture_header + :557
        decode_slice over every slice, batched to the device per plane:
        -> (the three int32 planes on the device, picture data size)."""
        if not buf:
            raise AVError(INVALIDDATA, "prores: empty picture")
        hdr_size = buf[0] >> 3
        if hdr_size < 8 or hdr_size > len(buf):
            raise AVError(INVALIDDATA, "prores: picture header too small")
        pic_data_size = int.from_bytes(buf[1:5], "big")
        if pic_data_size > len(buf):
            raise AVError(INVALIDDATA, "prores: picture data too small")
        swf = buf[7] >> 4
        shf = buf[7] & 0xF
        if swf > 3 or shf:
            raise AVError(INVALIDDATA, "prores: slice dimensions")
        interlaced = hdr["frame_type"] != 0
        mb_w = (hdr["width"] + 15) >> 4
        mb_h = (hdr["height"] + (1 << (4 + interlaced)) - 1) >> (4 + interlaced)
        mps = 1 << swf
        row = slice_layout(mb_w, mps)
        num_slices = len(row) * mb_h
        if num_slices != int.from_bytes(buf[5:7], "big"):
            raise AVError(INVALIDDATA, "prores: invalid number of slices")
        if hdr_size + num_slices * 2 > len(buf):
            raise AVError(INVALIDDATA, "prores: slice table too small")
        sizes = np.frombuffer(buf[hdr_size:hdr_size + num_slices * 2],
                              ">u2").astype(np.int64)
        offs = hdr_size + num_slices * 2 + np.concatenate(
            ([0], np.cumsum(sizes)))
        if offs[-1] > len(buf):
            raise AVError(INVALIDDATA, "prores: out of slice data")

        chroma_422 = hdr["chroma_factor"] == 2
        cblocks_per_mb = 2 if chroma_422 else 4
        # per-plane coefficient tensors + per-block scaled qmat rows
        n_luma = mb_w * mb_h * 4
        n_chroma = mb_w * mb_h * cblocks_per_mb
        coeffs = [np.zeros(n_luma * 64, np.int16),
                  np.zeros(n_chroma * 64, np.int16),
                  np.zeros(n_chroma * 64, np.int16)]
        sfs = np.empty(num_slices, np.int64)
        fill = [0, 0, 0]
        si = 0
        for y in range(mb_h):
            for (x0, wmbs) in row:
                data = buf[offs[si]:offs[si + 1]]
                if len(data) < 6:
                    raise AVError(INVALIDDATA, "prores: slice too small")
                shdr = data[0] >> 3
                y_size = int.from_bytes(data[2:4], "big")
                u_size = int.from_bytes(data[4:6], "big")
                if shdr > 7:
                    v_size = int.from_bytes(data[6:8], "big")
                else:
                    v_size = len(data) - shdr - y_size - u_size
                if v_size < 0 or shdr < 6 or \
                        shdr + y_size + u_size + v_size > len(data):
                    raise AVError(INVALIDDATA, "prores: slice sizes")
                sf = min(max(data[1], 1), 224)
                sfs[si] = (sf - 96) << 2 if sf > 128 else sf
                swf_s = wmbs.bit_length() - 1
                pos = shdr
                for p, psize in ((0, y_size), (1, u_size), (2, v_size)):
                    nb_mb = 4 if p == 0 else cblocks_per_mb
                    nb = wmbs * nb_mb
                    psf = swf_s + (2 if p == 0 else
                                   hdr["chroma_factor"] - 1)
                    gb = GetBits(data[pos:pos + psize])
                    view = coeffs[p][fill[p]:fill[p] + nb * 64]
                    decode_dc_coeffs(gb, view, nb)
                    decode_ac_coeffs(gb, view, nb, psf, scan)
                    fill[p] += nb * 64
                    pos += psize
                si += 1

        # per-block slice index -> slice scale factor (ReconPlane scales
        # the matrix by it on the device)
        blocks_per_slice_l = np.array([w * 4 for _ in range(mb_h)
                                       for (_, w) in row], np.int64)
        blocks_per_slice_c = np.array([w * cblocks_per_mb
                                       for _ in range(mb_h)
                                       for (_, w) in row], np.int64)
        sf_l = np.repeat(sfs, blocks_per_slice_l)
        sf_c = np.repeat(sfs, blocks_per_slice_c)

        planes = []
        for p in range(3):
            qmat = self._qmat_luma if p == 0 else self._qmat_chroma
            sf = sf_l if p == 0 else sf_c
            by, bx = _device_positions(mb_w, mb_h, mps, chroma_422, p > 0,
                                       self.device)
            bh = mb_h * 2
            bw = mb_w * 2 if (p == 0 or not chroma_422) else mb_w
            n = n_luma if p == 0 else n_chroma
            planes.append(ReconPlane(bh, bw)(
                torch.tensor(coeffs[p].reshape(n, 64), device=self.device),
                torch.tensor(qmat.astype(np.int32), device=self.device),
                torch.tensor(sf.astype(np.int32), device=self.device),
                by, bx))
        return planes, pic_data_size
