"""Baseline JPEG / MJPEG encoder (counterpart of
`libav_tpu/codecs/mjpeg/enc.py`; reference: libavcodec/mjpegenc.c +
ljpegenc shared header writer mjpegenc_common).

Device, on the encoder's torch device (`MJPEGEncoder(params,
device="cuda")` by default; "cpu" runs the same program on the CPU):
each plane is uploaded (numpy) or moved (tensor) there, edge-padded to
whole blocks, blockified, level shifted, through the exact integer FDCT
(ops/fdct.py), quantised (ops/quant.py jpeg_quant) and put in zigzag
order: `EncodePlane`, the JAX `_encode_plane_jit` program. The levels
come to the host once per plane, as int16.

Host, the JAX package's code, copied and changed only in its imports:
the MCU-ordered Huffman pack with the Annex K tables and the marker
writing, through the C packer (native/jpeg_enc.c) when it builds and the
Python loop otherwise. `packer` records which of the two packed the last
frame ("native" or "python").
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.bitstream.vlc import build_huffman_codes
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.mjpeg import tables as T
from libav_tpu_torch.ops import fdct
from libav_tpu_torch.ops.quant import jpeg_quant, zigzag_scan


def huff_code_table(bits: List[int], values: List[int], size: int = 256):
    """(bits, values) -> (codes[sym], sizes[sym]) arrays for encoding."""
    codes = build_huffman_codes(bits)
    lengths = []
    for ln, c in enumerate(bits, 1):
        lengths += [ln] * c
    code_arr = np.zeros(size, dtype=np.uint32)
    size_arr = np.zeros(size, dtype=np.uint8)
    for code, ln, sym in zip(codes, lengths, values):
        code_arr[sym] = code
        size_arr[sym] = ln
    return code_arr, size_arr


def _csize(v: int) -> int:
    """JPEG category (number of magnitude bits) of a value."""
    return int(abs(v)).bit_length()


_SAMPLING = {
    "yuvj420p": [(2, 2), (1, 1), (1, 1)],
    "yuv420p": [(2, 2), (1, 1), (1, 1)],
    "yuvj422p": [(2, 1), (1, 1), (1, 1)],
    "yuv422p": [(2, 1), (1, 1), (1, 1)],
    "yuvj444p": [(1, 1), (1, 1), (1, 1)],
    "yuv444p": [(1, 1), (1, 1), (1, 1)],
    "gray": [(1, 1)],
}


@register_codec
class MJPEGEncoder(Encoder):
    NAME = "mjpeg"
    TYPE = MediaType.VIDEO
    LONG_NAME = "Motion JPEG (PyTorch FDCT/quant)"

    OPTIONS = Encoder.OPTIONS + [
        Option("quality", "JPEG quality 1-100", "int", 90, 1, 100),
        Option("qscale", "mpeg-style qscale 1-31 (overrides quality)",
               "int", 0, 0, 31),
    ]

    DEVICE_PART = True

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MJPEGEncoder(params, options, device=...): the plane program
        runs on `device`; frames may hold numpy arrays or tensors."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)
        self.packer = None

    def _init(self):
        q = self.quality
        if self.qscale:
            # map qscale 1..31 -> IJG quality, same spirit as the
            # reference's ff_convert_matrix qscale scaling
            q = max(2, min(97, int(round(100 - (self.qscale - 1) * 97 / 30))))
        self.qmat = [T.scale_quant_table(T.STD_LUMINANCE_QUANT, q),
                     T.scale_quant_table(T.STD_CHROMINANCE_QUANT, q)]
        self.dc_tabs = [huff_code_table(*T.STD_DC_LUMINANCE, 16),
                        huff_code_table(*T.STD_DC_CHROMINANCE, 16)]
        self.ac_tabs = [huff_code_table(*T.STD_AC_LUMINANCE, 256),
                        huff_code_table(*T.STD_AC_CHROMINANCE, 256)]
        self._qmat_dev = [torch.as_tensor(m.astype(np.int32)).to(self.device)
                          for m in self.qmat]

    def _upload(self, plane) -> torch.Tensor:
        """A plane (numpy or tensor) as a uint8 tensor on the device."""
        if not isinstance(plane, torch.Tensor):
            plane = torch.as_tensor(np.ascontiguousarray(plane))
        return plane.to(self.device)

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        fmt = frame.format
        if fmt not in _SAMPLING:
            raise AVError(EINVAL, f"mjpeg encoder: unsupported pix_fmt {fmt}")
        sampling = _SAMPLING[fmt]
        hmax = max(h for h, v in sampling)
        vmax = max(v for h, v in sampling)
        mcus_x = (frame.width + 8 * hmax - 1) // (8 * hmax)
        mcus_y = (frame.height + 8 * vmax - 1) // (8 * vmax)

        levels = []       # per comp: (bh*bw, 64) int zigzag-order levels
        comp_dims = []    # per comp: (bh, bw)
        for ci, (h, v) in enumerate(sampling):
            bw, bh = mcus_x * h, mcus_y * v
            tabidx = 0 if ci == 0 else 1
            lv = encode_plane(bh, bw, device=self.device)(
                _pad_plane(self._upload(frame.planes[ci]), bh * 8, bw * 8),
                self._qmat_dev[tabidx])
            levels.append(lv.to(torch.int16).cpu().numpy())
            comp_dims.append((bh, bw))

        data = self._pack(levels, comp_dims, sampling, frame.width,
                          frame.height, mcus_x, mcus_y)
        pkt = Packet(data=data, pts=frame.pts, dts=frame.pts,
                     flags=PKT_FLAG_KEY, time_base=frame.time_base)
        return [pkt]

    # ------------------------------------------------------------------ #

    def _pack(self, levels, comp_dims, sampling, width, height,
              mcus_x, mcus_y) -> bytes:
        out = bytearray()
        out += b"\xFF\xD8"                         # SOI
        # JFIF APP0
        app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        out += b"\xFF\xE0" + (len(app0) + 2).to_bytes(2, "big") + app0
        # DQT (zigzag order on the wire)
        zz = zigzag_scan()
        for ti in range(min(2, len(sampling))):
            body = bytes([ti]) + bytes(int(self.qmat[ti][z]) for z in zz)
            out += b"\xFF\xDB" + (len(body) + 2).to_bytes(2, "big") + body
        # SOF0
        sof = bytearray([8])
        sof += height.to_bytes(2, "big") + width.to_bytes(2, "big")
        sof.append(len(sampling))
        for ci, (h, v) in enumerate(sampling):
            sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
        out += b"\xFF\xC0" + (len(sof) + 2).to_bytes(2, "big") + bytes(sof)
        # DHT x4 (or x2 for gray)
        hts = [(0, 0, T.STD_DC_LUMINANCE), (1, 0, T.STD_AC_LUMINANCE)]
        if len(sampling) > 1:
            hts += [(0, 1, T.STD_DC_CHROMINANCE), (1, 1, T.STD_AC_CHROMINANCE)]
        for tc, th, (bits, vals) in hts:
            body = bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals)
            out += b"\xFF\xC4" + (len(body) + 2).to_bytes(2, "big") + body
        # SOS
        sos = bytearray([len(sampling)])
        for ci in range(len(sampling)):
            t = 0 if ci == 0 else 1
            sos += bytes([ci + 1, (t << 4) | t])
        sos += bytes([0, 63, 0])
        out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + bytes(sos)
        # entropy-coded scan
        scan = self._encode_scan(levels, comp_dims, sampling, mcus_x, mcus_y)
        out += scan
        out += b"\xFF\xD9"                         # EOI
        return bytes(out)

    def _encode_scan(self, levels, comp_dims, sampling, mcus_x, mcus_y) -> bytes:
        from libav_tpu_torch.native import jpeg_enc as native
        raw = None
        if native.available():
            raw = native.encode_scan(levels, comp_dims, sampling,
                                     self.dc_tabs, self.ac_tabs,
                                     mcus_x, mcus_y)
        self.packer = "native" if raw is not None else "python"
        if raw is None:
            raw = self._encode_scan_py(levels, comp_dims, sampling,
                                       mcus_x, mcus_y)
        # byte stuffing
        return raw.replace(b"\xFF", b"\xFF\x00")

    def _encode_scan_py(self, levels, comp_dims, sampling, mcus_x, mcus_y) -> bytes:
        pb = PutBits()
        dc_pred = [0] * len(sampling)
        for my in range(mcus_y):
            for mx in range(mcus_x):
                for ci, (h, v) in enumerate(sampling):
                    bh, bw = comp_dims[ci]
                    t = 0 if ci == 0 else 1
                    dct_c, dct_s = self.dc_tabs[t]
                    act_c, act_s = self.ac_tabs[t]
                    for bv in range(v):
                        for bhx in range(h):
                            bx, by = mx * h + bhx, my * v + bv
                            blk = levels[ci][by * bw + bx]
                            dc_pred[ci] = self._put_block(
                                pb, blk, dc_pred[ci],
                                dct_c, dct_s, act_c, act_s)
        pb.align(pad_bit=1)
        return pb.flush()

    @staticmethod
    def _put_block(pb, blk, dc_pred, dct_c, dct_s, act_c, act_s) -> int:
        dc = int(blk[0])
        diff = dc - dc_pred
        sz = _csize(diff)
        pb.put_bits(int(dct_s[sz]), int(dct_c[sz]))
        if sz:
            pb.put_bits(sz, diff & ((1 << sz) - 1) if diff >= 0 else (diff + (1 << sz) - 1))
        run = 0
        for k in range(1, 64):
            val = int(blk[k])
            if val == 0:
                run += 1
                continue
            while run > 15:
                pb.put_bits(int(act_s[0xF0]), int(act_c[0xF0]))  # ZRL
                run -= 16
            sz = _csize(val)
            sym = (run << 4) | sz
            pb.put_bits(int(act_s[sym]), int(act_c[sym]))
            pb.put_bits(sz, val & ((1 << sz) - 1) if val >= 0 else (val + (1 << sz) - 1))
            run = 0
        if run:
            pb.put_bits(int(act_s[0]), int(act_c[0]))  # EOB
        return dc


def _pad_plane(plane: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Edge-replicate pad to coded size (reference: encoders pad with edge
    pixels to avoid ringing — mpegvideoencdsp draw_edges), as an index
    gather on the plane's device: replicate padding takes no uint8 on
    CUDA."""
    h, w = plane.shape
    if h == H and w == W:
        return plane
    rows = torch.arange(H, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(W, device=plane.device).clamp_(max=w - 1)
    return plane[rows[:, None], cols[None, :]]


class EncodePlane(nn.Module):
    """The JAX _encode_plane_jit program: (H, W) uint8 plane + (64,)
    raster qmat -> (nb, 64) int32 zigzag quantized levels."""

    def __init__(self, blocks_h: int, blocks_w: int):
        super().__init__()
        self.blocks_h, self.blocks_w = blocks_h, blocks_w
        self.register_buffer("zz", torch.as_tensor(
            zigzag_scan().astype(np.int64)))

    def forward(self, plane, qmat_raster):
        bh, bw = self.blocks_h, self.blocks_w
        blocks = (plane.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3)
                  .reshape(bh * bw, 8, 8))
        resid = blocks.to(torch.int32) - 128
        coeffs = fdct.fdct8x8_int(resid)                     # x8 scale
        q8 = qmat_raster.to(torch.int32) * fdct.FDCT_OUT_SCALE
        lv = jpeg_quant(coeffs.reshape(-1, 64), q8)
        return lv[:, self.zz]                                 # zigzag order


@functools.lru_cache(maxsize=64)
def encode_plane(blocks_h: int, blocks_w: int, *,
                 device: torch.device) -> EncodePlane:
    """_encode_plane_jit's key plus the device -> the module on device."""
    return EncodePlane(blocks_h, blocks_w).to(device)
