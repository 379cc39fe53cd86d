"""Apple ProRes encoder (counterpart of `libav_tpu/codecs/prores/enc.py`;
reference: libavcodec/proresenc.c — the Kostya encoder: encode_frame
:928, find_slice_quant trellis :748, encode_slice :504, encode_dcs/acs
:359/:385, estimate_* :581-686).

Byte-exactness contract: for the same options the produced stream is
byte-identical to the JAX encoder's — the whole pipeline is
deterministic integer math: jfdctint-10 FDCT, truncating quant division,
exact rice/exp-Golomb bit estimates and a deterministic per-row trellis
over slice quantisers.

Device, on the encoder's torch device (`ProresEncoder(params,
device="cuda")` by default; "cpu" runs the same program on the CPU):
`FdctPlane` per plane — the plane is uploaded (numpy) or moved (tensor)
there, edge-padded to whole macroblocks, cut into 8x8 blocks and put
through ff_jpeg_fdct_islow_10 (ops/prores_dct.py fdct10); the
coefficients come to the host once per plane.

Host, the JAX package's code, copied and changed only in its imports:
the trellis over slice quantisers and the VLC packing (serial bit
chains).

Progressive 422/444 (yuv422p10le/yuv444p10le), no alpha."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.prores.dec import slice_layout
from libav_tpu_torch.ops.prores_dct import fdct10
from libav_tpu_torch.codecs.prores.tables import (AC_CODEBOOK, DC_CODEBOOK,
                                            FIRST_DC_CB, FRAME_ID,
                                            LEV_TO_CB_INDEX, MB_LIMITS,
                                            PROFILES, PROGRESSIVE_SCAN,
                                            QUANT_MATRICES,
                                            RUN_TO_CB_INDEX)

SCORE_LIMIT = (1 << 31) // 2 - 1       # INT_MAX / 2
MAX_STORED_Q = 16
TRELLIS_WIDTH = 16


def _w16(x):
    return ((np.asarray(x).astype(np.int64) + 0x8000) & 0xFFFF) - 0x8000


def _trunc_div(a, b):
    """C integer division (truncates toward zero); b > 0."""
    a = np.asarray(a, np.int64)
    return np.sign(a) * (np.abs(a) // b)


def encode_vlc_codeword(pb: PutBits, codebook: int, val: int):
    """reference: proresenc.c:327."""
    switch_bits = (codebook & 3) + 1
    rice_order = codebook >> 5
    exp_order = (codebook >> 2) & 7
    switch_val = switch_bits << rice_order
    if val >= switch_val:
        val -= switch_val - (1 << exp_order)
        exponent = val.bit_length() - 1
        pb.put_bits(exponent - exp_order + switch_bits, 0)
        pb.put_bits(exponent + 1, val)
    else:
        exponent = val >> rice_order
        if exponent:
            pb.put_bits(exponent, 0)
        pb.put_bits(1, 1)
        if rice_order:
            pb.put_bits(rice_order, val & ((1 << rice_order) - 1))


def estimate_vlc(codebook: int, val: int) -> int:
    """reference: proresenc.c:581."""
    switch_bits = (codebook & 3) + 1
    rice_order = codebook >> 5
    exp_order = (codebook >> 2) & 7
    switch_val = switch_bits << rice_order
    if val >= switch_val:
        val -= switch_val - (1 << exp_order)
        exponent = val.bit_length() - 1
        return exponent * 2 - exp_order + switch_bits + 1
    return (val >> rice_order) + rice_order + 1


def make_code(v: int) -> int:
    """MAKE_CODE (proresenc.c:357): (x << 1) ^ (x >> 31) zigzag."""
    return (v << 1) ^ (-1 if v < 0 else 0)


def _dc_chain(dcs):
    """The adaptive DC codebook walk shared by estimate_dcs/encode_dcs:
    yields (codebook, code) per block given the quantized DC sequence."""
    out = [(FIRST_DC_CB, make_code(int(dcs[0])))]
    sign = 0
    codebook = 3
    prev_dc = int(dcs[0])
    for i in range(1, len(dcs)):
        dc = int(dcs[i])
        delta = dc - prev_dc
        new_sign = -1 if delta < 0 else 0
        delta = (delta ^ sign) - sign
        code = make_code(delta)
        out.append((DC_CODEBOOK[codebook], code))
        codebook = min((code + (code & 1)) >> 1, 3)
        sign = new_sign
        prev_dc = dc
    return out


def _ac_runlevels(blocks: np.ndarray, qmat: np.ndarray, scan: np.ndarray):
    """Quantize in scan order and extract the position-major (run,
    abs_level, sign) sequence + the total abs-remainder error — the
    vectorized core both estimate_acs and encode_acs walk.
    blocks: (nb, 64) int; qmat (64,) int."""
    sc = scan[1:]
    sub = blocks[:, sc]                                   # (nb, 63)
    qv = qmat[sc]
    lv = _trunc_div(sub, qv[None, :])
    err = int(np.abs(sub).__mod__(qv[None, :]).sum())
    seq = lv.T.reshape(-1)                                # position-major
    nz = np.flatnonzero(seq)
    levels = seq[nz]
    prev = np.concatenate(([-1], nz[:-1]))
    runs = (nz - prev - 1).astype(np.int64)
    return runs, np.abs(levels).astype(np.int64), \
        (levels < 0).astype(np.int64), err


def _ac_walk_bits(runs, absl) -> int:
    """Adaptive-codebook AC bit count (estimate_acs without the writes)."""
    run_cb = RUN_TO_CB_INDEX[4]
    lev_cb = LEV_TO_CB_INDEX[2]
    bits = 0
    for r, al in zip(runs.tolist(), absl.tolist()):
        bits += estimate_vlc(AC_CODEBOOK[run_cb], r)
        bits += estimate_vlc(AC_CODEBOOK[lev_cb], al - 1) + 1
        run_cb = RUN_TO_CB_INDEX[min(r, 15)]
        lev_cb = LEV_TO_CB_INDEX[min(al, 9)]
    return bits


def _estimate_slice_plane(blocks, qmat, scan):
    """reference: proresenc.c:670 estimate_slice_plane -> (bits, error).
    Mirrors the reference's DC error quirk exactly: block 0's DC remainder
    is never counted and block 1's is counted twice (proresenc.c:615)."""
    scale = int(qmat[0])
    dcs_raw = blocks[:, 0].astype(np.int64) - 0x4000
    dcs = _trunc_div(dcs_raw, scale)
    bits = 0
    for cb, code in _dc_chain(dcs):
        bits += estimate_vlc(cb, code)
    err = int(abs(int(dcs_raw[1])) % scale)
    err += int(np.abs(dcs_raw[1:]).__mod__(scale).sum())
    runs, absl, _, ac_err = _ac_runlevels(blocks, qmat, scan)
    bits += _ac_walk_bits(runs, absl)
    return (bits + 7) & ~7, err + ac_err


def _encode_slice_plane(pb: PutBits, blocks, qmat, scan):
    """reference: proresenc.c:419 encode_slice_plane (DC + AC chains)."""
    scale = int(qmat[0])
    dcs = _trunc_div(blocks[:, 0].astype(np.int64) - 0x4000, scale)
    for cb, code in _dc_chain(dcs):
        encode_vlc_codeword(pb, cb, code)
    runs, absl, signs, _ = _ac_runlevels(blocks, qmat, scan)
    run_cb = RUN_TO_CB_INDEX[4]
    lev_cb = LEV_TO_CB_INDEX[2]
    for r, al, sg in zip(runs.tolist(), absl.tolist(), signs.tolist()):
        encode_vlc_codeword(pb, AC_CODEBOOK[run_cb], r)
        encode_vlc_codeword(pb, AC_CODEBOOK[lev_cb], al - 1)
        pb.put_bits(1, sg)
        run_cb = RUN_TO_CB_INDEX[min(r, 15)]
        lev_cb = LEV_TO_CB_INDEX[min(al, 9)]


class FdctPlane(nn.Module):
    """One program per plane: an (h, w) plane -> edge replication to
    (ph, pw), identical pixels to the reference's per-slice emu_buf fill
    (proresenc.c:241-264) -> (ph/8 * pw/8, 8, 8) blocks in raster block
    order -> fdct10 -> (ph/8, pw/8, 64) int32 coefficients (the JAX
    encoder's padding, blocking and `_fdct_jit`)."""

    def __init__(self, ph: int, pw: int):
        super().__init__()
        self.ph, self.pw = ph, pw

    def forward(self, plane):
        h, w = plane.shape
        dev = plane.device
        rows = torch.arange(self.ph, device=dev).clamp_(max=h - 1)
        cols = torch.arange(self.pw, device=dev).clamp_(max=w - 1)
        arr = plane.to(torch.int32)[rows][:, cols]
        bh, bw = self.ph // 8, self.pw // 8
        blocks = (arr.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3)
                  .reshape(bh * bw, 8, 8))
        return fdct10(blocks).reshape(bh, bw, 64)


@register_codec
class ProresEncoder(Encoder):
    NAME = "prores"
    TYPE = MediaType.VIDEO
    LONG_NAME = "Apple ProRes (iCodec Pro)"
    DEVICE_PART = True

    OPTIONS = Encoder.OPTIONS + [
        Option("profile", "proxy/lt/standard/hq/4444", "string", "standard"),
        Option("mbs_per_slice", "macroblocks per slice", "int", 8, 1, 8),
        Option("vendor", "vendor ID", "string", "Lavc"),
        Option("bits_per_mb", "desired bits per macroblock", "int",
               0, 0, 8192),
        Option("qscale", "force quantiser (0 = rate-controlled)", "int",
               0, 0, 64),
        Option("color_primaries", "frame header colour primaries", "int",
               2, 0, 255),
        Option("color_trc", "frame header transfer", "int", 2, 0, 255),
        Option("colorspace", "frame header matrix", "int", 2, 0, 255),
    ]

    def __init__(self, params=None, options=None, *, device="cuda"):
        """ProresEncoder(params, options, device=...): the FDCT program
        runs on `device`; frames may hold numpy arrays or tensors."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        prof = self.profile
        if prof not in PROFILES:
            raise AVError(EINVAL, f"prores: unknown profile {prof}")
        (self.tag, self.min_quant, self.max_quant, self.br_tab,
         qidx) = PROFILES[prof]
        self.quant_mat = QUANT_MATRICES[qidx]
        self.mbs_per_slice = int(self.mbs_per_slice)
        if self.mbs_per_slice & (self.mbs_per_slice - 1):
            raise AVError(EINVAL, "prores: mbs_per_slice must be a power "
                                  "of two")
        if len(self.vendor) != 4:
            raise AVError(EINVAL, "prores: vendor ID should be 4 bytes")
        self.force_quant = int(self.qscale)
        self.scan = PROGRESSIVE_SCAN
        self.params.codec_tag = self.tag      # mov stsd entry fourcc
        self._ready = False

    def _setup(self, frame: Frame):
        w, h = frame.width, frame.height
        fmt = frame.format
        if fmt == "yuv422p10le" and self.profile != "4444":
            self.chroma_factor = 2
        elif fmt == "yuv444p10le":
            self.chroma_factor = 3
        else:
            raise AVError(EINVAL, f"prores: pixel format {fmt} does not "
                                  f"fit profile {self.profile}")
        self.mb_width = (w + 15) >> 4
        self.mb_height = (h + 15) >> 4
        self.row = slice_layout(self.mb_width, self.mbs_per_slice)
        self.slices_width = len(self.row)
        self.slices_per_picture = self.mb_height * self.slices_width
        if self.force_quant:
            if self.force_quant > 64:
                raise AVError(EINVAL, "prores: quantiser maximum is 64")
            self.quants = {0: _w16(self.quant_mat * self.force_quant
                                   ).astype(np.int64)}
        else:
            bpm = int(self.bits_per_mb)
            if not bpm:
                i = 0
                for i in range(len(MB_LIMITS) - 1):
                    if MB_LIMITS[i] >= self.mb_width * self.mb_height:
                        break
                else:
                    i = len(MB_LIMITS) - 1
                bpm = self.br_tab[i]
            elif bpm < 128:
                raise AVError(EINVAL, "prores: at least 128 bits per MB")
            self.bits_per_mb = bpm
            self.quants = {q: _w16(self.quant_mat * q).astype(np.int64)
                           for q in range(self.min_quant, MAX_STORED_Q)}
        self._ready = True

    # ------------------------------------------------------------------ #

    def _slice_blocks(self, fdct, p: int, y: int, x0: int, wmbs: int):
        """The (nblocks, 64) jfdct coefficients of one slice plane, in the
        decode block order (fdct: per-plane (BH, BW, 64) block grid)."""
        if p == 0 or self.chroma_factor == 3:
            bs = []
            for i in range(wmbs):
                mx = x0 + i
                if p == 0:
                    bs += [(2 * y, 2 * mx), (2 * y, 2 * mx + 1),
                           (2 * y + 1, 2 * mx), (2 * y + 1, 2 * mx + 1)]
                else:   # 444 chroma order: TL, BL, TR, BR
                    bs += [(2 * y, 2 * mx), (2 * y + 1, 2 * mx),
                           (2 * y, 2 * mx + 1), (2 * y + 1, 2 * mx + 1)]
        else:           # 422 chroma: top, bottom per MB
            bs = []
            for i in range(wmbs):
                bs += [(2 * y, x0 + i), (2 * y + 1, x0 + i)]
        ys = np.array([b[0] for b in bs])
        xs = np.array([b[1] for b in bs])
        return fdct[ys, xs]

    def _encode(self, frame: Frame) -> List[Packet]:
        if not self._ready:
            self._setup(frame)
        # pad planes to MB-aligned dims with edge replication, block and
        # transform them on the device: ONE FdctPlane program per plane,
        # its coefficients downloaded once
        fdcts = []
        for p in range(3):
            plane = frame.planes[p]
            if not isinstance(plane, torch.Tensor):
                plane = torch.as_tensor(np.ascontiguousarray(plane))
            ph = self.mb_height * 16
            pw = self.mb_width * 16 if (p == 0 or self.chroma_factor == 3) \
                else self.mb_width * 8
            out = FdctPlane(ph, pw)(plane.to(self.device))
            fdcts.append(out.cpu().numpy().astype(np.int64))

        if self.force_quant:
            slice_q = np.full(self.slices_per_picture, self.force_quant,
                              np.int64)
        else:
            slice_q = self._find_quants(fdcts)

        return [self._pack_frame(frame, fdcts, slice_q)]

    # ------------------------------------------------------------------ #

    def _slice_estimate(self, fdcts, y, x0, wmbs, qmat):
        bits = 0
        error = 0
        for p in range(3):
            blocks = self._slice_blocks(fdcts[p], p, y, x0, wmbs)
            b, e = _estimate_slice_plane(blocks, qmat, self.scan)
            bits += b
            error += e
        return bits, error

    def _find_quants(self, fdcts) -> np.ndarray:
        """reference: proresenc.c:748 find_slice_quant + :904
        find_quant_thread — per-MB-row trellis over slice quantisers."""
        minq, maxq = self.min_quant, self.max_quant
        slice_q = np.empty(self.slices_per_picture, np.int64)
        n_nodes = (self.slices_width + 1) * TRELLIS_WIDTH
        for y in range(self.mb_height):
            prev_node = np.full(n_nodes, -1, np.int64)
            quant = np.zeros(n_nodes, np.int64)
            nbits = np.zeros(n_nodes, np.int64)
            score = np.zeros(n_nodes, np.int64)
            for q in range(minq, maxq + 2):
                quant[q] = q
            pq = 0
            for mb, (x0, wmbs) in enumerate(self.row):
                tn = (mb + 1) * TRELLIS_WIDTH
                slice_bits = {}
                slice_score = {}
                for q in range(minq, maxq + 2):
                    prev_node[tn + q] = -1
                    quant[tn + q] = q
                for q in range(minq, maxq + 1):
                    bits, error = self._slice_estimate(
                        fdcts, y, x0, wmbs, self.quants[q])
                    if bits > 65000 * 8:
                        error = SCORE_LIMIT
                    slice_bits[q] = bits
                    slice_score[q] = error
                if slice_bits[maxq] <= self.bits_per_mb * wmbs:
                    slice_bits[maxq + 1] = slice_bits[maxq]
                    slice_score[maxq + 1] = slice_score[maxq] + 1
                    overquant = maxq
                else:
                    for q in range(maxq + 1, 128):
                        qmat = (self.quants[q] if q < MAX_STORED_Q else
                                _w16(self.quant_mat * q).astype(np.int64))
                        bits, error = self._slice_estimate(
                            fdcts, y, x0, wmbs, qmat)
                        if bits <= self.bits_per_mb * wmbs:
                            break
                    else:
                        q = 128   # the C's for-loop exit value
                    slice_bits[maxq + 1] = bits
                    slice_score[maxq + 1] = error
                    overquant = q
                quant[tn + maxq + 1] = overquant
                bits_limit = (x0 + wmbs) * self.bits_per_mb
                for ppq in range(minq, maxq + 2):
                    prev = tn - TRELLIS_WIDTH + ppq
                    for q in range(minq, maxq + 2):
                        cur = tn + q
                        bits = nbits[prev] + slice_bits[q]
                        error = slice_score[q]
                        if bits > bits_limit:
                            error = SCORE_LIMIT
                        if score[prev] < SCORE_LIMIT and error < SCORE_LIMIT:
                            new_score = score[prev] + error
                        else:
                            new_score = SCORE_LIMIT
                        if prev_node[cur] == -1 or score[cur] >= new_score:
                            nbits[cur] = bits
                            score[cur] = new_score
                            prev_node[cur] = prev
                err = score[tn + minq]
                pq = tn + minq
                for q in range(minq + 1, maxq + 2):
                    if score[tn + q] <= err:
                        err = score[tn + q]
                        pq = tn + q
            q = pq
            for x in range(self.slices_width - 1, -1, -1):
                slice_q[x + y * self.slices_width] = quant[q]
                q = prev_node[q]
        return slice_q

    def _pack_frame(self, frame: Frame, fdcts, slice_q) -> Packet:
        """reference: proresenc.c:928 encode_frame byte layout."""
        out = bytearray()
        out += b"\x00\x00\x00\x00"                 # frame size backpatch
        out += FRAME_ID.to_bytes(4, "big")
        hdr_start = len(out)
        out += b"\x00\x00"                          # frame header size
        out += (0).to_bytes(2, "big")               # version
        out += self.vendor.encode("latin1")
        out += frame.width.to_bytes(2, "big")
        out += frame.height.to_bytes(2, "big")
        out += bytes([self.chroma_factor << 6])     # progressive
        out += bytes([0])
        out += bytes([int(self.color_primaries)])
        out += bytes([int(self.color_trc)])
        out += bytes([int(self.colorspace)])
        out += bytes([0x40])                        # no alpha
        out += bytes([0])
        out += bytes([0x03])                        # both matrices present
        qm = self.quant_mat.astype(np.uint8).tobytes()
        out += qm + qm
        out[hdr_start:hdr_start + 2] = (len(out) - hdr_start).to_bytes(
            2, "big")

        pic_start = len(out)
        out += bytes([0x40])                        # picture header size
        out += b"\x00\x00\x00\x00"                  # picture data size
        out += self.slices_per_picture.to_bytes(2, "big")
        out += bytes([(self.mbs_per_slice.bit_length() - 1) << 4])
        st_pos = len(out)
        out += b"\x00\x00" * self.slices_per_picture

        si = 0
        for y in range(self.mb_height):
            for (x0, wmbs) in self.row:
                q = int(slice_q[si])
                qmat = (self.quants[0] if self.force_quant else
                        (self.quants[q] if q < MAX_STORED_Q else
                         _w16(self.quant_mat * q).astype(np.int64)))
                slice_start = len(out)
                out += bytes([6 << 3, q])           # slice header
                out += b"\x00\x00\x00\x00"          # y/u sizes backpatch
                sizes = []
                for p in range(3):
                    pb = PutBits()
                    blocks = self._slice_blocks(fdcts[p], p, y, x0, wmbs)
                    _encode_slice_plane(pb, blocks, qmat, self.scan)
                    data = pb.flush()
                    sizes.append(len(data))
                    out += data
                out[slice_start + 2:slice_start + 4] = sizes[0].to_bytes(
                    2, "big")
                out[slice_start + 4:slice_start + 6] = sizes[1].to_bytes(
                    2, "big")
                slice_size = 6 + sum(sizes)
                out[st_pos + si * 2:st_pos + si * 2 + 2] = \
                    slice_size.to_bytes(2, "big")
                si += 1

        # progressive picture_size quirk: end - (pic_start+1) - 6
        pic_size = len(out) - pic_start - 7
        out[pic_start + 1:pic_start + 5] = pic_size.to_bytes(4, "big")
        out[0:4] = len(out).to_bytes(4, "big")
        return Packet(data=bytes(out), pts=frame.pts, dts=frame.pts,
                      duration=1, flags=PKT_FLAG_KEY,
                      time_base=frame.time_base)
