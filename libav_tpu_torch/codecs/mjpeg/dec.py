"""MJPEG decoder with the PyTorch device programs (counterpart of
`libav_tpu/codecs/mjpeg/dec.py`; reference: mjpegdec.c).

The host half is the JAX package's decoder, subclassed: markers, tables,
the baseline and progressive Huffman scans (and the native scan decoder)
stay its code. Two of its methods reach the device, `_reconstruct` (one
frame) and `decode_jpeg_batch` (a batch of frames of one geometry), each
through a module global: `_reconstruct_plane_jit` and
`_reconstruct_plane_batch_jit`. The JAX factories import jax inside their
own bodies, so rebinding the two methods' globals reaches them: each
method is rebound here with globals in which those two names are the
port's programs on the decoder's device and `Frame` is the port's; every
other name is the parent's.

A program is one component plane: int32 dequant, +1024 on the DC (the
+128 level shift carried through the IDCT, mjpegdec.c:962), the inverse
zigzag, `idct_put` through kernel K2, and the block-to-plane layout. K2
runs once per component per call: three launches per 4:2:0 frame, or
three per batch.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from libav_tpu.codecs.mjpeg import dec as _ref
from libav_tpu_torch import hostcode
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.codecs import register_codec
from libav_tpu_torch.ops import quant
from libav_tpu_torch.ops.idct import idct_put

_DEVICE_METHODS = ("_reconstruct", "decode_jpeg_batch")


class ReconstructPlanes(nn.Module):
    """(N * blocks_h * blocks_w, 64) zigzag-order levels + (64,) zigzag
    quant matrix -> (N, 8 blocks_h, 8 blocks_w) uint8 planes, or one
    (8 blocks_h, 8 blocks_w) plane when not batched."""

    def __init__(self, blocks_h: int, blocks_w: int, batched: bool):
        super().__init__()
        self.blocks_h, self.blocks_w, self.batched = \
            blocks_h, blocks_w, batched
        self.register_buffer("pos", quant.raster_positions())

    def forward(self, coeffs_zz, qmat_zz):
        deq = coeffs_zz.to(torch.int32) * qmat_zz.to(torch.int32)
        deq[:, 0] += 1024
        pix = idct_put(quant.dezigzag(deq, self.pos))
        bh, bw = self.blocks_h, self.blocks_w
        planes = pix.reshape(-1, bh, bw, 8, 8).transpose(2, 3) \
            .reshape(-1, bh * 8, bw * 8)
        return planes if self.batched else planes[0]


@functools.lru_cache(maxsize=64)
def reconstruct_planes(blocks_h: int, blocks_w: int, batched: bool, *,
                       device: torch.device) -> ReconstructPlanes:
    return ReconstructPlanes(blocks_h, blocks_w, batched).to(device)


def device_programs(dev: torch.device):
    """(_reconstruct_plane_jit, _reconstruct_plane_batch_jit) as the
    port's programs on dev, behind the JAX factories' interface: f(bh,
    bw) returns run(coeffs_zz, qmat_zz[, B]), which uploads the numpy
    arrays and runs the module (B, the JAX batch program's static batch
    size, follows from the coefficients' shape)."""
    def factory(batched):
        def program(blocks_h, blocks_w):
            module = reconstruct_planes(blocks_h, blocks_w, batched,
                                        device=dev)

            def run(coeffs_zz, qmat_zz, *static):
                return module(*hwdevice.state_from_numpy(
                    (coeffs_zz, qmat_zz), dev))
            return run
        return program
    return factory(False), factory(True)


@register_codec
class MJPEGDecoder(_ref.MJPEGDecoder):
    """MJPEGDecoder(params, options, device=...) — planes of the output
    frames are uint8 tensors on `device`."""
    LONG_NAME = "Motion JPEG (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device):
        super().__init__(params, options)
        self.device = dev = hwdevice.device(device)
        single, batch = device_programs(dev)
        names = dict(vars(_ref), Frame=Frame,
                     _reconstruct_plane_jit=single,
                     _reconstruct_plane_batch_jit=batch)
        for name in _DEVICE_METHODS:
            setattr(self, name, hostcode.rebind(
                getattr(_ref.MJPEGDecoder, name), names, self))
