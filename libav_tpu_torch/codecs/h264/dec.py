"""H.264 decoder with the PyTorch device program (counterpart of
`libav_tpu/codecs/h264/dec.py`).

The host half is the JAX package's decoder, subclassed. Only the frame
reconstruction changes: `_reconstruct` runs the parent's own host-side
argument assembly (dec.py `H264Decoder._reconstruct`) bound to the
port's names — the device program factory, zero references and Frame —
so both packages assemble each frame's inputs with the same code. The
numpy inputs go to the device synchronously (state_from_numpy) on the
thread that calls `_reconstruct`; the entropy worker thread makes no
CUDA call.
"""

from __future__ import annotations

import functools
import types
from typing import Tuple

from libav_tpu.avutil import timer
from libav_tpu.codecs.h264 import dec as _ref
from libav_tpu.native import h264_cabac_host
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.codecs import register_codec
from libav_tpu_torch.codecs.h264 import device as _device


@register_codec
class H264Decoder(_ref.H264Decoder):
    """H264Decoder(params, options, device=...) — planes of the output
    frames (and of the DPB) are uint8 tensors on `device`."""
    LONG_NAME = "H.264/AVC (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device):
        super().__init__(params, options)
        self.device = dev = hwdevice.device(device)

        names = dict(vars(_ref),
                     recon_h264_sparse_jit=hwdevice.program_factory(
                         _device.recon_h264_sparse, dev),
                     zero_refs_h264=functools.partial(
                         _device.zero_refs_h264, device=dev),
                     Frame=Frame)
        parent = _ref.H264Decoder._reconstruct
        self._reconstruct_on_device = types.FunctionType(
            parent.__code__, names, parent.__name__)

    def _reconstruct(self, fd, slice_info) -> Frame:
        return self._reconstruct_on_device(self, fd, slice_info)

    def _recon_mbaff(self, fd, slice_info):
        raise NotImplementedError("MBAFF pictures are not ported to "
                                  "libav_tpu_torch yet (ROADMAP.md: module "
                                  "queue, step 6a)")

    @staticmethod
    def _weave_fields(top, bot):
        raise NotImplementedError("field pictures are not ported to "
                                  "libav_tpu_torch yet (ROADMAP.md: module "
                                  "queue, step 6a)")


def native_cabac_available() -> bool:
    """Whether the host entropy layer runs the native C CABAC decoder
    (otherwise the slower pure-Python path decodes, with the same
    output)."""
    return h264_cabac_host.available()


def host_entropy_stats() -> Tuple[int, float]:
    """(access units, seconds) spent in host entropy decoding in this
    process: the parent decoder's "h264.entropy" timer span, which wraps
    each access unit's header parsing, slice entropy and DPB update."""
    n, total, _, _ = timer._STATS.get("h264.entropy", (0, 0.0, 0.0, 0.0))
    return n, total
