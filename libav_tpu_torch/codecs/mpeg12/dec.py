"""MPEG-1/2 video decoders with the PyTorch device programs (counterpart
of `libav_tpu/codecs/mpeg12/dec.py`).

The host half is the JAX package's decoder, subclassed: start codes,
headers, slice entropy, concealment (`codecs/er.py`), the DPB, field
pairing, the output crop and reordering stay its code. Three of its
methods reach the device: `_reconstruct` (frame pictures),
`_reconstruct_field` (field pictures) and `_finish_field` (the weave of a
field pair). Each imports its programs inside the method body
(`from libav_tpu.codecs.mpegvideo import ...`), so rebinding the
method's globals alone would not reach them. Each is rebound here
(`hostcode.rebind`) with globals whose `__import__` answers that one
module's names with the port's programs on the decoder's device, and
whose `Frame` and `_zero_refs` are the port's; every other name and
import is the parent's. Both packages run the same host code, and no JAX
program can be reached from here.

The numpy inputs go to the device synchronously (state_from_numpy) on
the thread that decodes.
"""

from __future__ import annotations

import functools
import types

from libav_tpu.codecs.mpeg12 import dec as _ref
from libav_tpu_torch import hostcode
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.codecs import mpegvideo, register_codec

_JAX_PROGRAMS = "libav_tpu.codecs.mpegvideo"
_DEVICE_METHODS = ("_reconstruct", "_reconstruct_field", "_finish_field")


def device_programs(dev) -> types.SimpleNamespace:
    """What the parent's methods import from the JAX mpegvideo module, as
    the port's programs on dev, behind the JAX factories' interface."""
    return types.SimpleNamespace(
        recon_jit=hwdevice.program_factory(mpegvideo.recon, dev),
        recon_field_jit=hwdevice.program_factory(mpegvideo.recon_field, dev),
        fields_of_frame_jit=hwdevice.program_factory(
            mpegvideo.fields_of_frame, dev),
        weave_fields_jit=hwdevice.program_factory(mpegvideo.weave_fields,
                                                  dev),
        zero_pad_refs=functools.partial(mpegvideo.zero_pad_refs, device=dev))


@register_codec
class MPEG1Decoder(_ref.MPEG1Decoder):
    """MPEG1Decoder(params, options, device=...) — planes of the output
    frames (and of the DPB) are uint8 tensors on `device`."""
    LONG_NAME = "MPEG-1 video (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device):
        super().__init__(params, options)
        self.device = dev = hwdevice.device(device)
        programs = device_programs(dev)

        names = dict(vars(_ref), Frame=Frame,
                     _zero_refs=lambda seq: programs.zero_pad_refs(
                         seq.mb_width, seq.mb_height),
                     __builtins__=hostcode.host_builtins(
                         replace={_JAX_PROGRAMS: vars(programs)}))
        for name in _DEVICE_METHODS:
            setattr(self, name, hostcode.rebind(
                getattr(_ref.MPEG1Decoder, name), names, self))


@register_codec
class MPEG2Decoder(MPEG1Decoder):
    NAME = "mpeg2video"
    LONG_NAME = "MPEG-2 video (PyTorch device reconstruction)"
