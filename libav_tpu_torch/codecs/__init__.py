"""The PyTorch port's codec table (counterpart of the registry in
`libav_tpu/codecs/api.py`). It is separate from the JAX package's table,
so both packages' "h264" decoders can be loaded in one process.

`decoder_factory(device)` is the CLI's lookup: the JAX tools construct a
decoder as `find_decoder(codec_id)(params)`, and the port's decoders take
their device as a keyword, so the lookup hands back each class bound to
the device. A codec the port lacks raises DECODER_NOT_FOUND naming the
ROADMAP.md step that ports it; the JAX decoder never runs in its place.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Type

from libav_tpu.avutil.error import AVError, DECODER_NOT_FOUND
from libav_tpu.codecs.api import Decoder
from libav_tpu_torch.avutil import hwdevice

_DECODERS: Dict[str, Type[Decoder]] = {}

# codec id -> the ROADMAP.md module-queue step that ports its decoder
NOT_PORTED = {
    **dict.fromkeys(("mpeg4", "h263", "flv1", "msmpeg4", "msmpeg4v2",
                     "msmpeg4v3", "msmpeg4v4", "wmv1"), "8b"),
    **dict.fromkeys(("aac", "ac3", "eac3", "mp1", "mp2", "mp2float", "mp3",
                     "mp3float", "flac", "pcm_s16le", "pcm_s32le", "pcm_u8",
                     "pcm_f32le", "pcm_f64le"), "10"),
    "prores": "11",
    **dict.fromkeys(("rawvideo", "ffv1"), "15"),
}


def register_codec(cls):
    """Class decorator: cls is a Decoder with a NAME."""
    if not issubclass(cls, Decoder):
        raise TypeError(cls)
    _DECODERS[cls.NAME] = cls
    return cls


def find_decoder(codec_id: str) -> Type[Decoder]:
    if codec_id not in _DECODERS:
        step = NOT_PORTED.get(codec_id)
        raise AVError(DECODER_NOT_FOUND, codec_id if step is None else
                      f"{codec_id} is not ported to libav_tpu_torch yet "
                      f"(ROADMAP.md module queue, step {step})")
    return _DECODERS[codec_id]


def decoder_factory(device) -> Callable[[str], Callable[..., Decoder]]:
    """find_decoder on a device: codec_id -> the port's decoder class with
    `device` bound, called as the JAX tools call a decoder class."""
    dev = hwdevice.device(device)

    def find(codec_id: str):
        return functools.partial(find_decoder(codec_id), device=dev)
    return find


from libav_tpu_torch.codecs import h264, mjpeg, mpeg12  # noqa: E402,F401
