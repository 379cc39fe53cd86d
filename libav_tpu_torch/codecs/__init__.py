"""The PyTorch port's codec table (counterpart of the registry in
`libav_tpu/codecs/api.py`). It is separate from the JAX package's table,
so both packages' "h264" decoders can be loaded in one process."""

from __future__ import annotations

from typing import Dict, Type

from libav_tpu.avutil.error import AVError, DECODER_NOT_FOUND
from libav_tpu.codecs.api import Decoder

_DECODERS: Dict[str, Type[Decoder]] = {}


def register_codec(cls):
    """Class decorator: cls is a Decoder with a NAME."""
    if not issubclass(cls, Decoder):
        raise TypeError(cls)
    _DECODERS[cls.NAME] = cls
    return cls


def find_decoder(codec_id: str) -> Type[Decoder]:
    if codec_id not in _DECODERS:
        raise AVError(DECODER_NOT_FOUND, codec_id)
    return _DECODERS[codec_id]


from libav_tpu_torch.codecs import h264, mpeg12  # noqa: E402,F401
