"""rawvideo + PCM "codecs" (counterpart of `libav_tpu/codecs/rawvideo.py`;
reference: libavcodec/rawdec.c/rawenc.c, pcm.c) — byte <-> Frame
packing, no entropy work. The rawvideo decoder uploads its planes to the
decoder's device, as the port's other video decoders leave theirs; the
PCM decoders keep their samples on the host."""

from __future__ import annotations

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType, PKT_FLAG_KEY
from libav_tpu_torch.avutil.imgutils import bytes_to_frame, frame_to_bytes
from libav_tpu_torch.avutil.samplefmt import is_planar
from libav_tpu_torch.codecs.api import (Decoder, Encoder, MediaType,
                                        register_codec)


@register_codec
class RawVideoDecoder(Decoder):
    NAME = "rawvideo"
    TYPE = MediaType.VIDEO

    def __init__(self, params=None, options=None, *, device):
        """RawVideoDecoder(params, options, device=...) — the planes of
        the output frames are tensors on `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _decode(self, pkt: Packet):
        f = bytes_to_frame(pkt.data, self.pix_fmt, self.width, self.height)
        f.planes = [torch.tensor(p, device=self.device) for p in f.planes]
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        f.key_frame = True
        f.pict_type = PictureType.I
        return [f]


@register_codec
class RawVideoEncoder(Encoder):
    NAME = "rawvideo"
    TYPE = MediaType.VIDEO

    def _encode(self, frame: Frame):
        host = frame.to_host()
        return [Packet(data=frame_to_bytes(host), pts=frame.pts,
                       dts=frame.pts, duration=1, flags=PKT_FLAG_KEY,
                       time_base=frame.time_base)]


def _make_pcm(name: str, fmt: str, dtype, scale=None):
    """Generate a PCM decode/encode pair (reference: pcm.c PCM_CODEC)."""

    class _Dec(Decoder):
        NAME = name
        TYPE = MediaType.AUDIO

        def __init__(self, params=None, options=None, *, device):
            super().__init__(params, options)
            self.device = hwdevice.device(device)

        def _decode(self, pkt: Packet):
            arr = np.frombuffer(pkt.data, dtype=dtype)
            ch = max(self.channels, 1)
            ns = len(arr) // ch
            f = Frame(nb_samples=ns, sample_rate=self.sample_rate,
                      format=fmt, channels=ch,
                      channel_layout=self.channel_layout)
            f.planes = [arr[:ns * ch]]   # interleaved packed layout
            f.pts = pkt.pts
            f.time_base = pkt.time_base
            return [f]

    class _Enc(Encoder):
        NAME = name
        TYPE = MediaType.AUDIO

        def _encode(self, frame: Frame):
            if is_planar(frame.format):
                # interleave planes
                stacked = np.stack([np.asarray(p) for p in frame.planes], axis=-1)
                data = _convert(stacked.reshape(-1))
            else:
                data = _convert(np.asarray(frame.planes[0]))
            return [Packet(data=data.tobytes(), pts=frame.pts, dts=frame.pts,
                           duration=frame.nb_samples, flags=PKT_FLAG_KEY,
                           time_base=frame.time_base)]

    def _convert(arr: np.ndarray) -> np.ndarray:
        if arr.dtype == dtype:
            return arr
        if np.issubdtype(dtype, np.integer) and np.issubdtype(arr.dtype, np.floating):
            info = np.iinfo(dtype)
            return np.clip(np.round(arr * (info.max + 1)), info.min, info.max).astype(dtype)
        if np.issubdtype(dtype, np.floating) and np.issubdtype(arr.dtype, np.integer):
            info = np.iinfo(arr.dtype)
            return (arr.astype(dtype) / (info.max + 1)).astype(dtype)
        return arr.astype(dtype)

    _Dec.__name__ = f"PCMDecoder_{name}"
    _Enc.__name__ = f"PCMEncoder_{name}"
    register_codec(_Dec)
    register_codec(_Enc)
    return _Dec, _Enc


_make_pcm("pcm_s16le", "s16", np.dtype("<i2"))
_make_pcm("pcm_s32le", "s32", np.dtype("<i4"))
_make_pcm("pcm_u8", "u8", np.dtype("u1"))
_make_pcm("pcm_f32le", "flt", np.dtype("<f4"))
_make_pcm("pcm_f64le", "dbl", np.dtype("<f8"))
