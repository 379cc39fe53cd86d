"""MPEG audio (MP1/MP2/MP3) codec family (reference:
libavcodec/mpegaudiodec_template.c, mpegaudioenc.c)."""

from libav_tpu_torch.codecs.mpegaudio.dec import MpegAudioDecoder, frame_info
from libav_tpu_torch.codecs.mpegaudio.enc import (Mp1Encoder, Mp2Encoder,
                                            Mp3Encoder)

__all__ = ["MpegAudioDecoder", "frame_info", "Mp1Encoder", "Mp2Encoder",
           "Mp3Encoder"]
