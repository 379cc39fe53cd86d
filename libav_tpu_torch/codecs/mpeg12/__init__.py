"""MPEG-1/2 video decoding with PyTorch device reconstruction (counterpart
of `libav_tpu/codecs/mpeg12`). The host half (start codes, headers, VLC
entropy, DPB, field pairing) is the JAX package's; the encoders are not
ported yet."""

from libav_tpu_torch.codecs.mpeg12.dec import (MPEG1Decoder,  # noqa: F401
                                               MPEG2Decoder)
