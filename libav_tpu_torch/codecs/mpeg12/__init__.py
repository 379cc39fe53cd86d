"""MPEG-1/2 video decoding and encoding with PyTorch device programs
(counterpart of `libav_tpu/codecs/mpeg12`). The host halves (start codes,
headers, VLC entropy, DPB, field pairing; the encoders' packing, frame
reordering and rate control) are copies of the JAX package's; the
encoders' motion search, FDCT, quantiser and closed-loop reconstruction
run on the encoder's device."""

from libav_tpu_torch.codecs.mpeg12.dec import (MPEG1Decoder,  # noqa: F401
                                               MPEG2Decoder)
from libav_tpu_torch.codecs.mpeg12.enc import (MPEG1Encoder,  # noqa: F401
                                               MPEG2Encoder)
