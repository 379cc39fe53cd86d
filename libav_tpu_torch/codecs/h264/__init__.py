"""H.264/AVC decoding with PyTorch device reconstruction, and the encoder
with its intra wavefronts, search and transform/quant on the device
(counterpart of `libav_tpu/codecs/h264`). The host halves (NAL, headers,
CAVLC/CABAC entropy in both directions, DPB, the encoder's GOP and slice
packing) are copies of the JAX package's."""

from libav_tpu_torch.codecs.h264.dec import H264Decoder  # noqa: F401
from libav_tpu_torch.codecs.h264.enc import H264Encoder  # noqa: F401
