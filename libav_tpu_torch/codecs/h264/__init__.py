"""H.264/AVC decoding with PyTorch device reconstruction (counterpart of
`libav_tpu/codecs/h264`). The host half (NAL, headers, CAVLC/CABAC
entropy, DPB) is the JAX package's; the encoder is not ported yet."""

from libav_tpu_torch.codecs.h264.dec import H264Decoder  # noqa: F401
