"""FFV1 lossless intra codec (counterpart of `libav_tpu/codecs/ffv1`;
host code; reference: libavcodec/ffv1.c/ffv1.h,
ffv1dec.c, ffv1enc.c).  Imported for codec-registration side effects."""

from libav_tpu_torch.codecs.ffv1 import dec, enc  # noqa: F401
