"""Apple ProRes intra codec (counterpart of `libav_tpu/codecs/prores`;
reference: libavcodec/proresdec.c, proresenc.c, proresdata.c). Imported
for codec-registration side effects."""

from libav_tpu_torch.codecs.prores import dec, enc  # noqa: F401
