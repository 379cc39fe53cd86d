from libav_tpu_torch.codecs.flac.dec import FLACDecoder     # noqa: F401
from libav_tpu_torch.codecs.flac.enc import FLACEncoder     # noqa: F401
