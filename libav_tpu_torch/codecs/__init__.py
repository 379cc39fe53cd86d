"""The port's codec engine (counterpart of `libav_tpu/codecs`).

The send/receive API and the port's own codec table live in `api.py`;
the host halves of the ported codecs (headers, entropy, DPB) are copies
of the JAX package's host code, and their device halves are the port's
PyTorch programs and hand kernels. Decoders take their torch device as a
keyword: `find_decoder(codec_id)(params, device=...)`; so does an
encoder with a device part (`DEVICE_PART`, the MPEG-4 encoder), whose
device defaults to "cuda".
"""

from libav_tpu_torch.codecs.api import (CodecContext, Decoder,  # noqa: F401
                                        Encoder, CodecParameters,
                                        find_decoder, find_encoder,
                                        register_codec)

# import for registration side effects
from libav_tpu_torch.codecs import (h264, mjpeg, mpeg12,  # noqa: F401
                                    mpeg4, rawvideo)  # noqa: F401
