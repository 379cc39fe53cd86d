"""The port's codec engine (counterpart of `libav_tpu/codecs`).

The send/receive API and the port's own codec table live in `api.py`;
the host halves of the ported codecs (headers, entropy, DPB) are copies
of the JAX package's host code, and their device halves are the port's
PyTorch programs and hand kernels. Decoders take their torch device as a
keyword, "cuda" by default: `find_decoder(codec_id)(params,
device="cpu")` runs them on the CPU; so does an encoder with a device part
(`DEVICE_PART`: the H.264, MJPEG, MPEG-1/2, MPEG-4 and ProRes encoders,
and the AAC and AC-3 encoders with their MDCT on the device). The audio
decoders (AAC with its IMDCT on the device; AC-3/E-AC-3, MP1/2/3, FLAC
and PCM on the host) hand out host sample planes; the MP1/2/3, FLAC and
FFV1 encoders run on the host (FFV1's decoder too, uploading each
finished frame to its device).
"""

from libav_tpu_torch.codecs.api import (CodecContext, Decoder,  # noqa: F401
                                        Encoder, CodecParameters,
                                        find_decoder, find_encoder,
                                        register_codec)

# import for registration side effects
from libav_tpu_torch.codecs import (h264, mjpeg, mpeg12,  # noqa: F401
                                    mpeg4, rawvideo, ac3, aac,  # noqa: F401
                                    mpegaudio, flac, h263dec,  # noqa: F401
                                    msmpeg4dec, prores, ffv1)  # noqa: F401
