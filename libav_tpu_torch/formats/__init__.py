"""Container & I/O layer of the port (counterpart of `libav_tpu/formats`;
reference: libavformat/).

The JAX package's host modules, copied: io.py (byte I/O + protocols),
api.py (FormatContext open/read/write, the registries) and the
containers the port's paths use: raw H.264, raw MPEG video, raw MPEG-4
video (m4v), image2/MJPEG, rawvideo, yuv4mpeg, AVI, WAV, raw PCM, raw
AC-3/E-AC-3, ADTS AAC and the framecrc/framemd5 oracles. Any other container raises DEMUXER_NOT_FOUND / MUXER_NOT_FOUND
naming ROADMAP.md module queue step 16.
"""

from libav_tpu_torch.formats.api import (FormatContext,  # noqa: F401
                                         InputFormat, OutputFormat, Stream,
                                         open_input, guess_format)

# registration side effects
from libav_tpu_torch.formats import (image2, rawvideo, framecrc,  # noqa: F401
                                     mpegvideo_raw, h264raw, avi,  # noqa: F401
                                     m4v, yuv4mpeg, wav, pcmraw,  # noqa: F401
                                     ac3raw, aacraw)  # noqa: F401
