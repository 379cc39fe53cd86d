"""Container & I/O layer of the port (counterpart of `libav_tpu/formats`;
reference: libavformat/).

The JAX package's host modules, copied: io.py (byte I/O + protocols),
api.py (FormatContext open/read/write, the registries) and every
container of the JAX package: raw H.264, raw MPEG video, raw MPEG-4
video (m4v), image2/MJPEG, rawvideo, yuv4mpeg, AVI, MOV/MP4, Matroska/
WebM, MPEG-TS, HLS, RTP/SDP/RTSP, WAV, raw PCM, raw AC-3/E-AC-3, ADTS
AAC, raw MP1/2/3, FLAC, raw H.263, FLV and the framecrc/framemd5
oracles, then the virtual capture devices (`libav_tpu_torch/devices.py`:
testsrc, vsynth, sine).
"""

from libav_tpu_torch.formats.api import (FormatContext,  # noqa: F401
                                         InputFormat, OutputFormat, Stream,
                                         open_input, guess_format)

# registration side effects, in the JAX package's order (probe ties and
# output extensions go to the first registered)
from libav_tpu_torch.formats import (image2, rawvideo, yuv4mpeg,  # noqa: F401
                                     framecrc, wav, mpegvideo_raw,  # noqa: F401
                                     m4v, h264raw, ac3raw, aacraw,  # noqa: F401
                                     mov, avi, mpegts, matroska,  # noqa: F401
                                     pcmraw, hls, rtp, mp3raw,  # noqa: F401
                                     flacfmt, h263raw, flv)  # noqa: F401
from libav_tpu_torch import devices  # noqa: F401,E402  (libavdevice analogue)
