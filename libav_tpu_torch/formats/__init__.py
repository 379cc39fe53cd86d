"""Container & I/O layer of the port (counterpart of `libav_tpu/formats`;
reference: libavformat/).

The JAX package's host modules, copied: io.py (byte I/O + protocols),
api.py (FormatContext open/read/write, the registries) and the
containers the port's paths use: raw H.264, raw MPEG video, raw MPEG-4
video (m4v), image2/MJPEG, rawvideo, yuv4mpeg, AVI, MOV/MP4, Matroska/
WebM, MPEG-TS, WAV, raw PCM, raw AC-3/E-AC-3, ADTS AAC, raw MP1/2/3,
FLAC, raw H.263, FLV and the framecrc/framemd5 oracles. The JAX
package's other containers (HLS, RTP/SDP/RTSP, the virtual capture
devices) raise DEMUXER_NOT_FOUND / MUXER_NOT_FOUND naming the ROADMAP.md
module-queue step that ports them (`api.NOT_PORTED`).
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
                                     pcmraw, mp3raw, flacfmt,  # noqa: F401
                                     h263raw, flv)  # noqa: F401
