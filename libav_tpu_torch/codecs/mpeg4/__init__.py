"""MPEG-4 part 2 video with PyTorch device programs (counterpart of
`libav_tpu/codecs/mpeg4`). The host halves (VOL/VOP headers, MB-layer VLC
coding and decoding, DC/AC/MV prediction, video packets, partitions, GMC
sprite trajectories) are copies of the JAX package's; the device halves
(motion search, FDCT, quantisation, GMC warp, reconstruction through
kernel K2) are the port's."""

from libav_tpu_torch.codecs.mpeg4.enc import MPEG4Encoder  # noqa: F401
from libav_tpu_torch.codecs.mpeg4.dec import MPEG4Decoder  # noqa: F401
