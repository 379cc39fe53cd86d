"""MJPEG / baseline and progressive JPEG decoding with PyTorch device
reconstruction, and the baseline encoder with its FDCT and quantiser on
the device (counterpart of `libav_tpu/codecs/mjpeg`). The host halves
(markers, Huffman scans, the native scan decoder and packer) are copies
of the JAX package's."""

from libav_tpu_torch.codecs.mjpeg.dec import MJPEGDecoder  # noqa: F401
from libav_tpu_torch.codecs.mjpeg.enc import MJPEGEncoder  # noqa: F401
