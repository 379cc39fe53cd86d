"""MJPEG / baseline and progressive JPEG decoding with PyTorch device
reconstruction (counterpart of `libav_tpu/codecs/mjpeg`). The host half
(markers, Huffman scans, the native scan decoder) is the JAX package's;
the encoder is not ported yet."""

from libav_tpu_torch.codecs.mjpeg.dec import MJPEGDecoder  # noqa: F401
