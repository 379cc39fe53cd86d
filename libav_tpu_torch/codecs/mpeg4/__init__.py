"""MPEG-4 part 2 video encoding with PyTorch device programs (counterpart
of `libav_tpu/codecs/mpeg4`). The host half (VOL/VOP headers, MB-layer
VLC coding, DC/AC/MV prediction) is a copy of the JAX package's; the
device half (motion search, FDCT, H.263 quantisation, reconstruction
through kernel K2) is the port's. The decoder is not ported yet."""

from libav_tpu_torch.codecs.mpeg4.enc import MPEG4Encoder  # noqa: F401
