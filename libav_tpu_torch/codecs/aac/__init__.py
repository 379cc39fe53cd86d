"""AAC codec family (reference: libavcodec/aacdec.c :2967, aacenc, and
aacsbr.c for HE-AAC SBR).

Decoder: AAC-LC (long/short windows, sine+KBD, M/S, TNS, PNS, I_CS
tool chain) plus SBR (HE-AAC v1; sbr.py — QMF banks as precomputed
linear operators, covariance HF inverse filtering, limiter/boost gain
adjustment, noise+sinusoid assembly), cross-validated against the
reference decoder at float32 precision.  Encoder: AAC-LC with TNS/PNS
emission and SBR stress-profile emission for conformance streams, its
MDCT on the encoder's device.
"""

from libav_tpu_torch.codecs.aac.dec import AACDecoder
from libav_tpu_torch.codecs.aac.enc import AACEncoder

__all__ = ["AACDecoder", "AACEncoder"]
