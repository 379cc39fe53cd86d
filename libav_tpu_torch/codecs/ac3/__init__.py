"""AC-3 (ATSC A/52) codec (reference: libavcodec/ac3dec.c (1638) +
ac3enc; SURVEY.md §3.4 — north-star config 5 audio path).

Host: syncframe/BSI/audblk parsing, exponent decode, the parametric bit
allocation (shared bit-exact between encoder and decoder — it must be,
that is how AC-3 works), mantissa unpack, and the float64 IMDCT-256 with
its windowed overlap-add (`ops/fftmdct.imdct_host`). The encoder's MDCT
runs on its device (`ops/fftmdct.mdct`), its bit allocation and packing
on the host.

Round-1 subset: full-bandwidth channels (any acmod), no coupling, no LFE,
no dither reconstruction (dithered bins decode to 0, with a warning), no
E-AC-3. The encoder emits stereo/mono with D15 exponents in block 0 +
REUSE, no coupling/dither — decodable by any compliant decoder.
"""

from libav_tpu_torch.codecs.ac3.dec import AC3Decoder  # noqa: F401
from libav_tpu_torch.codecs.ac3.enc import AC3Encoder  # noqa: F401
