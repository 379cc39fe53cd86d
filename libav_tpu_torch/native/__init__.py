"""Native (C) host-side hot loops, compiled on demand via cffi
(counterpart of `libav_tpu/native`, copied: the CABAC and CAVLC slice
decoders of H.264 and the MJPEG scan decoder, with their headers; the
MPEG-1/2 slice decoder, `mpeg12_slice.c`, is the port's own).

The serial bitstream code (entropy decode) stays on the host: C
implementations of the frame-rate scan/slice entropy loops, each with a
pure-Python reference implementation in its codec package that produces
identical tensors.

Build model: sources live here; `build.py` compiles one shared library
into `libav_tpu_torch/native/_build/` the first time a fast path is
requested. Everything degrades gracefully to the Python path when a
compiler or cffi is unavailable (LIBAV_TPU_NO_NATIVE=1 forces it).
"""
