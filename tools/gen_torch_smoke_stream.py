#!/usr/bin/env python
"""Write the PyTorch port's committed smoke stream and its golden digests.

Encodes the stream that `bench.py` times (its ENC_SETTINGS and test
pattern, 1920x1080, 8 frames) with the JAX package's encoder on the CPU,
decodes it with the JAX package's decoder, and writes

    libav_tpu_torch/testdata/h264_1080p_ipbb_cabac.h264pkts
    libav_tpu_torch/testdata/h264_1080p_ipbb_cabac.golden.json

The machine with the GPU has no jax, so the port's smoke run reads both
files instead of encoding. Run from the repository root:

    JAX_PLATFORMS=cpu python tools/gen_torch_smoke_stream.py
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import bench  # noqa: E402
from libav_tpu_torch import testdata  # noqa: E402


def pattern(width: int, height: int, t: int):
    """Frame t of bench.py's moving test pattern, as a host Frame."""
    from libav_tpu.avutil.frame import Frame
    f = Frame.alloc_video(width, height, "yuv420p")
    yy, xx = np.mgrid[0:height, 0:width]
    f.planes[0] = ((xx // 2 + yy // 3 + t * 4) % 256).astype(np.uint8)
    ch, cw = f.planes[1].shape
    yy, xx = np.mgrid[0:ch, 0:cw]
    f.planes[1] = (128 + 54 * np.sin((xx + 3 * t) / 9.0)).astype(np.uint8)
    f.planes[2] = (128 + 54 * np.cos((yy - 2 * t) / 7.0)).astype(np.uint8)
    return f


def encode(width: int, height: int, nframes: int):
    """The bench stream at another size: a list of access-unit bytes."""
    from libav_tpu.avutil.rational import Rational
    from libav_tpu.codecs.api import CodecParameters, MediaType
    from libav_tpu.codecs.h264 import H264Encoder
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                          width=width, height=height, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = H264Encoder(par)
    for k, v in bench.ENC_SETTINGS.items():
        enc.set_opt(k, v)
    return [p.data for p in enc.encode_all(
        [pattern(width, height, t) for t in range(nframes)])]


def decode_reference(datas):
    """Decode with the JAX package: a list of host (Y, U, V) per frame."""
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType
    from libav_tpu.codecs.h264 import H264Decoder
    dec = H264Decoder(CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="h264"))
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [[np.asarray(p) for p in f.planes] for f in frames]


def main():
    datas = encode(bench.W, bench.H, bench.NFRAMES)
    testdata.write_packets(testdata.SMOKE_STREAM, datas)
    gold = testdata.digest(decode_reference(datas))
    with open(testdata.SMOKE_GOLDEN, "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"{len(datas)} access units, "
          f"{sum(len(d) for d in datas)} bytes, {len(gold['frames'])} frames")


if __name__ == "__main__":
    main()
