#!/usr/bin/env python
"""Write the PyTorch port's committed smoke streams and their golden
digests.

Each stream is encoded with the JAX package's encoder on the CPU in
`bench.py`'s moving test pattern at 1920x1080, decoded with the JAX
package's decoder, and written with its golden into
`libav_tpu_torch/testdata/`:

    h264    h264_1080p_ipbb_cabac.{h264pkts,golden.json}: the stream that
            bench.py times (its ENC_SETTINGS, 8 frames)
    mpeg2   mpeg2_1080i_fieldpic.{m2vpkts,golden.json}: fieldpic=1,
            fieldstress=full, 4 frames (8 field pictures)
            mpeg2_1080p_ipbb.{m2vpkts,golden.json}: b_frames=2, 7 frames
            (both qscale 6, gop_size 8)
    mjpeg   mjpeg_1080p.{mjpegpkts,golden.json}: 4 frames, yuvj420p,
            quality 90
    small   h264_64x64_bench.h264: 4 frames at 64x64 with bench.py's
            settings, an Annex-B file for the CPU tests of the port's CLI
    framecrc  <stream>.framecrc for each of the four streams: the output
            of `libav_tpu.tools.avconv -i <input> -f framecrc` on the
            stream written as a CLI input file (testdata.write_cli_input);
            and mpeg2_1080p_ipbb.show_frames, the frame section of
            `libav_tpu.tools.avprobe -show_frames` on that input

The machine with the GPU has no jax, so the port's smoke run reads these
files instead of encoding. Run from the repository root (no argument
writes all of them; the H.264 stream takes ~80 s, each MPEG-2 one ~25 s;
framecrc needs the streams written first):

    JAX_PLATFORMS=cpu python tools/gen_torch_smoke_stream.py \
        [h264] [mpeg2] [mjpeg] [small] [framecrc]
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import bench  # noqa: E402
from libav_tpu_torch import testdata  # noqa: E402

MPEG2_SETTINGS = {
    "mpeg2_1080i_fieldpic": (4, {"qscale": 6, "gop_size": 8, "fieldpic": 1,
                                 "fieldstress": "full"}),
    "mpeg2_1080p_ipbb": (7, {"qscale": 6, "gop_size": 8, "b_frames": 2}),
}


def pattern(width: int, height: int, t: int, pix_fmt: str = "yuv420p"):
    """Frame t of bench.py's moving test pattern, as a host 4:2:0 Frame."""
    from libav_tpu.avutil.frame import Frame
    f = Frame.alloc_video(width, height, pix_fmt)
    yy, xx = np.mgrid[0:height, 0:width]
    f.planes[0] = ((xx // 2 + yy // 3 + t * 4) % 256).astype(np.uint8)
    ch, cw = f.planes[1].shape
    yy, xx = np.mgrid[0:ch, 0:cw]
    f.planes[1] = (128 + 54 * np.sin((xx + 3 * t) / 9.0)).astype(np.uint8)
    f.planes[2] = (128 + 54 * np.cos((yy - 2 * t) / 7.0)).astype(np.uint8)
    return f


def encode(width: int, height: int, nframes: int, codec_id: str = "h264",
           settings=None, pix_fmt: str = "yuv420p"):
    """nframes of the pattern through the JAX package's encoder (H.264
    with the bench settings by default): a list of packet bytes."""
    from libav_tpu.avutil.rational import Rational
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_encoder
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=codec_id,
                          width=width, height=height, pix_fmt=pix_fmt,
                          framerate=Rational(25, 1))
    enc = find_encoder(codec_id)(par)
    for k, v in (bench.ENC_SETTINGS if settings is None
                 else settings).items():
        enc.set_opt(k, v)
    return [p.data for p in enc.encode_all(
        [pattern(width, height, t, pix_fmt) for t in range(nframes)])]


def decode_reference(datas, codec_id: str = "h264"):
    """Decode with the JAX package: a list of host (Y, U, V) per frame."""
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_decoder
    dec = find_decoder(codec_id)(CodecParameters(codec_type=MediaType.VIDEO,
                                                 codec_id=codec_id))
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [[np.asarray(p) for p in f.to_host().planes] for f in frames]


def write(stream_path: str, golden_path: str, datas, codec_id: str):
    testdata.write_packets(stream_path, datas)
    gold = testdata.digest(decode_reference(datas, codec_id))
    with open(golden_path, "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"{os.path.basename(stream_path)}: {len(datas)} packets, "
          f"{sum(len(d) for d in datas)} bytes, {len(gold['frames'])} "
          f"frames")


def write_framecrc(name: str, show_frames: bool = False):
    """The JAX CLI's framecrc of a committed stream as a CLI input [and
    avprobe's -show_frames frame section]."""
    from libav_tpu.tools import avconv, avprobe
    work = tempfile.mkdtemp()
    try:
        inp = testdata.write_cli_input(name, work)
        out = os.path.join(work, "out.framecrc")
        if avconv.main(["-i", inp, "-f", "framecrc", out]) != 0:
            raise SystemExit(f"avconv failed on {name}")
        shutil.copyfile(out, testdata.framecrc_path(name))
        if show_frames:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                if avprobe.main(["-show_frames", inp]) != 0:
                    raise SystemExit(f"avprobe failed on {name}")
            with open(testdata.show_frames_path(name), "w") as f:
                f.write(testdata.frames_section(text.getvalue()))
    finally:
        shutil.rmtree(work)
    print(f"{name}.framecrc written")


def main(which):
    if "h264" in which:
        write(testdata.SMOKE_STREAM, testdata.SMOKE_GOLDEN,
              encode(bench.W, bench.H, bench.NFRAMES), "h264")
    if "mpeg2" in which:
        for name, (nframes, settings) in MPEG2_SETTINGS.items():
            write(*testdata.stream_paths(name),
                  encode(1920, 1080, nframes, "mpeg2video", settings),
                  "mpeg2video")
    if "mjpeg" in which:
        write(*testdata.stream_paths(testdata.MJPEG_SMOKE),
              encode(1920, 1080, 4, "mjpeg", {"quality": 90}, "yuvj420p"),
              "mjpeg")
    if "small" in which:
        with open(testdata.SMALL_H264, "wb") as f:
            f.write(b"".join(encode(64, 64, 4)))
    if "framecrc" in which:
        for name in testdata.CLI_INPUTS:
            write_framecrc(name, show_frames=name == "mpeg2_1080p_ipbb")


if __name__ == "__main__":
    main(sys.argv[1:] or ("h264", "mpeg2", "mjpeg", "small", "framecrc"))
