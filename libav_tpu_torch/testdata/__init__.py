"""The committed smoke streams and their golden digests.

`h264_1080p_ipbb_cabac.h264pkts` is the 1080p stream that `bench.py` times
(CABAC, I_8x8 + 8x8 transform, IPBB, 4 slices, in-loop deblocking). The
two MPEG-2 streams are 1920x1080 in the same moving test pattern, qscale
6, GOP 8:
  - `mpeg2_1080i_fieldpic.m2vpkts`: 4 frames coded as 8 field pictures
    (I, I, then P fields cycling whole-field, 16x8 and dual-prime MC);
  - `mpeg2_1080p_ipbb.m2vpkts`: 7 frame pictures, I/P/B with 2 B frames.
`mjpeg_1080p.mjpegpkts` is 4 JPEGs of the same pattern, 1920x1080
yuvj420p, from the JAX package's MJPEG encoder at quality 90.
Each stream is stored as 4-byte big-endian length-prefixed packets. Its
golden JSON holds, per output frame, the adler32 (seed 0, over the Y|U|V
bytes, as a framecrc line of rawvideo output computes it) and md5 that the
JAX package's decoder produced on the CPU, plus one md5 over all frames.
`<stream>.framecrc` is what `libav_tpu.tools.avconv -i <input> -f
framecrc` wrote on the CPU for the stream as a CLI input file
(`write_cli_input`: an Annex-B `.h264`, an `.m2v` elementary stream, or
the JPEGs concatenated into one `.mjpeg` file, which the image2 demuxer
splits at SOI/EOI; it opens an `img_%03d.jpg` pattern as a plain file
name, so a numbered sequence is no CLI input).
`h264_64x64_bench.h264` is an Annex-B file of 4 frames at 64x64 with the
bench stream's settings, a CLI input for the CPU tests.
`mpeg2_1080p_ipbb.show_frames` is the frame section of what
`libav_tpu.tools.avprobe -show_frames` printed for that stream's input.
`mpeg4_1080p_from_ipbb.golden.json` is the JAX package's MPEG-4 encode
of that stream's 7 decoded frames (MPEG4_SETTINGS), as digests only: no
encoded video is committed.
All files are written by `tools/gen_torch_smoke_stream.py`.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import Dict, List, Sequence

import numpy as np

from libav_tpu_torch.ops.idct import simple_idct_matrix
from libav_tpu_torch.ops.mc import EDGE

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_STREAM = os.path.join(HERE, "h264_1080p_ipbb_cabac.h264pkts")
SMOKE_GOLDEN = os.path.join(HERE, "h264_1080p_ipbb_cabac.golden.json")
# name -> number of coded pictures (one K2 launch each)
MPEG2_SMOKE = {"mpeg2_1080i_fieldpic": 8, "mpeg2_1080p_ipbb": 7}
MJPEG_SMOKE = "mjpeg_1080p"
SMALL_H264 = os.path.join(HERE, "h264_64x64_bench.h264")
# committed stream -> (packet file suffix, the CLI's input file name)
CLI_INPUTS = {
    "h264_1080p_ipbb_cabac": (".h264pkts", "bench.h264"),
    "mpeg2_1080p_ipbb": (".m2vpkts", "ipbb.m2v"),
    "mpeg2_1080i_fieldpic": (".m2vpkts", "fld.m2v"),
    MJPEG_SMOKE: (".mjpegpkts", "frames.mjpeg"),
}


# the MPEG-4 encode of mpeg2_1080p_ipbb's decoded frames: its golden
# holds each packet's size and md5, each anchor's reconstructed planes
# (adler32 and md5 over the coded 1920x1088 Y|U|V) and the md5 of the
# JAX CLI's output for MPEG4_CLI_ARGS (input ipbb.m2v, output out.m4v)
MPEG4_SMOKE = "mpeg4_1080p_from_ipbb"
MPEG4_SOURCE = "mpeg2_1080p_ipbb"
MPEG4_SETTINGS = {"qscale": 6, "gop_size": 12, "b_frames": 2, "bdirect": 7}
MPEG4_CLI_ARGS = ("-c:v", "mpeg4", "-q:v", "6", "-g", "12", "-bf", "2",
                  "-f", "m4v")


def mpeg4_golden_path() -> str:
    return os.path.join(HERE, MPEG4_SMOKE + ".golden.json")


def stream_paths(name: str):
    """(packets, golden) paths of a committed smoke stream."""
    return (os.path.join(HERE, name + CLI_INPUTS[name][0]),
            os.path.join(HERE, name + ".golden.json"))


def framecrc_path(name: str) -> str:
    """The JAX CLI's framecrc output for a committed smoke stream."""
    return os.path.join(HERE, name + ".framecrc")


def show_frames_path(name: str) -> str:
    """The JAX avprobe's `-show_frames` frame section for a stream."""
    return os.path.join(HERE, name + ".show_frames")


def frames_section(avprobe_text: str) -> str:
    """The [frames.frame] blocks of avprobe's output (what follows them,
    [streams.stream] and [format], names the input's path)."""
    for marker in ("[streams.stream]", "[format]"):
        avprobe_text = avprobe_text.split(marker)[0]
    return avprobe_text


def write_cli_input(name: str, directory: str) -> str:
    """Write a committed stream into directory as the file the CLI reads,
    its packets concatenated; -> the path for `-i`."""
    path = os.path.join(directory, CLI_INPUTS[name][1])
    with open(path, "wb") as f:
        f.write(b"".join(read_packets(stream_paths(name)[0])))
    return path


def read_packets(path: str) -> List[bytes]:
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return out
            out.append(f.read(int.from_bytes(hdr, "big")))


def write_packets(path: str, datas: Sequence[bytes]) -> None:
    with open(path, "wb") as f:
        for d in datas:
            f.write(len(d).to_bytes(4, "big"))
            f.write(d)


def digest(frames_planes: Sequence[Sequence[np.ndarray]]) -> Dict:
    """Golden record of decoded frames, each given as host (Y, U, V)."""
    total = hashlib.md5()
    per = []
    for planes in frames_planes:
        data = b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                        for p in planes)
        total.update(data)
        per.append({"adler32": f"0x{zlib.adler32(data, 0) & 0xFFFFFFFF:08x}",
                    "md5": hashlib.md5(data).hexdigest(),
                    "width": int(planes[0].shape[1]),
                    "height": int(planes[0].shape[0])})
    return {"frames": per, "md5_all": total.hexdigest()}


def load_golden(path: str = SMOKE_GOLDEN) -> Dict:
    with open(path) as f:
        return json.load(f)


def idct_blocks(seed, B):
    """(B, 8, 8) int32 inputs for kernel K2's checks, five classes in
    turn: sparse dequantised levels, DC-only rows, all-zero blocks, values
    outside int16 (wrapped by the IDCT), and rows whose sums overflow
    int32 (extreme int16 values signed like a row of the IDCT matrix, or
    anywhere in the int16 range)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2048, 2048, (B, 8, 8))
    x = np.where(rng.random((B, 8, 8)) < 0.3, x, 0)
    cls = np.arange(B) % 5
    dc_rows = (cls == 1)[:, None, None] & \
        (rng.random((B, 8, 1)) < 0.7) & (np.arange(8) > 0)
    x[dc_rows] = 0
    x[cls == 2] = 0
    n3 = int((cls == 3).sum())
    x[cls == 3] = rng.choice([-32769, -32768, 32767, 32768, 65535, 65536,
                              -70001, 100003, 1 << 30, -(1 << 31)],
                             (n3, 8, 8)) * (rng.random((n3, 8, 8)) < 0.5)
    n4 = int((cls == 4).sum())
    sign = np.sign(simple_idct_matrix())[rng.integers(0, 8, (n4, 8))]
    big = np.where(sign >= 0, 32767, -32768)
    x[cls == 4] = np.where(rng.random((n4, 8, 1)) < 0.5, big,
                           rng.integers(-32768, 32768, (n4, 8, 8)))
    return x.astype(np.int32)


def padded_planes(rng, H: int, W: int):
    """Random edge-padded (y, u, v) uint8 planes of an H x W picture."""
    return tuple(rng.integers(0, 256, (h + 2 * EDGE, w + 2 * EDGE))
                 .astype(np.uint8)
                 for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


def _mb_arrays(rng, nmb: int, inter: bool, interlaced: bool, dual: bool):
    coeffs = np.where(rng.random((nmb, 6, 64)) < 0.15,
                      rng.integers(-400, 400, (nmb, 6, 64)), 0)
    coeffs[:, :, 0] = rng.integers(-100, 300, (nmb, 6))
    mv = rng.integers(-40, 41, (2, nmb, 2))
    # every seventh MB points past the reference's margin
    mv[:, ::7] = rng.integers(-200, 200, (2, len(mv[0, ::7]), 2))
    a = dict(coeffs=coeffs.astype(np.int16),
             qscale=rng.integers(1, 63, nmb).astype(np.int32),
             intra=rng.random(nmb) < (0.3 if inter else 2),
             use_fwd=rng.random(nmb) < 0.7, use_bwd=rng.random(nmb) < 0.5,
             mv_fwd=mv[0].astype(np.int32), mv_bwd=mv[1].astype(np.int32),
             intra_q=rng.integers(8, 80, 64).astype(np.int32),
             inter_q=rng.integers(8, 80, 64).astype(np.int32))
    if interlaced:
        a.update(field_mc=rng.random(nmb) < 0.5,
                 dct_field=rng.random(nmb) < 0.5,
                 mvf2=rng.integers(-30, 31, (nmb, 2, 2)).astype(np.int32),
                 mvb2=rng.integers(-30, 31, (nmb, 2, 2)).astype(np.int32),
                 sel_f=rng.integers(0, 2, (nmb, 2)).astype(np.int32),
                 sel_b=rng.integers(0, 2, (nmb, 2)).astype(np.int32))
    if dual:
        a.update(dp=rng.random(nmb) < 0.4,
                 mv_dp2=rng.integers(-30, 31, (nmb, 2, 2)).astype(np.int32),
                 sel_dp=rng.integers(0, 2, (nmb, 2)).astype(np.int32))
    return a


def recon_inputs(seed, mb_w: int, mb_h: int, inter: bool = True,
                 interlaced: bool = False, dual: bool = False):
    """Random (args, kwargs) of numpy arrays for a frame-picture recon
    program (the JAX recon_jit's and the port's `recon`)."""
    rng = np.random.default_rng(seed)
    a = _mb_arrays(rng, mb_w * mb_h, inter, interlaced, dual)
    H, W = 16 * mb_h, 16 * mb_w
    args = [a.pop(k) for k in ("coeffs", "qscale", "intra", "use_fwd",
                               "use_bwd", "mv_fwd", "mv_bwd", "intra_q",
                               "inter_q")]
    return args + [*padded_planes(rng, H, W), *padded_planes(rng, H, W)], a


def recon_field_inputs(seed, mb_w: int, mb_h_f: int, inter: bool = True,
                       dual: bool = False):
    """Random (args, kwargs) of numpy arrays for a field-picture recon
    program (the JAX recon_field_jit's and the port's `recon_field`)."""
    rng = np.random.default_rng(seed)
    a = _mb_arrays(rng, mb_w * mb_h_f, inter, True, dual)
    H, W = 16 * mb_h_f, 16 * mb_w
    args = [a[k] for k in ("coeffs", "qscale", "intra", "use_fwd",
                           "use_bwd", "mvf2", "sel_f", "mvb2", "sel_b",
                           "intra_q", "inter_q")]
    args += [p for _ in range(4) for p in padded_planes(rng, H, W)]
    return args, {k: a[k] for k in ("dp", "mv_dp2", "sel_dp") if dual}
