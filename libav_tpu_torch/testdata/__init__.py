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
encoded video is committed. `mpeg4_asp.golden.json` and
`mpeg4_asp.framecrc` hold the MPEG-4 ASP decode's goldens
(MPEG4_ASP_RUNS), digests and framecrc text only. The H264_EXT streams
(weighted prediction, I_PCM, PAFF, MBAFF) come with their goldens, and
the PAFF one with its framecrc. `filters.golden.json` and
`filters_<run>.framecrc` hold the JAX CLI's outputs for FILTER_RUNS.
`mpeg12_encode.golden.json` holds the JAX MPEG-1/2 encoders' digests for
MPEG12_RUNS on `pattern` frames (the two MPEG-2 streams above are those
encoders' own packets, with MPEG2_STREAMS' settings). LEGACY's streams
(H.263, FLV1, MSMPEG4 v2/v3, WMV1, from `tools/legacy_streams.py`) come
with the JAX decoders' digests in `legacy.golden.json` and the JAX CLI's
`<name>.framecrc`. `prores.golden.json` and `ffv1.golden.json` hold the
JAX ProRes and FFV1 encoders' packet digests and decoders' frame digests
on `pattern10` and `pattern` frames at 1080p, with the JAX CLI's output
of their CLI runs (digests and framecrc text only).
`devices_gop.golden.json` holds the JAX CLI's framecrc of DEVICE_CLI, the
JAX encoders' packet digests and the JAX decoders' frame digests of
GOP_STREAMS, and what the JAX avplay shows of the bench stream.
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
from libav_tpu_torch.ops.prores_dct import idct_matrix_int10
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


# the JAX MPEG-2 encoder's settings for the two committed MPEG-2 streams:
# name -> (frames of `pattern` at 1920x1080, encoder options)
MPEG2_STREAMS = {
    "mpeg2_1080i_fieldpic": (4, {"qscale": 6, "gop_size": 8, "fieldpic": 1,
                                 "fieldstress": "full"}),
    "mpeg2_1080p_ipbb": (7, {"qscale": 6, "gop_size": 8, "b_frames": 2}),
}
# the MPEG-1/2 encoders' runs on MPEG12_FRAMES frames of `pattern` at
# 1920x1080 (mpeg12_encode.golden.json: the source planes' adler32, each
# run's packet sizes and md5s and its anchors' reconstructions): run ->
# (codec, options). The JAX CLI's md5 of MPEG12_CLI's runs on the bench
# stream (bench.h264, 8 frames) are there too.
MPEG12_ENCODE = "mpeg12_encode"
MPEG12_FRAMES = 7
MPEG12_RUNS = {
    "M1": ("mpeg1video", {"qscale": 6, "gop_size": 8, "b_frames": 2,
                          "trellis": 1, "mbcmp": "satd"}),
    "M2aq": ("mpeg2video", {"qscale": 6, "gop_size": 8,
                            "lumi_masking": 0.2, "scplx_masking": 0.3}),
    "M2rc": ("mpeg2video", {"gop_size": 8, "b_frames": 2,
                            "bit_rate": 15000000}),
}
MPEG12_CLI = {
    "out.m2v": ("-c:v", "mpeg2video", "-q:v", "6", "-g", "8", "-bf", "2"),
    "out.ts": ("-an",),
}
# the legacy decoders' streams (tools/legacy_streams.py): name -> (file,
# codec, width, height, pictures); legacy.golden.json holds the JAX
# decoders' digests, <name>.framecrc the JAX CLI's `-i <file> -f framecrc`
LEGACY = {
    "h263_16cif": ("h263_16cif.263", "h263", 1408, 1152, 6),
    "flv1_720p": ("flv1_720p.flv", "flv1", 1280, 720, 6),
    "msmpeg4v3_720p": ("msmpeg4v3_720p.avi", "msmpeg4v3", 1280, 720, 6),
    "msmpeg4v2_720p": ("msmpeg4v2_720p.avi", "msmpeg4v2", 1280, 720, 6),
    "wmv1_720p": ("wmv1_720p.avi", "wmv1", 1280, 720, 6),
}


# the H.264 encoder's settings of the bench stream (h264_1080p_ipbb_cabac:
# 8 frames of the pattern at 1920x1080), a copy of bench.py ENC_SETTINGS
# (the port reads no file of the JAX side; a CPU test holds the two equal)
BENCH_SETTINGS = dict(qp=28, gop_size=8, entropy="cabac", i8x8=1, dct8x8=1,
                      b_frames=2, deblock=1, slices=4)
BENCH_FRAMES = 8
# the encoders through the CLI (encode_cli.golden.json): output name ->
# (input, arguments); the golden holds the md5 of the JAX CLI's output of
# each and the source planes' adler32 of the pattern frames that the
# H.264 encodes of the smoke run take (1920x1080 x 8, 1920x1088 x 4)
ENCODE_CLI = {
    "out.h264": ("mpeg2_1080p_ipbb", (
        "-c:v", "h264", "-qp", "28", "-g", "8", "-entropy", "cabac",
        "-i8x8", "1", "-dct8x8", "1", "-bf", "2", "-deblock", "1",
        "-slices", "4")),
    "out.avi": ("h264_1080p_ipbb_cabac", ("-c:v", "mjpeg", "-q:v", "4")),
}
ENCODE_SOURCES = ((1920, 1080, 8), (1920, 1088, 4))


# the ProRes and FFV1 slice (prores.golden.json, ffv1.golden.json):
# PRORES_FRAMES frames of pattern10 at PRORES_SIZE through the ProRes
# encoder at its defaults (standard profile, rate-controlled), and the
# same frames of `pattern` (8-bit 4:2:0) through the FFV1 encoder with
# FFV1_SETTINGS (range coder, 5-gradient context; the second frame is a
# non-key frame); each golden holds the source planes' adler32, each
# packet's size and md5, the decoded frames' digests and the JAX CLI's
# output for its CLI run: PRORES_CLI on PRORES_CLI_INPUT (PRORES_FRAMES
# frames of pattern10 as yuv422p10le rawvideo) into out.mov, then
# `-i out.mov -f framecrc`; FFV1_CLI on the committed ipbb.m2v into
# out.avi, then `-i out.avi -f framecrc`
PRORES_SIZE = (1920, 1080)
PRORES_FRAMES = 2
PRORES_CLI_INPUT = "p10.yuv"
PRORES_CLI = ("-f", "rawvideo", "-pix_fmt", "yuv422p10le", "-s",
              "1920x1080", "-r", "25", "-i", PRORES_CLI_INPUT, "-frames:v",
              "1", "-c:v", "prores")
FFV1_SETTINGS = {"coder": 1, "context": 1}
FFV1_CLI_SOURCE = "mpeg2_1080p_ipbb"
FFV1_CLI = ("-frames:v", "2", "-c:v", "ffv1")
# pattern10's texture: its seed (plus the frame number) and the noise
# amplitudes a 16x16 square takes; two samples in PATTERN10_SPIKES are
# set to 0 and 1023 (light enough that the rate-controlled 1080p encode
# rarely overquantises a slice: the trellis's host time grows with it)
PATTERN10_SEED = 1010
PATTERN10_AMPLITUDES = (0, 0, 1, 3, 8, 20)
PATTERN10_SPIKES = 65536


def encode_cli_golden_path() -> str:
    return os.path.join(HERE, "encode_cli.golden.json")


def prores_golden_path() -> str:
    return os.path.join(HERE, "prores.golden.json")


def ffv1_golden_path() -> str:
    return os.path.join(HERE, "ffv1.golden.json")


# the capture devices, GOP-parallel decode and avplay (chip_smoke.py phase
# 20; devices_gop.golden.json): each device run's CLI arguments before
# `-f framecrc OUT`, whose JAX-CLI output the golden holds; each
# GOP-parallel stream's codec -> (width, height, frames of the pattern,
# encoder settings), the golden holding the JAX encoder's packets (size,
# md5), the source planes' adler32 and the JAX decoder's frame digests;
# and the frames the JAX avplay shows of the bench stream with -vo null
DEVICE_CLI = {
    "testsrc": ("-f", "testsrc", "-i", "testsrc=1920x1080:rate=25:frames=8"),
    "sine": ("-i", "sine=freq=1000:rate=48000:samples=96000"),
}
GOP_STREAMS = {
    "mpeg2video": (1920, 1080, 8, {"qscale": 6, "gop_size": 2}),
    "h264": (640, 352, 8, {"qp": 28, "gop_size": 2, "deblock": 1}),
}


def devices_gop_golden_path() -> str:
    return os.path.join(HERE, "devices_gop.golden.json")


def write_pattern10_yuv(directory: str, n: int = PRORES_FRAMES) -> str:
    """Write n frames of pattern10 at PRORES_SIZE as yuv422p10le rawvideo
    (little-endian 16-bit samples) into directory: -> its path, the input
    of PRORES_CLI."""
    path = os.path.join(directory, PRORES_CLI_INPUT)
    with open(path, "wb") as f:
        for t in range(n):
            for p in pattern10(*PRORES_SIZE, t):
                f.write(p.astype("<u2").tobytes())
    return path


def mpeg12_golden_path() -> str:
    return os.path.join(HERE, MPEG12_ENCODE + ".golden.json")


def legacy_paths(name: str):
    """(stream file, the JAX CLI's framecrc of it) of a LEGACY stream."""
    return (os.path.join(HERE, LEGACY[name][0]),
            os.path.join(HERE, name + ".framecrc"))


def legacy_golden_path() -> str:
    return os.path.join(HERE, "legacy.golden.json")


# the MPEG-4 encode of mpeg2_1080p_ipbb's decoded frames: its golden
# holds each packet's size and md5, each anchor's reconstructed planes
# (adler32 and md5 over the coded 1920x1088 Y|U|V) and the md5 of the
# JAX CLI's output for MPEG4_CLI_ARGS (input ipbb.m2v, output out.m4v)
MPEG4_SMOKE = "mpeg4_1080p_from_ipbb"
MPEG4_SOURCE = "mpeg2_1080p_ipbb"
MPEG4_SETTINGS = {"qscale": 6, "gop_size": 12, "b_frames": 2, "bdirect": 7}
MPEG4_CLI_ARGS = ("-c:v", "mpeg4", "-q:v", "6", "-g", "12", "-bf", "2",
                  "-f", "m4v")
# MPEG-4 ASP decode (mpeg4_asp.golden.json): the same 7 frames encoded
# three more times, each run's options over MPEG4_SETTINGS (A:
# quarter-sample + MPEG quantiser + AC prediction, no B-VOPs; B: GMC
# S-VOPs with 3 warping points at 1/16 pel and B-VOPs; C: video packets
# of 8192 bytes, data partitioning, the SATD decision); its golden holds
# each run's packet digests and the JAX decoder's frame digests, those of
# the phase-10 packets (MPEG4_SETTINGS), those of C with packet
# MPEG4_ASP_CUT (a P-VOP) cut to its first half, and the JAX CLI's
# framecrc of A's packets written as asp.m4v
MPEG4_ASP = "mpeg4_asp"
MPEG4_ASP_RUNS = {
    "A": {"qpel": 1, "mpegq": 1, "acpred": 1, "b_frames": 0},
    "B": {"gmc": 3, "gmc_acc": 3, "b_frames": 2},
    "C": {"ps": 8192, "data_partitioning": 1, "mbcmp": "satd",
          "b_frames": 2},
}
MPEG4_ASP_CUT = 1


# H.264 streams of the decoder's features past the bench stream, in
# bench.py's moving pattern: name -> (width, height, frames, the JAX
# encoder's options). Each is stored as <name>.h264pkts with the JAX
# decoder's digests in <name>.golden.json; the PAFF one also as a CLI
# input (paff.h264) with the JAX CLI's framecrc. fieldpic and mbaff need
# height % 32 == 0, and the JAX encoder takes mbaff without deblock only.
H264_EXT = {
    # explicit weighted P and B (pred_weight_table per slice)
    "h264_1080p_wp_explicit": (1920, 1080, 5, {
        "qp": 28, "gop_size": 8, "entropy": "cabac", "deblock": 1,
        "b_frames": 2, "weightp": 1, "weightb": "explicit"}),
    # explicit weighted P, implicit (POC-distance) weighted B
    "h264_1080p_wp_implicit": (1920, 1080, 5, {
        "qp": 28, "gop_size": 8, "entropy": "cabac", "deblock": 1,
        "b_frames": 1, "weightp": 1, "weightb": "implicit",
        "parts": "all"}),
    # every 16th MB of the I frames raw (I_16x16 intra only)
    "h264_1080p_ipcm": (1920, 1080, 4, {
        "qp": 28, "gop_size": 3, "entropy": "cabac", "deblock": 1,
        "ipcm": 16}),
    # field pictures, bottom fields referencing the same frame's top
    # field (cross-parity chroma offset), field deblock
    "h264_1088i_paff": (1920, 1088, 4, {
        "qp": 28, "gop_size": 6, "entropy": "cabac", "deblock": 1,
        "i4x4": 1, "fieldpic": 1, "fieldref": "pair"}),
    # all-field MBAFF I and P frames
    "h264_1088i_mbaff": (1920, 1088, 4, {
        "qp": 28, "gop_size": 6, "entropy": "cabac", "i4x4": 1,
        "mbaff": 1}),
}
# H264_EXT streams that are also CLI inputs -> the CLI's input file name
H264_EXT_CLI = {"h264_1088i_paff": "paff.h264"}

# the config-5 chain: name -> (codec, seconds, channels, encoder
# options, signal seed) of a committed audio stream (the CLI's input
# file as it is), the JAX CLI's arguments on each, and the video runs
# (committed stream, arguments) whose framecrc the JAX CLI wrote
AUDIO_STREAMS = {
    "ac3_50_48k": ("ac3", 10.0, 5, {"bitrate_kbps": 384}, 50),
    "ac3_20_48k": ("ac3", 10.0, 2, {"bitrate_kbps": 192}, 20),
    "aac_lc_48k": ("aac", 5.0, 2, {"quality": 10}, 2),
}
AUDIO_EXT = {"ac3": ".ac3", "aac": ".aac"}
AUDIO_RUNS = {
    "ac3_50_48k": ("-ar", "44100", "-ac", "2", "-f", "s16le"),
    "ac3_20_48k": ("-ar", "44100", "-ac", "2", "-f", "s16le"),
    "aac_lc_48k": ("-ar", "44100", "-f", "s16le"),
}
# runs whose s16 output is kept (zlib) to count differing samples
AUDIO_PCM_KEPT = ("aac_lc_48k",)
VIDEO_RUNS = {
    "h264_rgb24": ("h264_1080p_ipbb_cabac", ("-pix_fmt", "rgb24")),
    "mjpeg_rgb24": (MJPEG_SMOKE, ("-pix_fmt", "rgb24")),
    "h264_s1280x720": ("h264_1080p_ipbb_cabac", ("-s", "1280x720")),
}


# the filter slice: run -> (the committed streams it reads, as CLI inputs
# in order, and the JAX CLI's arguments after the inputs). The JAX CLI's
# output on them is filters_<run>.framecrc, or its md5 in
# filters.golden.json where the output is an encode (A) or PCM (E_af).
# "bench.mp4" is the bench stream muxed into MP4 with -c copy
# (FILTER_MP4_ARGS): raw H.264 frames carry no timestamps, and fps needs
# them. Every video input is a 1080-line stream of the repository.
FILTER_MP4 = "bench.mp4"
FILTER_MP4_ARGS = ("-c", "copy")
FILTER_RUNS = {
    # 1080i deinterlace at field rate, then the MPEG-4 transcode
    "A_yadif": (("mpeg2_1080i_fieldpic",),
                ("-vf", "yadif=1", *MPEG4_CLI_ARGS)),
    # the pixel filters on the H.264 bench stream
    "B_pixel": (("h264_1080p_ipbb_cabac",),
                ("-vf", "crop=1280:720:320:180,hqdn3d,unsharp=5:5:1.0,"
                        "boxblur=2:1,drawbox=64:64:320:180:red,fade=in:0:4,"
                        "lutyuv=y=negval,hflip,transpose=1",
                 "-f", "framecrc")),
    # a chain that ends in RGB (sws_yuv2rgb)
    "C_rgb": (("h264_1080p_ipbb_cabac",),
              ("-vf", "pad=1920:1088:0:4,gradfun,"
                      "delogo=x=100:y=100:w=200:h=80,vflip",
               "-pix_fmt", "rgb24", "-f", "framecrc")),
    # a graph with a second input (the MJPEG stream, decoded up front)
    "D_overlay": (("h264_1080p_ipbb_cabac", MJPEG_SMOKE),
                  ("-filter_complex", "[0:v][1:v]overlay=64:64", "-f",
                   "framecrc")),
    # an audio chain
    "E_af": (("ac3_20_48k",),
             ("-af", "volume=0.5,aresample=44100", "-f", "s16le")),
    "E_interlace": (("h264_1080p_ipbb_cabac",),
                    ("-vf", "interlace", "-f", "framecrc")),
    "E_fps": ((FILTER_MP4,), ("-vf", "fps=12", "-f", "framecrc")),
}


def filter_run_path(run: str) -> str:
    """The JAX CLI's framecrc of a framecrc run of FILTER_RUNS."""
    return os.path.join(HERE, "filters_" + run + ".framecrc")


def filters_golden_path() -> str:
    return os.path.join(HERE, "filters.golden.json")


def filter_inputs(run: str, directory: str) -> List[str]:
    """Write a FILTER_RUNS run's inputs into directory; -> the paths for
    its `-i` options, in order. bench.mp4 must be there already (the
    CLI's -c copy mux of the bench stream)."""
    out = []
    for name in FILTER_RUNS[run][0]:
        if name == FILTER_MP4:
            out.append(os.path.join(directory, FILTER_MP4))
        elif name in AUDIO_STREAMS:
            out.append(audio_path(name))
        else:
            out.append(write_cli_input(name, directory))
    return out


def audio_path(name: str) -> str:
    return os.path.join(HERE, name + AUDIO_EXT[AUDIO_STREAMS[name][0]])


def pcm_golden_path(name: str) -> str:
    return os.path.join(HERE, name + ".s16.zlib")


def video_run_path(run: str) -> str:
    return os.path.join(HERE, "config5_" + run + ".framecrc")


def config5_golden_path() -> str:
    return os.path.join(HERE, "config5.golden.json")


def mpeg4_golden_path() -> str:
    return os.path.join(HERE, MPEG4_SMOKE + ".golden.json")


def mpeg4_asp_paths():
    """(golden JSON, the JAX CLI's framecrc of asp.m4v) of the ASP
    decode."""
    return (os.path.join(HERE, MPEG4_ASP + ".golden.json"),
            os.path.join(HERE, MPEG4_ASP + ".framecrc"))


def mpeg4_asp_settings(run: str) -> Dict:
    return {**MPEG4_SETTINGS, **MPEG4_ASP_RUNS[run]}


def cut_packet(datas: Sequence[bytes], index: int) -> List[bytes]:
    """datas with packet index cut to its first half (a damaged video
    packet for the decoders' concealment)."""
    out = list(datas)
    out[index] = datas[index][:len(datas[index]) // 2]
    return out


def stream_paths(name: str):
    """(packets, golden) paths of a committed smoke stream."""
    suffix = CLI_INPUTS[name][0] if name in CLI_INPUTS else ".h264pkts"
    return (os.path.join(HERE, name + suffix),
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
    path = os.path.join(directory, CLI_INPUTS[name][1] if name in CLI_INPUTS
                        else H264_EXT_CLI[name])
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


def digest(frames_planes: Sequence[Sequence[np.ndarray]],
           dtype=np.uint8) -> Dict:
    """Golden record of decoded frames, each given as host (Y, U, V), the
    samples as dtype ("<u2" for 10-bit planes, as rawvideo stores them)."""
    total = hashlib.md5()
    per = []
    for planes in frames_planes:
        data = b"".join(np.ascontiguousarray(p, dtype).tobytes()
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


RGB2YUV_SAMPLES = os.path.join(HERE, "rgb2yuv_samples.json")
# chroma block (rows, columns) by subsampling
_CHROMA_BLOCK = {"444": (1, 1), "422": (1, 2), "420": (2, 2),
                 "440": (2, 1), "411": (1, 4), "410": (4, 4)}


def rgb2yuv_units(fmt: str) -> np.ndarray:
    """uint8 (n, rows, cols, 3): the RGB blocks, one per chroma sample of
    fmt (yuv/yuvj 444/422/420p, yuv440/411/410p), on which the port's
    RGB -> YUV rounding
    and another plausible order of the same float32 arithmetic give
    different bytes (tools/gen_rgb2yuv_samples.py)."""
    sub = fmt[-4:-1]
    with open(RGB2YUV_SAMPLES) as f:
        units = json.load(f)["samples"][
            "full" if fmt.startswith("yuvj") else "limited"][sub]
    fh, fw = _CHROMA_BLOCK[sub]
    return np.array([u["rgb"] for u in units], np.uint8).reshape(
        -1, fh, fw, 3)


def rgb2yuv_frame(h: int, w: int, fmt: str) -> np.ndarray:
    """uint8 (h, 3w) rgb24 frame of `rgb2yuv_units(fmt)`: chroma block
    (i, j) holds unit (i + j) mod n, so with n chroma rows or more every
    unit meets every chroma column (and so every place in a vectorised
    or unrolled loop)."""
    units = rgb2yuv_units(fmt)
    n, fh, fw, _ = units.shape
    ch, cw = -(-h // fh), -(-w // fw)
    pick = (np.arange(ch)[:, None] + np.arange(cw)[None, :]) % n
    img = units[pick].transpose(0, 2, 1, 3, 4).reshape(ch * fh, cw * fw, 3)
    return np.ascontiguousarray(img[:h, :w].reshape(h, 3 * w))


def pattern(width: int, height: int, t: int):
    """Frame t of bench.py's moving test pattern as host 4:2:0 (Y, U, V)
    uint8 planes, chroma ((height + 1) // 2, (width + 1) // 2): the
    source of the committed MPEG-1/2 encodes' goldens, which
    `tools/gen_torch_smoke_stream.py` builds its frames from."""
    yy, xx = np.mgrid[0:height, 0:width]
    y = ((xx // 2 + yy // 3 + t * 4) % 256).astype(np.uint8)
    yy, xx = np.mgrid[0:(height + 1) // 2, 0:(width + 1) // 2]
    u = (128 + 54 * np.sin((xx + 3 * t) / 9.0)).astype(np.uint8)
    v = (128 + 54 * np.cos((yy - 2 * t) / 7.0)).astype(np.uint8)
    return y, u, v


def pattern_fade(width: int, height: int, t: int):
    """Frame t of `pattern` dipped toward black, as at a programme break:
    luma y * (32 - 2t) // 32, chroma 128 + (c - 128) * (32 - 2t) // 32
    (floor division). No anchor predicts a faded MB exactly, so the
    MPEG-2 encoder's B pictures carry bi-predicted MBs, which the plain
    pattern's pure translation never gives them. The source of the fade
    GOP of the `mpeg2_mp_1080p` benchmark configuration
    (`tools/gen_torch_smoke_stream.py mpeg2fade`)."""
    gain = 32 - 2 * t
    y, u, v = (p.astype(np.int32) for p in pattern(width, height, t))
    y = y * gain // 32
    u, v = (128 + (c - 128) * gain // 32 for c in (u, v))
    return tuple(p.astype(np.uint8) for p in (y, u, v))


def pattern10(width: int, height: int, t: int,
              fmt: str = "yuv422p10le"):
    """Frame t of a 10-bit 4:2:2 (yuv422p10le) or 4:4:4 (yuv444p10le)
    source, as host (Y, U, V) uint16 planes: `pattern` scaled to 10 bits
    (chroma repeated to full height, and to full width at 4:4:4), plus a
    texture from numpy.random.default_rng(PATTERN10_SEED + t): each 16x16
    square takes one of PATTERN10_AMPLITUDES for its noise, and two
    samples in PATTERN10_SPIKES are set to 0 and 1023, so the ProRes
    encoder meets flat and busy slices, long and short runs and large
    levels (every AC codebook), and samples at both ends of the range."""
    if fmt not in ("yuv422p10le", "yuv444p10le"):
        raise ValueError(f"pattern10: no {fmt} source")
    rng = np.random.default_rng(PATTERN10_SEED + t)
    amplitudes = np.array(PATTERN10_AMPLITUDES)
    planes = []
    for p, src in enumerate(pattern(width, height, t)):
        base = src.astype(np.int32) << 2
        if p:
            base = np.repeat(base, 2, axis=0)[:height]
            if fmt == "yuv444p10le":
                base = np.repeat(base, 2, axis=1)[:, :width]
        h, w = base.shape
        amp = amplitudes[rng.integers(0, len(amplitudes),
                                      (-(-h // 16), -(-w // 16)))]
        amp = np.repeat(np.repeat(amp, 16, axis=0), 16, axis=1)[:h, :w]
        x = base + rng.integers(-256, 257, (h, w)) * amp // 256
        spikes = rng.integers(0, PATTERN10_SPIKES, (h, w))
        x = np.where(spikes == 0, 0, np.where(spikes == 1, 1023, x))
        planes.append(np.clip(x, 0, 1023).astype(np.uint16))
    return tuple(planes)


def plane_adler32(planes, dtype=np.uint8) -> List[str]:
    """adler32 (seed 1, as zlib computes it) of each plane's bytes, the
    samples as dtype."""
    return ["0x%08x" % (zlib.adler32(np.ascontiguousarray(p, dtype)
                                     .tobytes()) & 0xFFFFFFFF)
            for p in planes]


def prores_idct_inputs(seed, B):
    """((B, 64) coefficients, (B, 64) scaled quant rows) int32 for
    prores_idct, five classes in turn: sparse levels under a plausible
    scaled matrix (4-255 times a slice factor of 1-512, int16-wrapped
    like the decoder's rows), DC-only blocks, dense products that wrap
    int16, rows whose sums overflow int32 (+-32767 signed like a row of
    the IDCT matrix, or anywhere in the int16 range, with a unit
    quantiser), and all-zero blocks."""
    rng = np.random.default_rng(seed)
    cls = np.arange(B) % 5
    c = rng.integers(-2048, 2049, (B, 64)) * (rng.random((B, 64)) < 0.3)
    q = rng.integers(4, 256, (B, 64)) * rng.integers(1, 513, (B, 1))
    q = ((q + 0x8000) & 0xFFFF) - 0x8000
    dc = cls == 1
    c[dc, 1:] = 0
    c[dc, 0] = rng.integers(-4096, 4097, int(dc.sum()))
    wrap = cls == 2
    n2 = int(wrap.sum())
    c[wrap] = rng.integers(256, 4097, (n2, 64)) * \
        rng.choice([-1, 1], (n2, 64))
    q[wrap] = rng.integers(64, 32768, (n2, 64)) * \
        rng.choice([-1, 1], (n2, 64))
    big = cls == 3
    n3 = int(big.sum())
    sign = np.sign(idct_matrix_int10())[rng.integers(0, 8, (n3, 8))]
    ext = np.where(sign >= 0, 32767, -32767)
    c[big] = np.where(rng.random((n3, 8, 1)) < 0.5, ext,
                      rng.integers(-32768, 32768, (n3, 8, 8))
                      ).reshape(n3, 64)
    q[big] = 1
    c[cls == 4] = 0
    return c.astype(np.int32), q.astype(np.int32)


def prores_fdct_inputs(seed, B):
    """(B, 8, 8) int32 10-bit samples for fdct10, five classes in turn:
    uniform 0-1023, flat 0, flat 1023, a 0/1023 checkerboard, and a
    smooth ramp with a few samples at 0 and 1023."""
    rng = np.random.default_rng(seed)
    cls = np.arange(B) % 5
    x = rng.integers(0, 1024, (B, 8, 8))
    x[cls == 1] = 0
    x[cls == 2] = 1023
    yy, xx = np.mgrid[0:8, 0:8]
    x[cls == 3] = np.where((yy + xx) % 2, 1023, 0)
    ramp = cls == 4
    n4 = int(ramp.sum())
    r = rng.integers(0, 900, (n4, 1, 1)) + 9 * (yy + xx)[None]
    r = np.where(rng.random((n4, 8, 8)) < 0.05,
                 rng.choice([0, 1023], (n4, 8, 8)), r)
    x[ramp] = r
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
                 interlaced: bool = False, dual: bool = False,
                 four_mv: bool = False):
    """Random (args, kwargs) of numpy arrays for a frame-picture recon
    program (the JAX recon_jit's and the port's `recon`); four_mv adds
    the 4MV inputs use4, mv4f and mv4b."""
    rng = np.random.default_rng(seed)
    a = _mb_arrays(rng, mb_w * mb_h, inter, interlaced, dual)
    if four_mv:
        nmb = mb_w * mb_h
        mv4 = rng.integers(-40, 41, (2, nmb, 4, 2))
        mv4[:, ::5] = rng.integers(-200, 200, (2, len(mv4[0, ::5]), 4, 2))
        a.update(use4=rng.random(nmb) < 0.5,
                 mv4f=mv4[0].astype(np.int32), mv4b=mv4[1].astype(np.int32))
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
