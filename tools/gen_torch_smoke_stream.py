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
    mpeg4   mpeg4_1080p_from_ipbb.golden.json: mpeg2_1080p_ipbb decoded
            and encoded with the MPEG-4 encoder (testdata.MPEG4_SETTINGS),
            each packet's size and md5 and each anchor's reconstruction;
            and the md5 of `libav_tpu.tools.avconv -i ipbb.m2v
            <testdata.MPEG4_CLI_ARGS> out.m4v`
    mpeg4asp  mpeg4_asp.{golden.json,framecrc}: the same 7 frames
            encoded with each of testdata.MPEG4_ASP_RUNS (qpel + mpegq +
            acpred; gmc 3 points with B-VOPs; video packets + data
            partitioning + satd), each packet's size and md5 and the JAX
            decoder's frame digests; the JAX decoder's digests of the
            MPEG4_SETTINGS packets and of run C with packet
            MPEG4_ASP_CUT cut in half; and the framecrc of
            `libav_tpu.tools.avconv -i asp.m4v -f framecrc` on run A's
            packets (~15 min)
    h264ext the H.264 streams of testdata.H264_EXT (explicit and implicit
            weighted prediction, I_PCM, PAFF, MBAFF; 4-5 frames each):
            <name>.{h264pkts,golden.json}, and <name>.framecrc of the
            JAX CLI on the PAFF one written as paff.h264 (~10 min)
    config5 the config-5 chain (testdata.AUDIO_STREAMS, AUDIO_RUNS,
            VIDEO_RUNS): AC-3 5.0 and stereo and ADTS AAC-LC streams
            encoded from audio_signal(); config5.golden.json with the md5
            of the JAX CLI's `-ar 44100 [-ac 2] -f s16le` output on each,
            the AAC one's s16 PCM itself (zlib), and the JAX CLI's
            framecrc of `-pix_fmt rgb24` on the H.264 and MJPEG streams
            and of `-s 1280x720` on the H.264 stream
    containers  phase 15's goldens (testdata/containers.py): the md5 of
            the JAX CLI's -c copy muxes of the H.264, AAC and AC-3
            streams into MP4, Matroska and MPEG-TS, its framecrc of each
            (container_{mp4,mkv,ts}.framecrc), its transcode of the
            Matroska file to MPEG-4 + AAC (packet md5s; the AAC packets
            themselves in transcode_aac.jax.pkts), and the JAX MP1, MP2,
            MP3 (also joint stereo), FLAC and AC-3 encoders on the stereo
            AC-3 stream's first 3 s, decoded (packet md5s and the
            decoders' PCM md5; the AC-3 packets in encode_ac3.jax.pkts);
            containers.golden.json (~2 min; needs config5's streams)
    filters the filter slice's runs (testdata.FILTER_RUNS): the JAX CLI
            with -vf, -af and -filter_complex on the committed streams as
            CLI input files: filters_<run>.framecrc for the framecrc runs,
            and filters.golden.json with the md5 of the others (the
            yadif + MPEG-4 transcode, the -af PCM) and of the -c copy mux
            of the bench stream into bench.mp4 (~10 min; needs the
            streams and config5's AC-3 stream)
    mpeg12enc  mpeg12_encode.golden.json: testdata.MPEG12_RUNS (MPEG-1
            with B-frames, trellis and SATD; MPEG-2 with adaptive
            quantisation; MPEG-2 with rate control at 15 Mbit/s) on 7
            frames of the pattern at 1920x1080 through the JAX encoders,
            each packet's size and md5 and each anchor's reconstruction,
            the source planes' adler32, and the md5 of the JAX CLI's
            testdata.MPEG12_CLI runs on bench.h264 (~10 min)
    h264enc encode_cli.golden.json: the md5 of the JAX CLI's output for
            testdata.ENCODE_CLI (the committed ipbb.m2v to H.264 with the
            bench settings; bench.h264 to MJPEG in AVI) and the adler32 of
            the pattern planes of testdata.ENCODE_SOURCES (~3 min)
    prores  prores.golden.json: testdata.PRORES_FRAMES frames of
            testdata.pattern10 at 1920x1080 (yuv422p10le) through the JAX
            ProRes encoder at its defaults (standard profile,
            rate-controlled): the source planes' adler32, each packet's
            size and md5, the JAX decoder's frame digests (16-bit
            little-endian samples), and the md5 of the JAX CLI's
            testdata.PRORES_CLI run with its `-i out.mov -f framecrc`
            output (~2 min)
    ffv1    ffv1.golden.json: the same frames of testdata.pattern (8-bit
            4:2:0) through the JAX FFV1 encoder with
            testdata.FFV1_SETTINGS: the source planes' adler32, each
            packet's size, md5 and key flag, the JAX decoder's frame
            digests, and the md5 of the JAX CLI's testdata.FFV1_CLI run
            on ipbb.m2v with its `-i out.avi -f framecrc` output (~1 min)
    devgop  devices_gop.golden.json: the JAX CLI's framecrc of
            testdata.DEVICE_CLI (testsrc at 1920x1080, 8 frames; a 2 s
            sine), testdata.GOP_STREAMS (8 pattern frames at GOP 2: MPEG-2
            at 1920x1080, H.264 with deblocking at 640x352) through the
            JAX encoders, each packet's size and md5 with the source
            planes' adler32 and the JAX decoder's frame digests, and the
            "N frames shown, M dropped" line of the JAX avplay with -vo
            null on bench.h264 (~3 min)
    legacy  testdata.LEGACY's streams from tools/legacy_streams.py (H.263
            16CIF as .263; FLV1, MSMPEG4 v3, v2 and WMV1 at 1280x720 in
            FLV and AVI; 6 pictures each), legacy.golden.json with the JAX
            decoders' digests (a stream whose decode warns or conceals is
            refused), and <name>.framecrc of the JAX CLI on each file

The machine with the GPU has no jax, so the port's smoke run reads these
files instead of encoding. Run from the repository root (no argument
writes all of them; the H.264 stream takes ~80 s, each MPEG-2 one ~25 s;
framecrc, mpeg4 and config5 need the streams written first):

    JAX_PLATFORMS=cpu python tools/gen_torch_smoke_stream.py \
        [h264] [mpeg2] [mjpeg] [small] [framecrc] [mpeg4] [mpeg4asp] \
        [h264ext] [config5] [containers] [filters] [mpeg12enc] [legacy] \
        [h264enc] [prores] [ffv1] [devgop]
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

def pattern(width: int, height: int, t: int, pix_fmt: str = "yuv420p"):
    """Frame t of bench.py's moving test pattern (`testdata.pattern`), as
    a host 4:2:0 Frame."""
    from libav_tpu.avutil.frame import Frame
    f = Frame.alloc_video(width, height, pix_fmt)
    planes = testdata.pattern(width, height, t)
    assert [p.shape for p in planes] == [p.shape for p in f.planes[:3]]
    f.planes[:3] = planes
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


def audio_signal(seconds: float, channels: int, seed: int,
                 rate: int = 48000) -> np.ndarray:
    """(channels, n) float32 test audio from a seed: per channel four
    tones at random frequencies and phases plus one-pole low-passed
    noise, scaled to a peak of -12 dBFS (0.25). Broadband, because SBR's
    inverse filtering dislikes pure tones."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    out = np.empty((channels, n))
    for c in range(channels):
        x = sum(a * np.sin(2 * np.pi * f * t + ph) for a, f, ph in zip(
            rng.uniform(0.2, 1.0, 4), rng.uniform(60, 12000, 4),
            rng.uniform(0, 2 * np.pi, 4)))
        noise = rng.standard_normal(n)
        lp = np.empty(n)
        acc = 0.0
        k = rng.uniform(0.02, 0.1)
        for i in range(n):          # one-pole low-pass, pole 1 - k
            acc += k * (noise[i] - acc)
            lp[i] = acc
        x = x + 4.0 * lp
        out[c] = 0.25 * x / np.abs(x).max()
    return out.astype(np.float32)


def encode_audio(codec_id: str, signal: np.ndarray, opts,
                 rate: int = 48000) -> bytes:
    """signal (channels, n) float32 at rate through the JAX package's
    encoder ('ac3' with bitrate_kbps, 'aac' ADTS with quality, sbr, ps):
    the elementary stream as one file's bytes."""
    from libav_tpu.avutil.frame import Frame
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_encoder
    ch, n = signal.shape
    par = CodecParameters(codec_type=MediaType.AUDIO, codec_id=codec_id,
                          sample_rate=rate, channels=ch, sample_fmt="fltp")
    enc = find_encoder(codec_id)(par)
    for k, v in opts.items():
        enc.set_opt(k, v)
    f = Frame(nb_samples=n, sample_rate=rate, format="fltp", channels=ch)
    f.planes = [signal[c] for c in range(ch)]
    return b"".join(p.data for p in enc.encode_all([f]))


def write_config5():
    """The config-5 chain's inputs and the JAX CLI's outputs on them."""
    import hashlib
    import zlib
    from libav_tpu.tools import avconv
    gold = {"audio": {}, "video": {}}
    for name, (codec, seconds, channels, opts, seed) in \
            testdata.AUDIO_STREAMS.items():
        data = encode_audio(codec, audio_signal(seconds, channels, seed),
                            opts)
        with open(testdata.audio_path(name), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes")
    work = tempfile.mkdtemp()
    try:
        for name, args in testdata.AUDIO_RUNS.items():
            out = os.path.join(work, name + ".raw")
            if avconv.main(["-i", testdata.audio_path(name), *args,
                            out]) != 0:
                raise SystemExit(f"avconv failed on {name}")
            with open(out, "rb") as f:
                pcm = f.read()
            gold["audio"][name] = {"args": list(args), "bytes": len(pcm),
                                   "md5": hashlib.md5(pcm).hexdigest()}
            if name in testdata.AUDIO_PCM_KEPT:
                with open(testdata.pcm_golden_path(name), "wb") as f:
                    f.write(zlib.compress(pcm, 9))
            print(f"{name} {' '.join(args)}: {len(pcm)} bytes")
        for run, (name, args) in testdata.VIDEO_RUNS.items():
            out = os.path.join(work, run + ".framecrc")
            if avconv.main(["-i", testdata.write_cli_input(name, work),
                            *args, "-f", "framecrc", out]) != 0:
                raise SystemExit(f"avconv failed on {run}")
            shutil.copyfile(out, testdata.video_run_path(run))
            gold["video"][run] = {"input": name, "args": list(args)}
            print(f"{run}.framecrc written")
    finally:
        shutil.rmtree(work)
    with open(testdata.config5_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


def vop_types(datas):
    """vop_coding_type of each MPEG-4 packet, as a letter."""
    return ["IPBS"[d[d.index(b"\x00\x00\x01\xb6") + 4] >> 6]
            for d in datas]


def write_containers():
    """Phase 15's goldens (testdata/containers.py): the JAX CLI's muxes,
    framecrc and transcode, and the JAX audio encoders on the AC-3
    stream's decoded PCM."""
    import hashlib
    import zlib
    from libav_tpu.avutil.frame import Frame, Packet
    from libav_tpu.codecs import api
    from libav_tpu.formats import FormatContext
    from libav_tpu.tools import avconv
    from libav_tpu_torch.testdata import containers as C

    def md5(path):
        with open(path, "rb") as f:
            return hashlib.md5(f.read()).hexdigest()

    gold = {"mux": {}, "encodes": {}}
    work = tempfile.mkdtemp()
    try:
        C.write_inputs(work)

        def run(*args):
            if avconv.main(C.in_dir(args, work)) != 0:
                raise SystemExit(f"avconv {' '.join(args)} failed")

        for out, args in C.MUX:
            run(*args, out)
            gold["mux"][out] = md5(os.path.join(work, out))
        for out, args in C.FRAMECRC.items():
            crc = os.path.join(work, out + ".framecrc")
            run("-i", out, *args, "-f", "framecrc", crc)
            shutil.copyfile(crc, C.framecrc_path(out))
        pcm = os.path.join(work, "mp4.s16")
        run("-i", "out.mp4", *C.MP4_PCM, pcm)
        with open(pcm, "rb") as f, \
                open(testdata.pcm_golden_path("aac_lc_48k"), "rb") as g:
            if f.read() != zlib.decompress(g.read()):
                raise SystemExit("out.mp4's AAC decodes apart from the "
                                 "ADTS stream's committed PCM")
        src, args, dst = C.TRANSCODE
        run("-i", src, *args, dst)
        dst = os.path.join(work, dst)
        _, video = C.read_stream(FormatContext, dst, api.MediaType.VIDEO)
        apar, audio = C.read_stream(FormatContext, dst, api.MediaType.AUDIO)
        types = vop_types([p.data for p in video])
        testdata.write_packets(C.JAX_PACKETS["aac"],
                               [bytes(p.data) for p in audio])
        gold["transcode"] = {
            "md5": md5(dst),
            "video_md5": [C.md5(bytes(p.data)) for p in video],
            "vop_types": "".join(types),
            "anchors": sum(t != "B" for t in types),
            "audio_md5": [C.md5(bytes(p.data)) for p in audio],
            "audio_extradata": apar.extradata.hex(),
            "sample_rate": apar.sample_rate, "channels": apar.channels}
    finally:
        shutil.rmtree(work)
    src = C.source_pcm(api, FormatContext, testdata.audio_path(C.SOURCE))
    gold["source"] = {"samples": src.shape[1], "md5": C.pcm_md5(src)}
    for run_name, (codec, opts) in C.ENCODES.items():
        datas = C.encode(api, Frame, codec, opts, src)
        pcm = C.decode_back(api, Packet, codec, datas)
        gold["encodes"][run_name] = {
            "packets": [C.md5(d) for d in datas], "pcm_md5": C.pcm_md5(pcm),
            "pcm_shape": list(pcm.shape)}
        print(f"{run_name}: {len(datas)} packets")
    datas = C.encode(api, Frame, *C.AC3, src)
    testdata.write_packets(C.JAX_PACKETS["ac3"], datas)
    gold["ac3"] = {"packets": [C.md5(d) for d in datas]}
    with open(C.GOLDEN, "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"{C.GOLDEN} written")


def write_filters():
    """The JAX CLI's outputs for testdata.FILTER_RUNS: text only."""
    import hashlib
    import time
    from libav_tpu.tools import avconv
    gold = {"runs": {}}
    work = tempfile.mkdtemp()
    try:
        bench = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        mp4 = os.path.join(work, testdata.FILTER_MP4)
        if avconv.main(["-i", bench, *testdata.FILTER_MP4_ARGS, mp4]) != 0:
            raise SystemExit("avconv -c copy to MP4 failed")
        with open(mp4, "rb") as f:
            gold["mp4"] = {"args": list(testdata.FILTER_MP4_ARGS),
                           "md5": hashlib.md5(f.read()).hexdigest()}
        for run, (names, args) in testdata.FILTER_RUNS.items():
            argv = [a for path in testdata.filter_inputs(run, work)
                    for a in ("-i", path)] + list(args)
            framecrc = "framecrc" in args
            out = os.path.join(work, run + (".framecrc" if framecrc
                                            else ".out"))
            t0 = time.perf_counter()
            if avconv.main(argv + [out]) != 0:
                raise SystemExit(f"avconv failed on {run}")
            seconds = time.perf_counter() - t0
            entry = {"inputs": list(names), "args": list(args)}
            if framecrc:
                shutil.copyfile(out, testdata.filter_run_path(run))
                with open(out) as f:
                    entry["frames"] = sum(1 for ln in f
                                          if ln.startswith("0,"))
            else:
                with open(out, "rb") as f:
                    data = f.read()
                entry.update(size=len(data),
                             md5=hashlib.md5(data).hexdigest())
            gold["runs"][run] = entry
            print(f"{run}: {entry} ({seconds:.1f} s)")
    finally:
        shutil.rmtree(work)
    with open(testdata.filters_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


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


def encode_mpeg4(frames, settings):
    """frames through the JAX package's MPEG-4 encoder: (packet bytes,
    the anchors' reconstructed coded (Y, U, V) planes in coding order)."""
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_encoder
    from libav_tpu.ops.mc import EDGE
    f0 = frames[0]
    enc = find_encoder("mpeg4")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg4", width=f0.width,
        height=f0.height, pix_fmt="yuv420p"))
    for k, v in settings.items():
        enc.set_opt(k, v)
    anchors = []
    code_anchor = enc._code_anchor

    def recorded(*args):
        pkt = code_anchor(*args)
        anchors.append([np.asarray(p)[EDGE:-EDGE, EDGE:-EDGE]
                        for p in enc._refs])
        return pkt
    enc._code_anchor = recorded
    return [p.data for p in enc.encode_all(frames)], anchors


def encode_mpeg12(codec, nframes, settings, width=1920, height=1080):
    """nframes of the pattern through the JAX package's MPEG-1/2 encoder:
    (packet bytes, the anchors' reconstructed coded (Y, U, V) planes in
    coding order)."""
    from libav_tpu.avutil.rational import Rational
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_encoder
    from libav_tpu.ops.mc import EDGE
    enc = find_encoder(codec)(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=width,
        height=height, pix_fmt="yuv420p", framerate=Rational(25, 1)))
    for k, v in settings.items():
        enc.set_opt(k, v)
    anchors = []
    inner = enc._encode_anchor

    def recorded(*args):
        pkt = inner(*args)
        anchors.append([np.asarray(p)[EDGE:-EDGE, EDGE:-EDGE]
                        for p in enc._refs])
        return pkt
    enc._encode_anchor = recorded
    datas = [p.data for p in enc.encode_all(
        [pattern(width, height, t) for t in range(nframes)])]
    return datas, anchors


def write_mpeg12():
    """The MPEG-1/2 encoders' goldens: the source planes' adler32, each
    MPEG12_RUNS run's packets and anchors, and the JAX CLI's MPEG12_CLI
    runs on bench.h264 (digests only)."""
    import hashlib
    from libav_tpu.tools import avconv
    n = testdata.MPEG12_FRAMES
    gold = {"frames": n, "width": 1920, "height": 1080,
            "source": [testdata.plane_adler32(testdata.pattern(1920, 1080, t))
                       for t in range(n)],
            "streams": {k: v[1] for k, v in testdata.MPEG2_STREAMS.items()},
            "runs": {}, "cli": {}}
    for run, (codec, settings) in testdata.MPEG12_RUNS.items():
        datas, anchors = encode_mpeg12(codec, n, settings)
        gold["runs"][run] = {
            "codec": codec, "settings": settings,
            "packets": [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
                        for d in datas],
            "anchors": testdata.digest(anchors)["frames"]}
        print(f"{run}: {len(datas)} packets, {sum(map(len, datas))} bytes, "
              f"{len(anchors)} anchors")
    work = tempfile.mkdtemp()
    try:
        src = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        for out, args in testdata.MPEG12_CLI.items():
            dst = os.path.join(work, out)
            if avconv.main(["-i", src, *args, dst]) != 0:
                raise SystemExit(f"avconv {' '.join(args)} {out} failed")
            with open(dst, "rb") as f:
                data = f.read()
            gold["cli"][out] = {"args": list(args), "size": len(data),
                                "md5": hashlib.md5(data).hexdigest()}
            print(f"CLI {out}: {len(data)} bytes")
    finally:
        shutil.rmtree(work)
    with open(testdata.mpeg12_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


# the writer's parameters for testdata.LEGACY's streams
LEGACY_WRITERS = {
    "h263_16cif": dict(seed=1301, fmt=5, gop=0, qscale=8),
    "flv1_720p": dict(seed=1302, escapes=(0, 1), qscale=8),
    "msmpeg4v3_720p": dict(seed=1303, version=3, slices=3, qscale=8),
    "msmpeg4v2_720p": dict(seed=1304, version=2, slices=1, qscale=8),
    "wmv1_720p": dict(seed=1305, version=4, slices=3, qscale=6,
                      bitrate=400, per_mb_rl=True),
}


def legacy_file(name: str) -> bytes:
    """testdata.LEGACY stream name written by tools/legacy_streams.py and
    put in its container by the port's muxer: the file's bytes."""
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.avutil.rational import Rational
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.formats.api import FormatContext
    from tools import legacy_streams as L
    fname, codec, w, h, n = testdata.LEGACY[name]
    kw = dict(LEGACY_WRITERS[name])
    frames = [testdata.pattern(w, h, t) for t in range(n)]
    if codec == "h263":
        return b"".join(L.h263_stream(frames, **kw))
    if codec == "flv1":
        datas = L.flv1_stream(frames, kw.pop("seed"), w, h, **kw)
        fmt = "flv"
    else:
        datas = L.msmpeg4_stream(frames, kw.pop("seed"), kw.pop("version"),
                                 w, h, **kw)
        fmt = "avi"
    work = tempfile.mkdtemp()
    try:
        path = os.path.join(work, fname)
        oc = FormatContext.open_output(path, fmt)
        oc.new_stream(CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id=codec, width=w, height=h,
                                      pix_fmt="yuv420p"),
                      time_base=Rational(1, 25))
        oc.write_header()
        for i, d in enumerate(datas):
            p = Packet(data=d, pts=i, dts=i, duration=1,
                       flags=1 if i == 0 else 0)
            p.stream_index = 0
            p.time_base = Rational(1, 25)
            oc.write_packet(p)
        oc.write_trailer()
        with open(path, "rb") as f:
            return f.read()
    finally:
        shutil.rmtree(work)


def write_legacy():
    """testdata.LEGACY's streams, the JAX decoders' digests (a stream
    whose decode logs a warning or conceals an MB is refused) and the
    JAX CLI's framecrc of each file."""
    from libav_tpu.avutil import log as jlog
    from libav_tpu.codecs import er as jer
    from libav_tpu.formats.api import FormatContext
    from libav_tpu.tools import avconv
    faults = []
    warning, conceal = jlog.warning, jer.conceal_missing

    def counted(*args):
        n = conceal(*args)
        faults.append(f"concealed {n} MBs")
        return n
    jlog.warning = lambda obj, fmt, *a: faults.append(fmt % a)
    jer.conceal_missing = counted
    gold = {}
    try:
        for name, (fname, codec, w, h, n) in testdata.LEGACY.items():
            path, crc = testdata.legacy_paths(name)
            with open(path, "wb") as f:
                f.write(legacy_file(name))
            ic = FormatContext.open_input(path)
            datas = []
            while True:
                try:
                    datas.append(bytes(ic.read_frame().data))
                except Exception:
                    break
            ic.close()
            frames = decode_reference(datas, codec) if codec in (
                "h263", "flv1") else decode_legacy(datas, codec, w, h)
            if faults or len(frames) != n:
                raise SystemExit(f"{name}: {faults}, {len(frames)} frames")
            gold[name] = testdata.digest(frames)
            if avconv.main(["-i", path, "-f", "framecrc", crc]) != 0:
                raise SystemExit(f"avconv -i {fname} failed")
            print(f"{fname}: {os.path.getsize(path)} bytes, {n} pictures")
    finally:
        jlog.warning, jer.conceal_missing = warning, conceal
    with open(testdata.legacy_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


def decode_legacy(datas, codec: str, width: int, height: int):
    """The JAX package's MSMPEG4 decoders (they take the container's
    dimensions): host (Y, U, V) per frame."""
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_decoder
    dec = find_decoder(codec)(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=width,
        height=height))
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [[np.asarray(p) for p in f.to_host().planes] for f in frames]


def write_mpeg4():
    """The MPEG-4 encode of the IPB stream's decoded frames, and the JAX
    CLI's transcode of that stream as a file: digests only."""
    import hashlib
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_decoder
    from libav_tpu.tools import avconv
    name = testdata.MPEG4_SOURCE
    dec = find_decoder("mpeg2video")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg2video"))
    frames = dec.decode_all(Packet(data=d, pts=i) for i, d in
                            enumerate(testdata.read_packets(
                                testdata.stream_paths(name)[0])))
    datas, anchors = encode_mpeg4(frames, testdata.MPEG4_SETTINGS)
    work = tempfile.mkdtemp()
    try:
        out = os.path.join(work, "out.m4v")
        argv = ["-i", testdata.write_cli_input(name, work),
                *testdata.MPEG4_CLI_ARGS, out]
        if avconv.main(argv) != 0:
            raise SystemExit("avconv -c:v mpeg4 failed")
        with open(out, "rb") as f:
            cli = f.read()
    finally:
        shutil.rmtree(work)
    gold = {"source": name, "settings": testdata.MPEG4_SETTINGS,
            "packets": [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
                        for d in datas],
            "anchors": testdata.digest(anchors)["frames"],
            "cli": {"args": list(testdata.MPEG4_CLI_ARGS), "size": len(cli),
                    "md5": hashlib.md5(cli).hexdigest()}}
    with open(testdata.mpeg4_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"{testdata.MPEG4_SMOKE}: {len(datas)} packets, "
          f"{sum(len(d) for d in datas)} bytes, {len(anchors)} anchors; CLI "
          f"{len(cli)} bytes, {'same' if cli == b''.join(datas) else 'other'}"
          f" bytes than the packets")


def decode_mpeg4(datas):
    """The JAX package's MPEG-4 decoder on datas: host (Y, U, V) per
    frame, in display order."""
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_decoder
    dec = find_decoder("mpeg4")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg4"))
    return [[np.asarray(p) for p in f.planes] for f in dec.decode_all(
        Packet(data=d, pts=i) for i, d in enumerate(datas))]


def write_mpeg4_asp():
    """The MPEG-4 ASP decode's goldens: digests and framecrc text only."""
    import hashlib
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_decoder
    from libav_tpu.tools import avconv
    dec = find_decoder("mpeg2video")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg2video"))
    frames = dec.decode_all(Packet(data=d, pts=i) for i, d in
                            enumerate(testdata.read_packets(
                                testdata.stream_paths(
                                    testdata.MPEG4_SOURCE)[0])))
    gold = {"source": testdata.MPEG4_SOURCE,
            "base_settings": testdata.MPEG4_SETTINGS, "runs": {}}
    datas, _ = encode_mpeg4(frames, testdata.MPEG4_SETTINGS)
    gold["phase10_decode"] = testdata.digest(decode_mpeg4(datas))
    streams = {}
    for run in testdata.MPEG4_ASP_RUNS:
        settings = testdata.mpeg4_asp_settings(run)
        streams[run], _ = encode_mpeg4(frames, settings)
        gold["runs"][run] = {
            "settings": settings,
            "packets": [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
                        for d in streams[run]],
            "decode": testdata.digest(decode_mpeg4(streams[run]))}
        print(f"mpeg4asp run {run}: {len(streams[run])} packets, "
              f"{sum(len(d) for d in streams[run])} bytes", flush=True)
    gold["cut"] = {"run": "C", "packet": testdata.MPEG4_ASP_CUT,
                   "decode": testdata.digest(decode_mpeg4(
                       testdata.cut_packet(streams["C"],
                                           testdata.MPEG4_ASP_CUT)))}
    golden, framecrc = testdata.mpeg4_asp_paths()
    work = tempfile.mkdtemp()
    try:
        src = os.path.join(work, "asp.m4v")
        with open(src, "wb") as f:
            f.write(b"".join(streams["A"]))
        out = os.path.join(work, "asp.framecrc")
        if avconv.main(["-i", src, "-f", "framecrc", out]) != 0:
            raise SystemExit("avconv -i asp.m4v failed")
        shutil.copyfile(out, framecrc)
    finally:
        shutil.rmtree(work)
    with open(golden, "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"{testdata.MPEG4_ASP}: goldens written")


def write_encode_cli():
    """encode_cli.golden.json: the source planes' adler32 of the pattern
    frames the smoke run's H.264 encodes take, and the md5 of the JAX
    CLI's output for each testdata.ENCODE_CLI run."""
    import hashlib
    from libav_tpu.tools import avconv
    gold = {"source": {f"{w}x{h}": [testdata.plane_adler32(
        testdata.pattern(w, h, t)) for t in range(n)]
        for w, h, n in testdata.ENCODE_SOURCES}, "cli": {}}
    work = tempfile.mkdtemp()
    try:
        for out, (name, args) in testdata.ENCODE_CLI.items():
            src = testdata.write_cli_input(name, work)
            dst = os.path.join(work, out)
            if avconv.main(["-i", src, *args, dst]) != 0:
                raise SystemExit(f"avconv {' '.join(args)} {out} failed")
            with open(dst, "rb") as f:
                data = f.read()
            gold["cli"][out] = {"input": os.path.basename(src),
                                "args": list(args), "size": len(data),
                                "md5": hashlib.md5(data).hexdigest()}
            print(f"CLI {out}: {len(data)} bytes")
    finally:
        shutil.rmtree(work)
    with open(testdata.encode_cli_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


def _cli_run(argv, out, work):
    """The JAX CLI's argv into work/out, then `-i out -f framecrc`: ->
    {"args", "size", "md5", "framecrc"}."""
    import hashlib
    from libav_tpu.tools import avconv
    dst = os.path.join(work, out)
    if avconv.main(list(argv) + [dst]) != 0:
        raise SystemExit(f"avconv {' '.join(argv)} {out} failed")
    with open(dst, "rb") as f:
        data = f.read()
    crc = os.path.join(work, out + ".crc")
    if avconv.main(["-i", dst, "-f", "framecrc", crc]) != 0:
        raise SystemExit(f"avconv -i {out} -f framecrc failed")
    with open(crc) as f:
        text = f.read()
    print(f"CLI {out}: {len(data)} bytes")
    return {"args": list(argv), "size": len(data),
            "md5": hashlib.md5(data).hexdigest(), "framecrc": text}


def _packets(datas, flags=None):
    import hashlib
    return [{"size": len(d), "md5": hashlib.md5(d).hexdigest(),
             **({} if flags is None else {"key": bool(f & 1)})}
            for d, f in zip(datas, flags or [None] * len(datas))]


def write_prores():
    """prores.golden.json (see the module docstring)."""
    from libav_tpu.avutil.frame import Frame
    from libav_tpu.avutil.rational import Rational
    from libav_tpu.codecs.api import CodecParameters, MediaType, find_encoder
    w, h = testdata.PRORES_SIZE
    sources = [testdata.pattern10(w, h, t)
               for t in range(testdata.PRORES_FRAMES)]
    frames = []
    for t, planes in enumerate(sources):
        f = Frame(width=w, height=h, format="yuv422p10le")
        f.planes = list(planes)
        f.pts = t
        frames.append(f)
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="prores",
                          width=w, height=h, pix_fmt="yuv422p10le",
                          framerate=Rational(25, 1))
    datas = [p.data for p in find_encoder("prores")(par).encode_all(frames)]
    gold = {"source": [testdata.plane_adler32(p, "<u2") for p in sources],
            "packets": _packets(datas),
            "decode": testdata.digest(decode_reference(datas, "prores"),
                                      "<u2")}
    work = tempfile.mkdtemp()
    try:
        testdata.write_pattern10_yuv(work)
        old = os.getcwd()
        os.chdir(work)
        try:
            gold["cli"] = {"out.mov": _cli_run(testdata.PRORES_CLI,
                                               "out.mov", work)}
        finally:
            os.chdir(old)
    finally:
        shutil.rmtree(work)
    with open(testdata.prores_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"prores: {len(datas)} packets, {sum(map(len, datas))} bytes")


def write_ffv1():
    """ffv1.golden.json (see the module docstring)."""
    from libav_tpu.avutil.frame import Packet
    from libav_tpu.codecs.api import (CodecParameters, MediaType,
                                      find_decoder, find_encoder)
    w, h = testdata.PRORES_SIZE
    sources = [testdata.pattern(w, h, t)
               for t in range(testdata.PRORES_FRAMES)]
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="ffv1",
                          width=w, height=h, pix_fmt="yuv420p")
    enc = find_encoder("ffv1")(par)
    for k, v in testdata.FFV1_SETTINGS.items():
        enc.set_opt(k, v)
    pkts = enc.encode_all([pattern(w, h, t)
                           for t in range(testdata.PRORES_FRAMES)])
    datas = [p.data for p in pkts]
    dec = find_decoder("ffv1")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="ffv1", width=w, height=h))
    decoded = [[np.asarray(p) for p in f.to_host().planes]
               for f in dec.decode_all(Packet(data=d, pts=i)
                                       for i, d in enumerate(datas))]
    for got, want in zip(decoded, sources):
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise SystemExit("ffv1: the JAX decode is not lossless")
    gold = {"source": [testdata.plane_adler32(p) for p in sources],
            "packets": _packets(datas, [p.flags for p in pkts]),
            "decode": testdata.digest(decoded)}
    work = tempfile.mkdtemp()
    try:
        src = testdata.write_cli_input(testdata.FFV1_CLI_SOURCE, work)
        gold["cli"] = {"out.avi": _cli_run(["-i", src, *testdata.FFV1_CLI],
                                           "out.avi", work)}
        gold["cli"]["out.avi"]["args"][1] = os.path.basename(src)
    finally:
        shutil.rmtree(work)
    with open(testdata.ffv1_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")
    print(f"ffv1: {len(datas)} packets, {sum(map(len, datas))} bytes")


def write_devices_gop():
    """devices_gop.golden.json (see the module docstring)."""
    from libav_tpu.tools import avconv, avplay
    gold = {"devices": {}, "gop": {}}
    work = tempfile.mkdtemp()
    try:
        for name, args in testdata.DEVICE_CLI.items():
            dst = os.path.join(work, name + ".crc")
            if avconv.main([*args, "-f", "framecrc", dst]) != 0:
                raise SystemExit(f"avconv {' '.join(args)} failed")
            with open(dst) as f:
                gold["devices"][name] = {"args": list(args),
                                         "framecrc": f.read()}
            print(f"{name}: framecrc")
        bench_h264 = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            if avplay.play(bench_h264, vo="null") != 0:
                raise SystemExit("avplay -vo null bench.h264 failed")
        gold["avplay_null"] = err.getvalue().strip().splitlines()[-1]
        print(gold["avplay_null"])
    finally:
        shutil.rmtree(work)
    for codec, (w, h, n, settings) in testdata.GOP_STREAMS.items():
        datas = encode(w, h, n, codec, settings)
        gold["gop"][codec] = {
            "source": [testdata.plane_adler32(testdata.pattern(w, h, t))
                       for t in range(n)],
            "packets": _packets(datas),
            "decode": testdata.digest(decode_reference(datas, codec))}
        print(f"{codec} {w}x{h}: {len(datas)} packets, "
              f"{sum(map(len, datas))} bytes")
    with open(testdata.devices_gop_golden_path(), "w") as f:
        json.dump(gold, f, indent=1)
        f.write("\n")


def main(which):
    if "h264" in which:
        write(testdata.SMOKE_STREAM, testdata.SMOKE_GOLDEN,
              encode(bench.W, bench.H, bench.NFRAMES), "h264")
    if "mpeg2" in which:
        for name, (nframes, settings) in testdata.MPEG2_STREAMS.items():
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
    if "mpeg4" in which:
        write_mpeg4()
    if "mpeg4asp" in which:
        write_mpeg4_asp()
    if "h264ext" in which:
        for name, (w, h, n, opts) in testdata.H264_EXT.items():
            write(*testdata.stream_paths(name), encode(w, h, n,
                                                       settings=opts),
                  "h264")
        for name in testdata.H264_EXT_CLI:
            write_framecrc(name)
    if "config5" in which:
        write_config5()
    if "containers" in which:
        write_containers()
    if "filters" in which:
        write_filters()
    if "mpeg12enc" in which:
        write_mpeg12()
    if "legacy" in which:
        write_legacy()
    if "h264enc" in which:
        write_encode_cli()
    if "prores" in which:
        write_prores()
    if "ffv1" in which:
        write_ffv1()
    if "devgop" in which:
        write_devices_gop()


if __name__ == "__main__":
    main(sys.argv[1:] or ("h264", "mpeg2", "mjpeg", "small", "framecrc",
                          "mpeg4", "mpeg4asp", "h264ext", "config5",
                          "containers", "filters", "mpeg12enc", "legacy",
                          "h264enc", "prores", "ffv1", "devgop"))
