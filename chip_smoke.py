#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libav_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Before it imports anything of the port, the script refuses every import
of jax, jaxlib and the JAX package `libav_tpu` (a sys.meta_path finder),
so the run shows that the port stands alone.

Phases, in order; any failure exits nonzero and prints no result:
  0. setup: needs torch.cuda.is_available(); prints the card's nvidia-smi
     name and power limit, torch/CUDA versions and whether the native
     CABAC host layer is built;
  1. build: compiles libav_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  2. K1 lines: h264_edge_filter_lines against the plain filter_edge_qp on
     the card over 6 x 2^20 random lines (bS 0-4, qp 0-51, luma and
     chroma, three offset pairs), exact; its time back to back and on the
     device, warm and cold, against its bound;
  3. frame deblock: deblock_frame_exact on random 1920x1088 planes, with
     part=False and part=True inputs and the 8x8-transform edge rule:
     the h264_deblock_frame kernel (one launch) equal to the plain version
     and to the h264_deblock_wave kernel (254 launches), and 20 more frame
     launches equal to the first (the race check); then, in turns (wave,
     frame, frame, wave), the whole frame deblock, the grid build alone
     and each kernel alone by CUDA events, each kernel's device time by
     torch.profiler with the inputs warm in L2 and cold (128 MiB written
     between calls), and the plain version once;
  4. main path: decodes the committed 1080p bench stream (CABAC, I_8x8,
     IPBB, 4 slices, deblock) with the port's H264Decoder on the card
     (send_packet / receive_frame / drain), holds every frame's adler32
     and md5 against the golden that the JAX package produced, checks
     that the frame deblock kernel ran once per frame and the wave kernel
     and the line kernel never, then times a warm second decode (recon
     synchronised per frame); then decodes it once more with the deblock
     through the wave kernel, golden-identical, its I and P/B frames'
     recon ms beside the warm decode's;
  5. K2: idct8x8_int against the plain idct8x8_int_plain on the card
     (DC-only rows, all-zero blocks, values outside int16, rows whose
     sums overflow int32), exact, at every block count the main paths
     give it: 48,960 (a 1080-line frame picture), 24,480 (a field),
     38,016 (a 16CIF picture) and 21,600 (a 720p picture); kernel and
     plain times at each by CUDA events, and the kernel's device time
     by torch.profiler at the first two;
  6. MPEG-2 main path: decodes the two committed 1920x1080 streams (8
     field pictures I/I/P..., 7 frame pictures I/P/B) with the port's
     MPEG2Decoder on the card, holds every frame's adler32 and md5
     against the JAX package's golden, checks that K2 ran once per coded
     picture, prints per-picture recon ms by type, then times a warm
     second decode of each and profiles a third (device busy share);
     then runs the frame-picture interlace tools, which those streams do
     not use, on random 1080p inputs on the card and on the CPU, exact;
  7. P1 and P2 (the timing tool's kernels in the coefficient-major and
     position-major layouts): the tool's path, kernel_probe at its
     defaults (48,896 blocks, 49,152 lines), times each plain version,
     production kernel (K2, K1) and probe-layout kernel by CUDA events and
     checks all three bit-exact against the numpy reference; then P1 and
     P2 against their plain versions on the card, exact, at the defaults
     and at B = 1 and 127 (P1) or 1 and 513 (P2); then the device time
     of K2, P1, K1's line kernel and P2 at those defaults with the inputs
     warm in L2 and cold, and K1's line kernel's time over P2's;
  8. MJPEG: decodes the committed 1080p stream (4 JPEGs) with the port's
     MJPEGDecoder on the card, one frame at a time and as one batch
     (decode_jpeg_batch); every frame's adler32 and md5 equal the golden,
     with K2 launched 3 times per frame, and 3 times for the batch;
  9. the CLI: writes the four committed streams as bench.h264, ipbb.m2v,
     fld.m2v and frames.mjpeg and runs the port's avconv on each with
     `-benchmark -f framecrc`: each output byte-identical to the JAX CLI's
     committed framecrc, with K1's frame kernel launched once per frame
     (and the wave kernel never) for the H.264 input and K2 once per coded
     MPEG-2 picture and 3 times per JPEG; prints the CLI's fps beside the
     direct decode's; then `-prof
     DIR` on bench.h264 and ipbb.m2v (each torch.profiler trace names its
     kernel, the H.264 timer report holds h264.entropy) and avprobe
     `-show_frames` on ipbb.m2v (its frame section equals the JAX
     avprobe's: 7 frames, I B B P B B P);
 10. MPEG-4 encode: decodes the committed IPB stream with the port on the
     card and encodes its 7 frames (still on the card) with the port's
     MPEG4Encoder (qscale 6, GOP 12, 2 B-frames): each packet's md5 and
     size and each of the 3 anchors' reconstructed planes equal the JAX
     package's golden, with K2 launched once per anchor; then a warm
     encode (fps), one with every stage synchronised and timed (P and B
     search, FDCT + quant, anchor recon, the download, host packing) and
     one under torch.profiler (device busy share, K2's device time),
     through `libav_tpu_torch/tools/encode_probe.py`;
 11. the transcode CLI: the port's avconv `-benchmark -i ipbb.m2v -c:v
     mpeg4 -q:v 6 -g 12 -bf 2 -f m4v out.m4v`, its output md5-identical to
     the JAX CLI's, K2 launched 7 + 3 times; its fps beside phase 10's;
 12. the config-5 chain: kernel sws_yuv2rgb against its plain version on
     the 12 decoded 1080p frames (the bench stream's 8, limited range, and
     the MJPEG stream's 4, full range; rgb24 and bgr24), byte for byte,
     with its time per call, its device time warm and cold and its bound;
     then, with the launch count set to 0, the port's avconv `-benchmark
     -f framecrc` with `-pix_fmt rgb24` on bench.h264 and frames.mjpeg and
     `-s 1280x720` on bench.h264, each byte-identical to the JAX CLI's
     committed framecrc, with one sws_yuv2rgb launch per rgb24 frame; and
     `-ar 44100 -ac 2 -f s16le` on the committed 10 s AC-3 5.0 and stereo
     streams (md5-identical to the JAX CLI's) and `-ar 44100 -f s16le` on
     the 5 s AAC-LC stream (every sample within 1 LSB of the JAX CLI's
     committed PCM; the count that differ and the IMDCT calls on the card
     printed), each with its realtime factor;
 13. MPEG-4 ASP decode: phase 10's 7 packets through the port's
     MPEG4Decoder on the card, every frame's adler32 and md5 equal to the
     JAX decoder's golden, the 3 anchors equal to the encoder's
     reconstruction, K2 launched once per coded VOP; a warm decode with
     each VOP's recon program synchronised (fps; the upload of its MB
     arrays and the Recon module, ms by VOP type; host share);
     then phase 10's frames encoded three more times on the card
     (A: qpel + mpegq + acpred, no B-VOPs; B: GMC with 3 warping points
     and B-VOPs; C: 8192-byte video packets, data partitioning, satd),
     each run's packets md5-identical to the JAX encoder's golden and its
     decode frame-identical to the JAX decoder's, K2 once per VOP, with
     upload, recon and GMC warp ms; C with one P-VOP packet cut in half,
     concealed as the JAX decoder conceals it; the 4MV recon (half-pel
     h263, quarter-sample mpeg4mq) on random 1920x1088 inputs, card equal
     to CPU; and the port's avconv `-benchmark -i asp.m4v -f framecrc` on
     A's packets, byte-identical to the JAX CLI's committed framecrc;
 14. the H.264 decoder's features past the bench stream: the five
     committed H264_EXT streams (explicit weighted P and B, implicit
     weighted B, I_PCM, PAFF field pictures with the cross-parity chroma
     offset and field deblock, all-field MBAFF I and P) through the
     port's H264Decoder on the card, every frame's adler32 and md5 equal
     to the JAX decoder's golden, K1's frame kernel launched once per
     deblocked picture (two per PAFF frame, none for MBAFF) and the wave
     kernel never; recon ms per picture by type, the weighted blend's ms
     per weighted picture (synchronised), each stream's fps from that
     one synchronised decode; K1 on the
     last PAFF field picture's padded planes and grids (120x34 MBs)
     against deblock_frame_plain, exact, with its time per call, its
     device time warm and cold and its bound; and the port's avconv
     `-benchmark -i paff.h264 -f framecrc`, byte-identical to the JAX
     CLI's committed framecrc;
 15. the container and audio-encode path (testdata/containers.py): the
     port's avconv muxes, with -c copy, bench.h264 and the committed
     ADTS AAC stream into out.mp4, then its video and the stereo AC-3
     stream into out.mkv and out.ts, each md5-identical to the JAX CLI's;
     `-benchmark -i out.mp4 -f framecrc` with its video lines
     byte-identical to the JAX CLI's (K1's frame kernel once per frame,
     the wave kernel never, the AAC IMDCT on the card) and its AAC
     decoded to s16 at 44.1 kHz within 1 LSB of the JAX CLI's committed
     PCM (the count that differ printed); `-f framecrc` on out.mkv and
     out.ts (video copied, 3 s of AC-3 decoded) byte-identical; the
     transcode `-benchmark -i out.mkv -t 3 -c:v mpeg4 -q:v 6 -g 12 -bf 2
     -c:a aac out2.mp4`: its MPEG-4 packets md5-identical to the JAX
     CLI's with K1 once per decoded frame and K2 once per anchor, its AAC
     packets as many as the JAX CLI's, the count that differ printed and
     the SNR against the source within 0.05 dB of the JAX packets' (both
     decoded by the port on the card; the AAC MDCT on the card), and the
     CLI's fps; then the first 3 s of the AC-3 stream decoded (fltp) and
     encoded to MP2, MP1, MP3, MP3 with joint stereo and FLAC, every
     packet md5-identical to the JAX encoder's and decoded back
     md5-identical to the JAX decoder's, with realtime factors; and to
     AC-3 (MDCT on the card, its calls counted) to the same bar as the
     AAC packets;
 16. the filter path (libav_tpu_torch/filters, testdata.FILTER_RUNS): the
     port's avconv `-benchmark` on the card with A `-i fld.m2v -vf
     yadif=1` and the MPEG-4 transcode (md5), B the pixel chain on
     bench.h264 (crop, hqdn3d, unsharp, boxblur, drawbox, fade, lutyuv,
     hflip, transpose), C `pad,gradfun,delogo,vflip -pix_fmt rgb24`, D
     `-filter_complex "[0:v][1:v]overlay=64:64"` with frames.mjpeg as the
     second input, E `-af volume=0.5,aresample=44100` on the stereo AC-3
     stream (md5), `-vf interlace` and `-vf fps=12` (on bench.mp4, the
     bench stream muxed with -c copy, md5-checked): each output identical
     to the JAX CLI's committed one, K1 once per decoded H.264 frame, K2
     in A and D, sws_yuv2rgb once per frame in C, each run's fps beside
     the same run without the filter (phases 9 and 12's runs, or one run
     here); then every registered video filter, with the tests' option
     sets, on two decoded 1080p frames of the bench stream (yadif and
     fieldorder on three of fld.m2v's, lutrgb after format=rgb24, settb
     on frames without a time base), and the sources at 1080p (movie
     decoding frames.mjpeg): its
     output on the card equal to the same torch code's on the CPU, its ms
     per 1080p frame by CUDA events, and for hqdn3d, gradfun and yadif its
     kernel launches per frame (cudaLaunchKernel calls under
     torch.profiler);
 17. the MPEG-1/2 encoders and the legacy decoders: the pattern's source
     planes against the golden's adler32 first; the port's MPEG2Encoder
     on the card encodes the pattern (testdata.pattern, 1920x1080) with
     each committed MPEG-2 stream's settings, its packets byte-identical
     to mpeg2_1080p_ipbb.m2vpkts (7) and mpeg2_1080i_fieldpic.m2vpkts (4,
     8 field pictures); runs M1 (MPEG-1, B-frames, trellis, SATD), M2aq
     (adaptive quantisation) and M2rc (rate control) md5-identical to
     the JAX encoders' golden with their anchors' reconstructions; K2
     once per I/P picture or field picture of each encode; warm encode
     fps and each stage's ms (search, FDCT + quant, download, host
     packing, recon), synchronised; the port's avconv `-benchmark -i
     bench.h264` into out.m2v (`-c:v mpeg2video -q:v 6 -g 8 -bf 2`) and
     out.ts (`-an`), md5-identical to the JAX CLI's, K1 once per decoded
     frame and K2 once per anchor; then the committed legacy streams
     (H.263 16CIF .263; FLV1, MSMPEG4 v3, v2 and WMV1 720p in FLV and
     AVI) demuxed and decoded on the card, frames identical to the JAX
     decoders' golden, K2 once per picture, warm fps, the host share
     (wall time outside Recon.forward on a third, warm pass), and
     `avconv -benchmark -f framecrc` on each file byte-identical to the
     JAX CLI's;
 18. the H.264 and MJPEG encoders: the pattern's source planes against
     encode_cli.golden.json's adler32 first; the port's H264Encoder on
     the card encodes 8 pattern frames at 1920x1080 with the bench
     settings (testdata.BENCH_SETTINGS: CABAC, I_8x8, 8x8 transform, 2
     B-frames, deblock, 4 slices), every packet byte-identical to
     h264_1080p_ipbb_cabac.h264pkts (the JAX encoder's), with K1 launched
     once per reference picture of the closed loop, and decodes them with
     the port's H264Decoder to the stream's golden, that one encode with
     every stage synchronised (fps; the I_8x8 wavefront, the P and B
     search + transform/quant programs, the download, host packing, the
     closed-loop reference and K1 in it, ms per picture);
     the first reference picture's closed-loop deblock (its padded planes
     and grids) run again through deblock_frame_plain, equal to what the
     loop kept, and K1's device time on them; the PAFF stream
     (h264_1088i_paff, 4 frames as 8 field pictures, K1 on field rules)
     likewise byte-identical, in one staged pass, and decoded to its
     golden; 4 yuvj420p
     pattern frames through MJPEGEncoder at quality 90 byte-identical to
     mjpeg_1080p.mjpegpkts through the native packer (asserted built);
     the port's avconv `-benchmark` encoding ipbb.m2v to H.264 with the
     bench options and bench.h264 to MJPEG in AVI, md5-identical to the
     JAX CLI's;
 19. ProRes and FFV1 (steps 11 and 15): the sources' planes against
     prores.golden.json's and ffv1.golden.json's adler32 first;
     prores_idct and fdct10 on 65,280 seeded blocks (a 1080p 4:2:2
     picture) against the numpy goldens, exact (dequant products past
     int16, DC-only blocks, row sums past int32, samples at 0 and 1023),
     each one's ms by CUDA events, launches and byte bound; two 1920x1080
     yuv422p10le frames of testdata.pattern10 through the port's
     ProresEncoder on the card (standard profile, rate-controlled), each
     packet's md5 and size equal to the JAX encoder's golden, then
     through its ProresDecoder, every frame's adler32 and md5 equal to
     the JAX decoder's golden; per picture the FDCT, host rate control,
     packing, host entropy and recon ms, and the recon and FDCT programs
     of one picture by CUDA events with their launches; the same frames'
     8-bit source through FFV1 (range coder, 5-gradient context, the
     second a non-key frame), packets golden, the decode on the card
     equal to the source; the port's avconv `-benchmark` from 10-bit
     rawvideo (`-frames:v 1 -c:v prores out.mov`) and from ipbb.m2v
     (`-frames:v 2 -c:v ffv1 out.avi`), each md5-identical to the JAX
     CLI's, with `-i <out> -f framecrc` identical to the JAX CLI's (the
     .avi's frames equal to ipbb.m2v's first two), each run's fps;
 20. the last modules (HLS, RTP/SDP/RTSP, the capture devices, avplay,
     GOP-parallel decode, the entry points): the bench stream through
     the port's RTPMuxer over UDP loopback into its rtp:// demuxer (90
     kHz timestamps), decoded on the card to its golden with K1 once per
     frame; ipbb.m2v as an RFC 2250 session announced by an .sdp file,
     the elementary stream byte-identical; ipbb.m2v muxed to MPEG-TS in
     three HLS segments, read as a VOD playlist on disk and through a
     master playlist over a loopback http server (the same packets),
     decoded to its golden with K2 once per picture; `avconv -f testsrc
     -i testsrc=1920x1080:rate=25:frames=8` and `-i sine=...` to
     framecrc identical to the JAX CLI's; avplay -vo null on bench.h264
     (the JAX avplay's frames-shown line) and -ao file on phase 15's
     out.mp4 (the PCM written equal to the port's own decode of the AAC
     track); GOP_STREAMS (8 pattern frames at GOP 2: MPEG-2 1920x1080,
     H.264 640x352 with deblocking) encoded on the card, packets
     md5-identical to the JAX encoders', then decoded serially and by
     GOPParallelDecoder with two workers on the card, both equal to the
     JAX decoders' golden with the same K1/K2 launches; entry() on the
     card equal to the CPU's, and dryrun_multichip(2) on two copies of
     the card; each run's fps, wall time and launches.
Profiled windows (the kernels' device times, phases 6 and 10's busy
shares, kernel_probe in phase 7) count the launches of the hand kernel
they hold against its wrapper's count: torch.profiler on the card loses
device events, so the times are per held launch, a busy share from a
window that lost some is logged as a low reading, and a window that holds
none is taken again and then fails the run.
The whole run's time is printed before the last two lines, which are
the kernels' JSON record and the result JSON.
"""

import contextlib
import copy
import functools
import importlib.abc
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

# stream -> the kernel its `avconv -prof` trace must name
PROF_KERNELS = {"h264_1080p_ipbb_cabac": "deblock_frame_kernel",
                "mpeg2_1080p_ipbb": "idct8x8_kernel"}
# decoded host (Y, U, V) planes kept for phase 16's filter checks:
# stream name -> the first frames of its warm decode (phases 4 and 6)
DECODED = {}
# NVIDIA H100 SXM HBM3, published: bytes per ms (3.35 TB/s)
HBM_BYTES_PER_MS = 3.35e9
# written between calls for a cold-L2 time: more than the 50 MB L2
FLUSH_BYTES = 128 << 20
# why no single PyTorch call computes a kernel's function
NO_LIBRARY = {
    "deblock": "none: the filter branches on the data per line (bS, "
               "alpha/beta tests, strong or normal filter)",
    "idct": "none: the IDCT must wrap in int32 bit-exactly (int16 row "
            "stores, per-row DC shortcut); a float matmul does not",
    "yuv2rgb": "none: no single PyTorch call does upsample + BT.601 + "
               "round-half-even + interleave",
}


class RefuseJax(importlib.abc.MetaPathFinder):
    """Refuses every import of jax, jaxlib and the JAX package."""
    REFUSED = ("jax", "jaxlib", "libav_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.REFUSED:
            raise ModuleNotFoundError(f"import of {name} refused: the port "
                                      "must not need it")
        return None


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=3):
    """Mean device milliseconds of fn() over reps runs, after one warm-up
    run, by CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_device_ms(fn, kernel, wrapper, reps=20, cold=False,
                     before=None):
    """Mean device milliseconds per call of fn() in the CUDA kernels whose
    name contains `kernel`, over reps calls, by torch.profiler. before()
    runs ahead of each call, untimed; with cold, FLUSH_BYTES are written
    after it, so no input of fn is left in the L2.

    A profile can lose device events: a few, most of a window, or every
    one, at its start or anywhere in it. So the launches it holds are
    counted against those that wrapper counted while it ran, and the
    time is the mean device time per launch it holds times the launches
    per call; a shortfall is logged. Each profile waits `settle` seconds
    before its first call and pads the window on both sides with spin
    kernels (kernel_probe.pad_window; the edges lose the most); one
    that holds no launch is taken again with four times the wait, three
    times in all, and then the run fails."""
    attempts = 3
    import torch
    from libav_tpu_torch.tools.kernel_probe import pad_window
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda") if cold else None
    if before:
        before()
    fn()
    torch.cuda.synchronize()
    settle = 0.05
    for attempt in range(1, attempts + 1):
        launched = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            pad_window()
            for i in range(reps):
                if before:
                    before()
                if cold:
                    flush.fill_(i)
                fn()
            pad_window()
            torch.cuda.synchronize()
        launched = wrapper.launches - launched
        hits = [e for e in prof.key_averages() if kernel in e.key]
        recorded = sum(e.count for e in hits)
        if recorded != launched:
            seen = [(e.key, e.count) for e in prof.key_averages()
                    if e.device_time_total > 0]
            log(f"  the profiler recorded {recorded} of {launched} {kernel} "
                f"launches in {reps} calls after {settle} s (attempt "
                f"{attempt} of {attempts}); device events it did record: "
                f"{seen or 'none'}")
        if recorded:
            us = sum(e.device_time_total for e in hits)
            return us / recorded * launched / reps / 1e3
        settle *= 4
    raise AssertionError(f"the profiler recorded no {kernel} launch")


def event_ms(fn, reps=10, before=None):
    """Mean milliseconds per call of fn() between two CUDA events around
    that call alone (launch included), after one warm-up call; before()
    runs ahead of each call, outside the events."""
    import torch
    total = 0.0
    for i in range(reps + 1):
        if before:
            before()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if i:
            total += start.elapsed_time(stop)
    return total / reps


def bound_ms(*tensors):
    """The least time the card could take to read or write these tensors
    once each at the published HBM rate: (ms, bytes)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes / HBM_BYTES_PER_MS, nbytes


def device_busy(fn, kernel, wrapper, attempts=3):
    """Run fn() once under torch.profiler: -> dict of device ops, device
    ms (summed over every kernel and copy the profile holds), wall ms,
    and of the hand kernel on fn's path (`kernel`: part of its CUDA name,
    `wrapper`: its launch counter) the launches the profile holds, those
    the wrapper made, and the mean device ms per held launch (the spin
    kernels that pad the window, kernel_probe.pad_window, left out). The
    profiler on the card loses device events, so with fewer held than
    made the busy share reads low (logged); a profile that holds none is
    taken again, `attempts` times in all, and then the run fails."""
    import torch
    from libav_tpu_torch.tools.kernel_probe import PAD_KERNEL, pad_window
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        launched = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_window()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pad_window()
            torch.cuda.synchronize()
        launched = wrapper.launches - launched
        ops = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and PAD_KERNEL not in e.key]
        hits = [e for e in ops if kernel in e.key]
        held = sum(e.count for e in hits)
        if held != launched:
            log(f"  the profiler held {held} of {launched} {kernel} "
                f"launches (attempt {attempt} of {attempts})")
        if held:
            return {"ops": sum(e.count for e in ops),
                    "busy_ms": sum(e.self_device_time_total
                                   for e in ops) / 1e3,
                    "wall_ms": 1e3 * wall, "held": held,
                    "launched": launched,
                    "kernel_ms": sum(e.self_device_time_total
                                     for e in hits) / held / 1e3}
    raise AssertionError(f"the profiler held no {kernel} launch in "
                         f"{attempts} profiles")


def busy_text(b):
    """device_busy's result as a log phrase."""
    low = "" if b["held"] == b["launched"] else ", a low reading"
    return (f"{b['ops']} device ops, {b['busy_ms']:.3f} ms on the device in "
            f"{b['wall_ms']:.1f} ms of wall (device busy "
            f"{100 * b['busy_ms'] / b['wall_ms']:.2f}%; the profile held "
            f"{b['held']} of {b['launched']} kernel launches{low})")


def line_inputs(dev, n=1 << 20):
    """Phase 2's edge lines: (n, 8) int32, seed 2, every other line
    smooth; qp 0-51 and bS 0-4 per line; all on dev."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    lines = rng.integers(0, 256, (n, 8)).astype(np.int32)
    lines[::2] = np.clip(lines[::2, :1] +
                         rng.integers(-6, 7, (n // 2, 8)), 0, 255)
    lines = torch.as_tensor(lines).to(dev)
    qp = torch.as_tensor(rng.integers(0, 52, n).astype(np.int32)).to(dev)
    bs = torch.as_tensor(rng.integers(0, 5, n).astype(np.int32)).to(dev)
    return lines, qp, bs


def phase_lines(dev):
    import torch
    from libav_tpu_torch.ops import h264deblock as db
    lines, qp, bs = line_inputs(dev)
    n = lines.shape[0]
    err = 0
    changed = 0
    for chroma in (False, True):
        for offs in ((0, 0), (4, -2), (-6, 6)):
            got = db.h264_edge_filter_lines(lines, qp, bs, chroma, *offs)
            want = db.filter_edge_qp(lines, qp, bs, chroma, *offs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"h264_edge_filter_lines differs from "
                                     f"filter_edge_qp (chroma={chroma}, "
                                     f"offsets={offs})")
            err = max(err, int((got - want).abs().max()))
            changed += int((got != lines).any(1).sum())
    def kernel():
        return db.h264_edge_filter_lines(lines, qp, bs)
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(lambda: db.filter_edge_qp(lines, qp, bs))
    warm = kernel_device_ms(kernel, "edge_filter_lines_kernel",
                            db.h264_edge_filter_lines)
    cold = kernel_device_ms(kernel, "edge_filter_lines_kernel",
                            db.h264_edge_filter_lines, cold=True)
    bound, nbytes = bound_ms(lines, lines, qp, bs)
    log(f"phase 2 K1 lines: 6 x {n} lines exact, {changed} lines filtered; "
        f"luma 2^20 lines kernel {ms:.4f} ms back to back, {warm:.4f} ms on "
        f"the device warm, {cold:.4f} cold; bound {bound:.4f} ms ({nbytes} "
        f"bytes): {100 * bound / warm:.1f}% warm, {100 * bound / cold:.1f}% "
        f"cold; plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": warm, "cold_device_ms": cold, "bound_ms": bound,
            "bytes": nbytes}


def phase_deblock(dev):
    import numpy as np
    import torch
    from libav_tpu_torch.ops import h264deblock as db
    mb_w, mb_h = 120, 68
    H, W = 16 * mb_h, 16 * mb_w
    bh, bw = 4 * mb_h, 4 * mb_w
    nmb = mb_w * mb_h
    rng = np.random.default_rng(3)

    def t(a):
        return torch.as_tensor(a).to(dev)

    def blocky(h, w, s):
        lv = rng.integers(100, 156, (h // s, w // s))
        img = np.repeat(np.repeat(lv, s, 0), s, 1)
        return t((img + rng.integers(-2, 3, (h, w))).astype(np.int32))

    planes = (blocky(H, W, 4), blocky(H // 2, W // 2, 2),
              blocky(H // 2, W // 2, 2))
    intra = t(rng.random(nmb) < 0.2)
    qp = t(rng.integers(24, 52, nmb).astype(np.int8))
    nnz = t(np.where(rng.random((bh, bw)) < 0.3, 2, 0).astype(np.int8))
    t8 = t(rng.random(nmb) < 0.5)
    cases = {
        "part=False": (False, (t(rng.integers(-6, 7, (nmb, 2))
                                 .astype(np.int16)),)),
        "part=True": (True, tuple(t(a) for a in (
            rng.integers(-6, 7, (bh, bw, 2)).astype(np.int16),
            rng.integers(-1, 2, (bh, bw)).astype(np.int8),
            rng.integers(-6, 7, (bh, bw, 2)).astype(np.int16),
            rng.integers(-1, 2, (bh, bw)).astype(np.int8)))),
    }
    out = {"max_abs_err": 0}
    for name, (part, motion) in cases.items():
        fn = db.deblock_frame_exact(mb_w, mb_h, 1, -1, part=part,
                                    any_t8=True)
        args = planes + (intra, qp, nnz) + motion
        got = fn(*args, t8=t8)
        torch.cuda.synchronize()
        for label, run in (("plain version", db.deblock_frame_plain),
                           ("wave kernel", db.deblock_frame_waves)):
            want = fn(*args, t8=t8, run=run)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"the frame deblock kernel differs "
                                         f"from the {label} ({name})")
                out["max_abs_err"] = max(out["max_abs_err"],
                                         int((g - w).abs().max()))
        for _ in range(20):
            again = fn(*args, t8=t8)
            if not all(torch.equal(g, w) for g, w in zip(again, got)):
                raise AssertionError(f"a repeated frame kernel launch gave "
                                     f"other planes ({name})")
        if torch.equal(got[0], planes[0]):
            raise AssertionError("the deblock changed no luma sample")

        # the kernels alone, on the padded planes and grids fn builds
        captured = []
        fn(*args, t8=t8, run=lambda *a: captured.extend(a))
        pads, rest = captured[:3], captured[3:]
        originals = [p.clone() for p in pads]

        def restore():
            for p, o in zip(pads, originals):
                p.copy_(o)

        kernels = {"wave": (lambda: db.deblock_frame_waves(*pads, *rest),
                            "deblock_wave_kernel", db.h264_deblock_wave),
                   "frame": (lambda: db.h264_deblock_frame(*pads, *rest),
                             "deblock_frame_kernel", db.h264_deblock_frame)}
        r = {k: {} for k in kernels}
        for k in ("wave", "frame", "frame", "wave"):       # in turns
            run = {"wave": db.deblock_frame_waves,
                   "frame": db.h264_deblock_frame}[k]
            call, kernel, wrapper = kernels[k]
            r[k].setdefault("whole", []).append(
                event_ms(lambda: fn(*args, t8=t8, run=run)))
            r[k].setdefault("ms", []).append(event_ms(call, before=restore))
            r[k].setdefault("device_ms", []).append(
                kernel_device_ms(call, kernel, wrapper, reps=10,
                                 before=restore))
            r[k].setdefault("cold_device_ms", []).append(
                kernel_device_ms(call, kernel, wrapper, reps=10,
                                 before=restore, cold=True))
        grids_ms = event_ms(lambda: fn(*args, t8=t8, run=lambda *a: None))
        plain_ms = event_ms(lambda: db.deblock_frame_plain(*pads, *rest),
                            reps=1, before=restore)
        bound, nbytes = bound_ms(*pads, *pads, rest[0])
        out[name] = {k: {m: sum(v) / len(v) for m, v in d.items()}
                     for k, d in r.items()}
        out[name].update(grids_ms=grids_ms, plain_ms=plain_ms,
                         bound_ms=bound, bytes=nbytes)
        log(f"phase 3 deblock 1920x1088 {name}: the frame kernel equals the "
            f"plain version and the wave kernel, 20 repeats identical")
        for k, d in r.items():
            log(f"phase 3   {k} kernel (turns wave, frame, frame, wave): "
                f"frame deblock {', '.join(f'{x:.4f}' for x in d['whole'])} "
                f"ms; kernel alone {', '.join(f'{x:.4f}' for x in d['ms'])} "
                f"ms by CUDA events, "
                f"{', '.join(f'{x:.4f}' for x in d['device_ms'])} ms on the "
                f"device warm, "
                f"{', '.join(f'{x:.4f}' for x in d['cold_device_ms'])} cold")
        log(f"phase 3   grid build alone {grids_ms:.4f} ms; plain version "
            f"{plain_ms:.1f} ms; bound {bound:.4f} ms ({nbytes} bytes)")
    return out


def decode(dev, datas, time_recon=False):
    """Decode the stream once; -> (host (Y, U, V) per frame, seconds,
    per-frame recon ms or None)."""
    import torch
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.h264 import H264Decoder
    dec = H264Decoder(device=dev)
    recon_ms = []
    if time_recon:
        inner = dec._reconstruct

        def timed(fd, slice_info):
            t0 = time.perf_counter()
            f = inner(fd, slice_info)
            torch.cuda.synchronize(dev)
            recon_ms.append((f.pict_type, 1e3 * (time.perf_counter() - t0)))
            return f
        dec._reconstruct = timed
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        dec.close()
    host = [f.to_host().planes for f in frames]
    return host, seconds, (recon_ms if time_recon else None)


@contextlib.contextmanager
def wave_deblock():
    """Decodes inside run the frame deblock through the 254-wave loop in
    place of the frame kernel (the decoder's path): the H.264 decoder's
    programs are wrapped so their deblock passes
    run=deblock_frame_waves. Measurement only."""
    from libav_tpu_torch.codecs.h264 import device as tdev
    from libav_tpu_torch.ops import h264deblock as db
    build = tdev.recon_h264_sparse

    def waves(*key, **kw):
        module = build(*key, **kw)
        if module.deblock is None:
            return module
        wave_module = copy.copy(module)
        wave_module.deblock = functools.partial(module.deblock,
                                                run=db.deblock_frame_waves)
        return wave_module
    tdev.recon_h264_sparse = waves
    try:
        yield
    finally:
        tdev.recon_h264_sparse = build


@contextlib.contextmanager
def intra_capture(store):
    """Inside, each launch of the intra assembly kernel by the H.264
    decoder appends its arguments to store, so a picture's inputs stay
    for a check against the plain twin and for timing. Measurement
    only."""
    from libav_tpu_torch.codecs.h264 import device as tdev
    kernel = tdev.h264_intra_frame

    def run(*args):
        store.append(args)
        return kernel(*args)
    tdev.h264_intra_frame = run
    try:
        yield store
    finally:
        tdev.h264_intra_frame = kernel


def intra_kernel_check(args, card):
    """h264_intra_frame on one picture's captured arguments against its
    plain twin (ReconH264._wavefront), then its time: per call by CUDA
    events, on the device warm and cold by the profiler, the plain twin's
    synchronised ms, and the bound: every input the kernel reads (as
    int32) and the three bordered planes written once."""
    import torch
    from libav_tpu_torch.codecs.h264.device import ReconH264
    from libav_tpu_torch.ops.h264intra import h264_intra_frame
    mb_w, mb_h, any_i4, any_i8, any_ipcm = args[:5]
    intra, lm, cm, row_top, i4, i4m, t8, pred, resid, pcm = args[5:]

    def call():
        return h264_intra_frame(*args)
    got = call()
    plain = ReconH264(mb_w, mb_h, any_i4=any_i4, any_i8=any_i8,
                      any_ipcm=any_ipcm).to(intra.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain._wavefront(*args[5:])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError("h264_intra_frame differs from "
                                 "ReconH264._wavefront")
    read = [intra, lm, cm, row_top, *pred, *resid]
    read += [i4, i4m] + ([t8] if any_i8 else []) if any_i4 else []
    read += list(pcm) if any_ipcm else []
    nbytes = 4 * sum(t.numel() for t in read + list(got) if t is not None)
    out = {"mb_w": mb_w, "mb_h": mb_h, "ms": event_ms(call),
           "device_ms": kernel_device_ms(call, "intra_frame_kernel",
                                         h264_intra_frame, reps=10),
           "cold_device_ms": kernel_device_ms(
               call, "intra_frame_kernel", h264_intra_frame, reps=10,
               cold=True),
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_MS,
           "bytes": nbytes}
    log(f"phase 4 h264_intra_frame on the I picture ({mb_w}x{mb_h} MBs): "
        f"equal to ReconH264._wavefront; {out['ms']:.4f} ms per call by "
        f"CUDA events, {out['device_ms']:.4f} ms on the device warm, "
        f"{out['cold_device_ms']:.4f} cold; bound {out['bound_ms']:.4f} "
        f"ms ({nbytes} bytes); plain twin {plain_ms:.1f} ms [{card}]")
    return out


def check_golden(host, gold, tag):
    from libav_tpu_torch import testdata
    got = testdata.digest(host)
    if len(got["frames"]) != len(gold["frames"]):
        raise AssertionError(f"{tag}: {len(got['frames'])} frames, golden "
                             f"has {len(gold['frames'])}")
    for i, (g, w) in enumerate(zip(got["frames"], gold["frames"])):
        if g != w:
            raise AssertionError(f"{tag}: frame {i} {g} != golden {w}")
    if got["md5_all"] != gold["md5_all"]:
        raise AssertionError(f"{tag}: md5 of all frames differs")
    return got


def phase_decode(dev, card):
    from libav_tpu_torch import testdata
    from libav_tpu_torch.codecs.h264 import dec as h264dec
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.ops.h264intra import h264_intra_frame
    datas = testdata.read_packets(testdata.SMOKE_STREAM)
    gold = testdata.load_golden()
    nframes = len(gold["frames"])

    db.h264_deblock_frame.launches = db.h264_deblock_wave.launches = 0
    db.h264_edge_filter_lines.launches = h264_intra_frame.launches = 0
    intra_calls = []
    with intra_capture(intra_calls):
        host, cold_s, recon_ms = decode(dev, datas, time_recon=True)
    launches = (db.h264_deblock_frame.launches,
                db.h264_deblock_wave.launches,
                db.h264_edge_filter_lines.launches)
    intra_launches = h264_intra_frame.launches
    check_golden(host, gold, "first decode")
    if launches != (nframes, 0, 0):
        raise AssertionError(f"h264_deblock_frame, h264_deblock_wave and "
                             f"h264_edge_filter_lines launched {launches} "
                             f"times, expected ({nframes}, 0, 0)")
    if not intra_launches == len(intra_calls) >= 1:
        raise AssertionError(f"h264_intra_frame launched {intra_launches} "
                             f"times for {len(intra_calls)} intra "
                             f"assemblies")
    names = {1: "I", 2: "P", 3: "B"}
    per = ", ".join(f"{names.get(pt, pt)} {ms:.1f}" for pt, ms in recon_ms)
    log(f"phase 4 first decode: {nframes} frames adler32+md5 identical to "
        f"the golden, {launches[0]} frame deblock launches and "
        f"{launches[1]} wave launches, {intra_launches} h264_intra_frame "
        f"launches, {cold_s:.2f} s; per-frame recon ms "
        f"(synchronised): {per}")

    n0, s0 = h264dec.host_entropy_stats()
    host, warm_s, warm_recon = decode(dev, datas, time_recon=True)
    n1, s1 = h264dec.host_entropy_stats()
    check_golden(host, gold, "second decode")
    if h264_intra_frame.launches != 2 * intra_launches:
        raise AssertionError(f"h264_intra_frame launched "
                             f"{h264_intra_frame.launches - intra_launches} "
                             f"times in the warm decode, {intra_launches} "
                             f"in the first")
    intra = intra_kernel_check(intra_calls[0], card)
    intra["launches"] = intra_launches
    DECODED["h264_1080p_ipbb_cabac"] = host[:2]
    fps = nframes / warm_s
    entropy_ms = 1e3 * (s1 - s0) / max(1, n1 - n0)
    log(f"phase 4 warm decode: {fps:.3f} fps ({1e3 * warm_s / nframes:.1f} "
        f"ms/frame), host entropy {entropy_ms:.1f} ms/frame over "
        f"{n1 - n0} access units, native CABAC "
        f"{h264dec.native_cabac_available()} [{card}]")

    # the same decode with the deblock through the wave kernel, beside
    # the warm decode through the frame kernel: per-frame recon
    # synchronised, the I frame apart
    with wave_deblock():
        host, wave_s, wave_recon = decode(dev, datas, time_recon=True)
    check_golden(host, gold, "decode through the wave kernel")
    for path, per, seconds in (("wave", wave_recon, wave_s),
                               ("frame", warm_recon, warm_s)):
        pb = [ms for pt, ms in per if pt != 1]
        i_ms = sum(ms for pt, ms in per if pt == 1)
        log(f"phase 4 decode, deblock through the {path} kernel: golden; "
            f"{seconds:.3f} s, I recon {i_ms:.1f} ms, mean P/B recon "
            f"{sum(pb) / len(pb):.2f} ms (synchronised: "
            f"{', '.join(f'{ms:.1f}' for ms in pb)})")
    return launches, fps, intra


def phase_idct(dev):
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import idct
    out = {"max_abs_err": 0}
    # 48,960 and 24,480 blocks: a 1080-line frame and field picture;
    # 38,016 and 21,600: a 16CIF and a 720p picture of the legacy decoders
    for n in (48960, 24480, 38016, 21600):
        x = torch.as_tensor(testdata.idct_blocks(5, n)).to(dev)
        got = idct.idct8x8_int(x)
        want = idct.idct8x8_int_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"idct8x8_int differs from "
                                 f"idct8x8_int_plain on {n} blocks")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 int((got - want).abs().max()))
        if n in (38016, 21600):
            out[n] = (cuda_ms(lambda: idct.idct8x8_int(x), reps=20),
                      cuda_ms(lambda: idct.idct8x8_int_plain(x)))
            log(f"phase 5 K2: {n} blocks exact; kernel {out[n][0]:.4f} ms "
                f"per call back to back, plain {out[n][1]:.4f} ms")
            continue
        out[n] = (cuda_ms(lambda: idct.idct8x8_int(x), reps=20),
                  cuda_ms(lambda: idct.idct8x8_int_plain(x)),
                  kernel_device_ms(lambda: idct.idct8x8_int(x),
                                   "idct8x8_kernel", idct.idct8x8_int),
                  kernel_device_ms(lambda: idct.idct8x8_int(x),
                                   "idct8x8_kernel", idct.idct8x8_int,
                                   cold=True),
                  bound_ms(x, x)[0])
        log(f"phase 5 K2: {n} blocks exact; kernel {out[n][0]:.4f} ms per "
            f"call back to back ({out[n][2]:.4f} ms of it on the device "
            f"with the input warm in L2, {out[n][3]:.4f} cold, by the "
            f"profiler; bound {out[n][4]:.4f}), plain {out[n][1]:.4f} ms")
    return out


def decode_mpeg2(dev, datas, timed=False):
    """Decode an MPEG-2 stream once; -> (host (Y, U, V) per frame,
    seconds, per-picture (type, recon ms) if timed, host seconds in slice
    entropy)."""
    import torch
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.mpeg12 import MPEG2Decoder
    dec = MPEG2Decoder(device=dev)
    recon_ms = []
    entropy_s = [0.0]

    def wrap(name, field):
        inner = getattr(dec, name)

        def run(*args):
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize(dev)
            kind = "IPB"[dec.pic.pict_type - 1] + (" field" if field else "")
            recon_ms.append((kind, 1e3 * (time.perf_counter() - t0)))
            return out
        setattr(dec, name, run)
    if timed:
        wrap("_reconstruct", False)
        wrap("_reconstruct_field", True)
    slice_entropy = dec._decode_slice

    def entropy(*args):
        t0 = time.perf_counter()
        try:
            return slice_entropy(*args)
        finally:
            entropy_s[0] += time.perf_counter() - t0
    dec._decode_slice = entropy
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        dec.close()
    host = [f.to_host().planes for f in frames]
    return host, seconds, recon_ms, entropy_s[0]


def phase_mpeg2(dev, card):
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import idct
    launches = 0
    fps = {}
    for name, pictures in testdata.MPEG2_SMOKE.items():
        path, golden = testdata.stream_paths(name)
        datas = testdata.read_packets(path)
        gold = testdata.load_golden(golden)
        nframes = len(gold["frames"])

        idct.idct8x8_int.launches = 0
        host, cold_s, recon_ms, _ = decode_mpeg2(dev, datas, timed=True)
        n = idct.idct8x8_int.launches
        check_golden(host, gold, f"{name} first decode")
        if n != pictures:
            raise AssertionError(f"{name}: idct8x8_int launched {n} times, "
                                 f"expected {pictures}")
        launches += n
        per = ", ".join(f"{k} {ms:.2f}" for k, ms in recon_ms)
        log(f"phase 6 {name} first decode: {nframes} frames adler32+md5 "
            f"identical to the golden, {n} K2 launches, {cold_s:.2f} s; "
            f"per-picture recon ms (synchronised): {per}")

        host, warm_s, _, entropy_s = decode_mpeg2(dev, datas)
        check_golden(host, gold, f"{name} second decode")
        DECODED[name] = host[:3]
        fps[name] = nframes / warm_s
        log(f"phase 6 {name} warm decode: {nframes / warm_s:.3f} fps "
            f"({1e3 * warm_s / nframes:.1f} ms/frame), host slice entropy "
            f"{1e3 * entropy_s / nframes:.1f} ms/frame, other "
            f"{1e3 * (warm_s - entropy_s) / nframes:.1f} ms/frame [{card}]")
        busy = device_busy(lambda: decode_mpeg2(dev, datas),
                           "idct8x8_kernel", idct.idct8x8_int)
        log(f"phase 6 {name} profiled decode: {busy_text(busy)}")
    return launches, fps


def phase_interlace(dev):
    """The frame-picture interlace tools (field MC, field DCT, dual prime),
    which the committed streams do not use: the recon program on random
    1920x1088 inputs gives the same planes on the card as on the CPU."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.hwdevice import state_from_numpy
    from libav_tpu_torch.codecs import mpegvideo
    args, kw = testdata.recon_inputs(7, 120, 68, True, True, True)
    outs = []
    for d in (dev, torch.device("cpu")):
        prog = mpegvideo.recon(120, 68, "mpeg2", True, True, 0,
                               interlaced=True, dual=True, device=d)
        planes, padded = prog(*state_from_numpy(args, d),
                              **state_from_numpy(kw, d))
        outs.append([p.cpu() for p in planes + padded])
    for g, w in zip(*outs):
        if not torch.equal(g, w):
            raise AssertionError("interlaced recon on the card differs from "
                                 "the CPU")
    log("phase 6 interlace tools: 1920x1088 field MC + field DCT + dual "
        "prime recon identical on the card and the CPU")


def phase_probe(dev, card, k1_big):
    """P1 and P2 through their tool, then against their plain versions;
    P2 also at phase 2's 2^20 lines, beside K1's line kernel there
    (`k1_big`: phase 2's result)."""
    import numpy as np
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.tools import kernel_probe
    out = {}
    for name, fn, kernel in (("idct", kernel_probe.probe_idct,
                              idct.idct8x8_int_cm),
                             ("deblock", kernel_probe.probe_deblock,
                              db.h264_edge_filter_pm)):
        kernel.launches = 0
        times = fn(device=dev)
        out[name] = {"launches": kernel.launches, "times": times}
        for t in times.values():
            if not t.exact:
                raise AssertionError(f"kernel_probe: {t.label} is not "
                                     "bit-exact to the numpy reference")
            held = (f"{t.held} device events held" if t.launched < 0
                    else f"{t.held} of {t.launched} launches held")
            log(f"phase 7 kernel_probe {name}: {t.label} {t.ms:.4f} ms/call "
                f"(median of 50, CUDA events), {t.device_ms:.4f} ms on the "
                f"device (torch.profiler, {held}), bit-exact [{card}]")

    # P1 on the five input classes of K2's checks at odd sizes, and on
    # the probe's blocks; P2 with qp over the whole table at odd sizes
    idct_cases = [testdata.idct_blocks(90 + B, B) for B in (1, 127)] + \
        [kernel_probe.idct_inputs(kernel_probe.IDCT_BATCH)]
    out["idct"]["max_abs_err"] = 0
    for blocks in idct_cases:
        B = len(blocks)
        xT = torch.as_tensor(blocks.reshape(B, 64).T.copy()).to(dev)
        got, want = idct.idct8x8_int_cm(xT), idct.idct8x8_int_cm_plain(xT)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"idct8x8_int_cm differs from its plain "
                                 f"version at B = {B}")
        out["idct"]["max_abs_err"] = max(out["idct"]["max_abs_err"],
                                         int((got - want).abs().max()))
    out["deblock"]["max_abs_err"] = 0
    for B in (1, 513, kernel_probe.DEBLOCK_BATCH):
        lines, qp, bs = kernel_probe.deblock_inputs(B)
        if B <= 513:
            qp = np.random.default_rng(B).integers(0, 52, B).astype(np.int32)
        xT, qp, bs = (torch.as_tensor(a).to(dev)
                      for a in (lines.T.copy(), qp, bs))
        got = db.h264_edge_filter_pm(xT, qp, bs)
        want = db.edge_filter_pm_plain(xT, qp, bs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"h264_edge_filter_pm differs from its "
                                 f"plain version at B = {B}")
        out["deblock"]["max_abs_err"] = max(out["deblock"]["max_abs_err"],
                                            int((got - want).abs().max()))
    log(f"phase 7 P1 exact against its plain version at B = 1, 127, "
        f"{kernel_probe.IDCT_BATCH}; P2 at B = 1, 513, "
        f"{kernel_probe.DEBLOCK_BATCH}")

    # device time at the probe's defaults, inputs warm in L2 and cold
    blocks = torch.as_tensor(
        kernel_probe.idct_inputs(kernel_probe.IDCT_BATCH)).to(dev)
    blocksT = blocks.reshape(-1, 64).T.contiguous()
    lines, qp, bs = (torch.as_tensor(a).to(dev) for a in
                     kernel_probe.deblock_inputs(kernel_probe.DEBLOCK_BATCH))
    linesT = lines.T.contiguous()
    runs = {
        "K2": (lambda: idct.idct8x8_int(blocks), "idct8x8_kernel",
               idct.idct8x8_int, (blocks, blocks)),
        "P1": (lambda: idct.idct8x8_int_cm(blocksT), "idct8x8_cm_kernel",
               idct.idct8x8_int_cm, (blocksT, blocksT)),
        "K1 lines": (lambda: db.h264_edge_filter_lines(lines, qp, bs),
                     "edge_filter_lines_kernel", db.h264_edge_filter_lines,
                     (lines, lines, qp, bs)),
        "P2": (lambda: db.h264_edge_filter_pm(linesT, qp, bs),
               "edge_filter_pm_kernel", db.h264_edge_filter_pm,
               (linesT, linesT, qp, bs)),
    }
    out["l2"] = {}
    for name, (fn, kernel, wrapper, io_) in runs.items():
        warm = kernel_device_ms(fn, kernel, wrapper, reps=50)
        cold = kernel_device_ms(fn, kernel, wrapper, reps=50, cold=True)
        bound, nbytes = bound_ms(*io_)
        out["l2"][name] = {"device_ms": warm, "cold_device_ms": cold,
                           "bound_ms": bound, "bytes": nbytes}
        log(f"phase 7 {name}: {warm:.4f} ms on the device warm, "
            f"{cold:.4f} cold (L2 flushed between launches); bound "
            f"{bound:.5f} ms ({nbytes} bytes): {100 * bound / warm:.1f}% "
            f"warm, {100 * bound / cold:.1f}% cold [{card}]")
    k1, p2 = out["l2"]["K1 lines"], out["l2"]["P2"]
    log(f"phase 7 K1 lines against P2 at {kernel_probe.DEBLOCK_BATCH} "
        f"lines: {k1['device_ms'] / p2['device_ms']:.2f}x warm, "
        f"{k1['cold_device_ms'] / p2['cold_device_ms']:.2f}x cold")

    # P2 at 2^20 lines: phase 2's lines transposed, beside K1's line
    # kernel on the same lines there
    big, qp, bs = line_inputs(dev)
    bigT = big.T.contiguous()
    got = db.h264_edge_filter_pm(bigT, qp, bs)
    want = db.edge_filter_pm_plain(bigT, qp, bs)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"h264_edge_filter_pm differs from its plain "
                             f"version at B = {big.shape[0]}")
    del got, want, big

    def p2_big():
        return db.h264_edge_filter_pm(bigT, qp, bs)
    warm = kernel_device_ms(p2_big, "edge_filter_pm_kernel",
                            db.h264_edge_filter_pm, reps=50)
    cold = kernel_device_ms(p2_big, "edge_filter_pm_kernel",
                            db.h264_edge_filter_pm, reps=50, cold=True)
    bound, nbytes = bound_ms(bigT, bigT, qp, bs)
    p2 = out["l2"]["P2 2^20"] = {"device_ms": warm, "cold_device_ms": cold,
                                 "bound_ms": bound, "bytes": nbytes}
    log(f"phase 7 P2 at {bigT.shape[1]} lines, exact: {warm:.4f} ms on the "
        f"device warm, {cold:.4f} cold; bound {bound:.5f} ms ({nbytes} "
        f"bytes): {100 * bound / warm:.1f}% warm, {100 * bound / cold:.1f}% "
        f"cold; K1 lines (phase 2) over P2 "
        f"{k1_big['device_ms'] / warm:.2f}x warm, "
        f"{k1_big['cold_device_ms'] / cold:.2f}x cold [{card}]")
    return out


def phase_mjpeg(dev, card):
    """The committed MJPEG stream one frame at a time, then as a batch."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.mjpeg import MJPEGDecoder
    from libav_tpu_torch.ops import idct
    path, golden = testdata.stream_paths(testdata.MJPEG_SMOKE)
    datas = testdata.read_packets(path)
    gold = testdata.load_golden(golden)
    nframes = len(gold["frames"])

    recon_ms = []

    def run(batch, time_recon=False):
        dec = MJPEGDecoder(device=dev)
        if time_recon:
            inner = dec._reconstruct

            def timed(*args):
                t0 = time.perf_counter()
                f = inner(*args)
                torch.cuda.synchronize(dev)
                recon_ms.append(1e3 * (time.perf_counter() - t0))
                return f
            dec._reconstruct = timed
        idct.idct8x8_int.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if batch:
            frames = dec.open().decode_jpeg_batch(datas)
        else:
            frames = dec.decode_all(Packet(data=d, pts=i)
                                    for i, d in enumerate(datas))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = idct.idct8x8_int.launches
        dec.close()
        check_golden([f.to_host().planes for f in frames], gold,
                     f"mjpeg {'batch' if batch else 'frames'}")
        return launches, seconds

    launches, cold_s = run(False, time_recon=True)
    if launches != 3 * nframes:
        raise AssertionError(f"mjpeg: idct8x8_int launched {launches} "
                             f"times, expected 3 x {nframes}")
    _, warm_s = run(False)
    batch_launches, batch_s = run(True)
    if batch_launches != 3:
        raise AssertionError(f"mjpeg batch: idct8x8_int launched "
                             f"{batch_launches} times, expected 3")
    fps = nframes / warm_s
    log(f"phase 8 MJPEG 1920x1080: {nframes} frames adler32+md5 identical to "
        f"the golden, {launches} K2 launches, {cold_s:.3f} s first decode "
        f"(recon ms per frame, synchronised: "
        f"{', '.join(f'{ms:.2f}' for ms in recon_ms)}); "
        f"warm {fps:.3f} fps; decode_jpeg_batch of all {nframes}: golden, "
        f"{batch_launches} K2 launches, {batch_s:.3f} s [{card}]")
    return launches, fps


def run_cli(tool, argv, dev):
    """tool.main(argv, device=dev) -> (stdout, stderr, seconds); raises
    unless it returns 0."""
    # the muxers' I/O looks for sys.stdout.buffer
    out, err = io.TextIOWrapper(io.BytesIO(), encoding="utf-8"), \
        io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv, device=dev)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tool.__name__} {' '.join(argv)} returned "
                             f"{rc}: {err.getvalue()[-2000:]}")
    out.flush()
    return out.buffer.getvalue().decode(), err.getvalue(), seconds


def phase_cli(dev, card, direct_fps):
    """The port's avconv and avprobe on the committed streams as files."""
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil import timer
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.tools import avconv, avprobe
    # K2 launches per stream: one per coded MPEG-2 picture, 3 per JPEG
    k2_expected = dict(testdata.MPEG2_SMOKE, h264_1080p_ipbb_cabac=0)
    work = tempfile.mkdtemp()
    try:
        inputs = {name: testdata.write_cli_input(name, work)
                  for name in testdata.CLI_INPUTS}

        def framecrc(name, *opts):
            out = os.path.join(work, name + ".framecrc")
            db.h264_deblock_frame.launches = 0
            db.h264_deblock_wave.launches = 0
            idct.idct8x8_int.launches = 0
            _, err, seconds = run_cli(avconv, [*opts, "-i", inputs[name],
                                               "-f", "framecrc", out], dev)
            with open(out, "rb") as f, \
                    open(testdata.framecrc_path(name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"avconv {name}: framecrc differs "
                                         f"from the JAX CLI's")
            got = (db.h264_deblock_frame.launches,
                   db.h264_deblock_wave.launches, idct.idct8x8_int.launches)
            nframes = len(testdata.load_golden(
                testdata.stream_paths(name)[1])["frames"])
            want = ((nframes if name == "h264_1080p_ipbb_cabac" else 0), 0,
                    k2_expected.get(name, 3 * nframes))
            if got != want:
                raise AssertionError(
                    f"avconv {name}: {got} K1 frame, K1 wave and K2 "
                    f"launches, expected {want}")
            return err, seconds, got[0], got[2]

        cli_fps = {}
        for name in testdata.CLI_INPUTS:
            err, seconds, k1, k2 = framecrc(name, "-benchmark")
            fps = cli_fps[name] = float(re.search(r"fps=([0-9.]+)",
                                                  err).group(1))
            log(f"phase 9 avconv -benchmark {os.path.basename(inputs[name])}"
                f" -f framecrc: byte-identical to the JAX CLI's framecrc, "
                f"{k1} K1 frame and {k2} K2 launches; CLI {fps} fps "
                f"({seconds:.2f} s wall) against the direct decode's "
                f"{direct_fps[name]:.3f} fps [{card}]")

        for name, kernel in PROF_KERNELS.items():
            prof = os.path.join(work, "prof_" + name)
            err, seconds, _, _ = framecrc(name, "-prof", prof)
            trace = os.path.join(prof, timer.TRACE_FILE)
            if not os.path.exists(trace):
                raise AssertionError(f"-prof wrote no trace for {name}")
            with open(trace, errors="replace") as f:
                named = any(kernel in chunk
                            for chunk in iter(lambda: f.read(1 << 24), ""))
            if not named:
                raise AssertionError(f"-prof trace of {name} names no "
                                     f"{kernel}")
            if name.startswith("h264") and "h264.entropy" not in err:
                raise AssertionError("-prof report holds no h264.entropy")
            report = [ln for ln in err.splitlines() if " us avg in " in ln]
            log(f"phase 9 avconv -prof {os.path.basename(inputs[name])}: "
                f"framecrc identical, trace {os.path.getsize(trace)} bytes "
                f"naming {kernel}, {seconds:.2f} s under the profiler; "
                f"timer report: {'; '.join(r.strip() for r in report)}")
            shutil.rmtree(prof)

        name = "mpeg2_1080p_ipbb"
        out, _, seconds = run_cli(avprobe, ["-show_frames", inputs[name]],
                                  dev)
        got = testdata.frames_section(out)
        with open(testdata.show_frames_path(name)) as f:
            if got != f.read():
                raise AssertionError("avprobe -show_frames differs from the "
                                     "JAX avprobe's")
        types = re.findall(r"pict_type=(\w)", got)
        log(f"phase 9 avprobe -show_frames ipbb.m2v: identical to the JAX "
            f"avprobe's, {len(types)} frames {' '.join(types)}, "
            f"{seconds:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return cli_fps


def phase_mpeg4(dev, card):
    """The committed IPB stream decoded by the port on the card and its 7
    frames encoded to MPEG-4 there: packets and anchors golden, K2 once
    per anchor; warm fps, stage times, K2's device time, busy share."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.tools import encode_probe as ep
    gold = testdata.load_golden(testdata.mpeg4_golden_path())
    settings = gold["settings"]
    frames, decode_s = ep.decode_source(dev)
    if not all(p.device == dev for f in frames for p in f.planes):
        raise AssertionError("the decoded frames are not on the card")

    idct.idct8x8_int.launches = 0
    anchors = []
    pkts, first_s = ep.encode(dev, frames, settings, anchors)
    launches = idct.idct8x8_int.launches
    got = ep.packet_digests(pkts)
    for i, (g, w) in enumerate(zip(got, gold["packets"])):
        if g != w:
            raise AssertionError(f"mpeg4 packet {i}: {g} != golden {w}")
    if len(got) != len(gold["packets"]):
        raise AssertionError(f"mpeg4: {len(got)} packets, golden has "
                             f"{len(gold['packets'])}")
    for i, (g, w) in enumerate(zip(testdata.digest(anchors)["frames"],
                                   gold["anchors"])):
        if g != w:
            raise AssertionError(f"mpeg4 anchor {i}: {g} != golden {w}")
    if len(anchors) != len(gold["anchors"]):
        raise AssertionError(f"mpeg4: {len(anchors)} anchors, golden has "
                             f"{len(gold['anchors'])}")
    if launches != len(gold["anchors"]):
        raise AssertionError(f"mpeg4 encode: idct8x8_int launched "
                             f"{launches} times, expected "
                             f"{len(gold['anchors'])}")
    nbytes = sum(len(d) for d in pkts)
    log(f"phase 10 MPEG-4 encode of {len(frames)} decoded 1920x1080 frames "
        f"(qscale {settings['qscale']}, gop {settings['gop_size']}, "
        f"b_frames {settings['b_frames']}): {len(pkts)} packets "
        f"({nbytes} bytes) md5-identical to the golden, {len(anchors)} "
        f"anchor reconstructions adler32-identical, {launches} K2 launches; "
        f"decode {decode_s:.2f} s, first encode {first_s:.2f} s")

    _, warm_s = ep.encode(dev, frames, settings)
    fps = len(frames) / warm_s
    with ep.stages(dev) as stages:
        _, staged_s = ep.encode(dev, frames, settings)
    log(f"phase 10 warm encode: {fps:.3f} fps ({1e3 * warm_s / len(frames):.1f}"
        f" ms/frame); transcode (decode + encode) "
        f"{len(frames) / (decode_s + warm_s):.3f} fps [{card}]")
    log(f"phase 10 stages (synchronised, ms per call, {staged_s:.2f} s "
        f"pass):")
    for label, ms in stages.items():
        log(f"phase 10   {label}: {', '.join(f'{x:.2f}' for x in ms)} "
            f"(sum {sum(ms):.1f})")

    busy = device_busy(lambda: ep.encode(dev, frames, settings),
                       "idct8x8_kernel", idct.idct8x8_int)
    k2_ms = busy["kernel_ms"]
    log(f"phase 10 profiled encode: {busy_text(busy)}; K2 {k2_ms:.4f} ms "
        f"on the device per held launch at 48,960 blocks")
    return {"launches": launches, "fps": fps, "k2_device_ms": k2_ms,
            "transcode_fps": len(frames) / (decode_s + warm_s),
            "frames": frames, "packets": pkts, "anchors": anchors}


def phase_transcode(dev, card, mpeg4):
    """The port's avconv transcodes ipbb.m2v to MPEG-4: the JAX CLI's
    bytes, K2 once per decoded picture and once per encoded anchor."""
    import hashlib
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.tools import avconv
    gold = testdata.load_golden(testdata.mpeg4_golden_path())
    name = testdata.MPEG4_SOURCE
    work = tempfile.mkdtemp()
    try:
        out = os.path.join(work, "out.m4v")
        argv = ["-benchmark", "-i", testdata.write_cli_input(name, work),
                *gold["cli"]["args"], out]
        idct.idct8x8_int.launches = 0
        _, err, seconds = run_cli(avconv, argv, dev)
        launches = idct.idct8x8_int.launches
        with open(out, "rb") as f:
            data = f.read()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if hashlib.md5(data).hexdigest() != gold["cli"]["md5"]:
        raise AssertionError("avconv -c:v mpeg4: the output differs from "
                             "the JAX CLI's")
    want = testdata.MPEG2_SMOKE[name] + len(gold["anchors"])
    if launches != want:
        raise AssertionError(f"avconv -c:v mpeg4: {launches} K2 launches, "
                             f"expected {want}")
    fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
    log(f"phase 11 avconv -benchmark -i ipbb.m2v "
        f"{' '.join(gold['cli']['args'])} out.m4v: {len(data)} bytes, "
        f"md5-identical to the JAX CLI's, {launches} K2 launches; CLI "
        f"{fps} fps ({seconds:.2f} s wall) against phase 10's transcode "
        f"{mpeg4['transcode_fps']:.3f} fps and encode {mpeg4['fps']:.3f} "
        f"fps [{card}]")
    return launches


def vop_types(datas):
    """vop_coding_type of each packet, as a letter."""
    return ["IPBS"[d[d.index(b"\x00\x00\x01\xb6") + 4] >> 6]
            for d in datas]


def decode_mpeg4(dev, datas, timed=False):
    """Decode MPEG-4 packets once with the port's MPEG4Decoder on dev: ->
    (host (Y, U, V) per frame, seconds, K2 launches, and if timed the
    synchronised ms of each VOP's recon program (the upload of its MB
    arrays, then the Recon module), of the module alone and of each GMC
    warp, in coding order)."""
    import torch
    from libav_tpu_torch.avutil import hwdevice
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs import mpegvideo
    from libav_tpu_torch.codecs.mpeg4 import MPEG4Decoder, dec as m4dec
    from libav_tpu_torch.ops import idct
    spans = {"program": [], "recon": [], "warp": []}
    saved = (hwdevice.program_factory, mpegvideo.Recon.forward,
             m4dec.warp_refs)

    def timed_call(fn, out):
        def run(*args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize(dev)
            out.append(1e3 * (time.perf_counter() - t0))
            return result
        return run
    def timed_factory(factory, device):
        program = saved[0](factory, device)
        return lambda *key, **flags: timed_call(program(*key, **flags),
                                                spans["program"])
    if timed:
        hwdevice.program_factory = timed_factory
        mpegvideo.Recon.forward = timed_call(saved[1], spans["recon"])
        m4dec.warp_refs = timed_call(saved[2], spans["warp"])
    idct.idct8x8_int.launches = 0
    dec = MPEG4Decoder(device=dev)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        dec.close()
        (hwdevice.program_factory, mpegvideo.Recon.forward,
         m4dec.warp_refs) = saved
    launches = idct.idct8x8_int.launches
    if not all(p.device == dev for f in frames for p in f.planes):
        raise AssertionError("mpeg4 decode: the frames are not on the card")
    if timed and not len(spans["program"]) == len(spans["recon"]) == \
            len(datas):
        raise AssertionError(f"mpeg4 decode: {len(spans['program'])} "
                             f"programs and {len(spans['recon'])} modules "
                             f"timed for {len(datas)} VOPs")
    host = [f.to_host().planes for f in frames]
    return host, seconds, launches, spans


def spans_by_vop(types, spans):
    """Each VOP's upload + recon module ms (the upload is the recon
    program's time less the module's), by VOP type, for the log."""
    return "; ".join(
        f"{t} " + ", ".join(f"{p - r:.2f} + {r:.2f}"
                            for v, p, r in zip(types, spans["program"],
                                               spans["recon"]) if v == t)
        for t in sorted(set(types)))


def phase_mpeg4_decode(dev, card, mpeg4):
    """MPEG-4 ASP decode on the card: phase 10's packets and three more
    encodes of its frames (qpel + mpegq + acpred; GMC with B-VOPs; video
    packets + data partitioning + satd) against the JAX decoder's golden,
    one K2 launch per coded VOP; a damaged packet; 4MV recon against the
    CPU; the CLI on asp.m4v against the JAX CLI's framecrc."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.hwdevice import state_from_numpy
    from libav_tpu_torch.codecs import mpegvideo
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.tools import avconv
    from libav_tpu_torch.tools import encode_probe as ep
    t_phase = time.perf_counter()
    golden, framecrc = testdata.mpeg4_asp_paths()
    gold = testdata.load_golden(golden)
    pkts = mpeg4["packets"]
    nvops = len(pkts)

    def check(host, want, tag, launches):
        check_golden(host, want, tag)
        if launches != nvops:
            raise AssertionError(f"{tag}: idct8x8_int launched {launches} "
                                 f"times, expected {nvops}")

    host, first_s, first_launches, spans = decode_mpeg4(dev, pkts, True)
    check(host, gold["phase10_decode"], "mpeg4 decode of phase 10",
          first_launches)
    crop = [(1080, 1920), (540, 960), (540, 960)]
    for k, (disp, anchor) in enumerate(zip((0, 3, 6), mpeg4["anchors"])):
        for g, a, (h, w) in zip(host[disp], anchor, crop):
            if not (g == a[:h, :w]).all():
                raise AssertionError(f"mpeg4 decode: anchor {k} differs "
                                     f"from the encoder's reconstruction")
    types = vop_types(pkts)
    log(f"phase 13 MPEG-4 decode of phase 10's {nvops} packets: frames "
        f"adler32+md5 identical to the JAX decoder's golden, the 3 anchors "
        f"equal to the encoder's reconstruction, {first_launches} K2 "
        f"launches; first decode {first_s:.2f} s, upload + recon module ms "
        f"per VOP (synchronised): {spans_by_vop(types, spans)}")
    # the warm pass is the timed one (each VOP's program synchronised)
    host, timed_s, launches, spans = decode_mpeg4(dev, pkts, True)
    check(host, gold["phase10_decode"], "mpeg4 warm decode", launches)
    fps = nvops / timed_s
    pct = {k: sum(ms) / (10 * timed_s) for k, ms in spans.items()}
    log(f"phase 13 warm decode: {fps:.3f} fps ({1e3 * timed_s / nvops:.1f} "
        f"ms/frame); timed pass {timed_s:.2f} s, upload + recon module by "
        f"VOP type (synchronised ms): {spans_by_vop(types, spans)}; of the "
        f"wall time upload {pct['program'] - pct['recon']:.1f}%, recon "
        f"module {pct['recon']:.1f}%, host share "
        f"{100 - pct['program']:.1f}% [{card}]")

    streams = {}
    for run, want in gold["runs"].items():
        settings = testdata.mpeg4_asp_settings(run)
        if settings != want["settings"]:
            raise AssertionError(f"run {run}: settings differ from the "
                                 f"golden's")
        idct.idct8x8_int.launches = 0
        streams[run], enc_s = ep.encode(dev, mpeg4["frames"], settings)
        enc_launches = idct.idct8x8_int.launches
        got = ep.packet_digests(streams[run])
        if got != want["packets"]:
            raise AssertionError(f"run {run}: packets differ from the JAX "
                                 f"encoder's golden")
        host, dec_s, launches, spans = decode_mpeg4(dev, streams[run],
                                                    True)
        check(host, want["decode"], f"mpeg4 run {run} decode", launches)
        types = vop_types(streams[run])
        warp = (f"; GMC warp ms "
                f"{', '.join(f'{ms:.2f}' for ms in spans['warp'])}"
                if spans["warp"] else "")
        log(f"phase 13 run {run} {testdata.MPEG4_ASP_RUNS[run]}: "
            f"{len(got)} packets ({sum(len(d) for d in streams[run])} "
            f"bytes, {''.join(types)}) md5-identical to the JAX encoder's, "
            f"{enc_launches} K2 launches in the encode ({enc_s:.2f} s); "
            f"decode golden-identical, {launches} K2 launches, "
            f"{nvops / dec_s:.3f} fps, upload + recon module ms "
            f"{spans_by_vop(types, spans)}{warp} [{card}]")

    cut = testdata.cut_packet(streams["C"], testdata.MPEG4_ASP_CUT)
    host, _, launches, _ = decode_mpeg4(dev, cut)
    check(host, gold["cut"]["decode"], "mpeg4 damaged-packet decode",
          launches)
    log(f"phase 13 run C with packet {testdata.MPEG4_ASP_CUT} cut to "
        f"{len(cut[testdata.MPEG4_ASP_CUT])} of "
        f"{len(streams['C'][testdata.MPEG4_ASP_CUT])} bytes: concealed, "
        f"frames identical to the JAX decoder's golden")

    # 4MV: no encoder of the JAX package emits it
    for kind, qpel, rounding in (("h263", False, 1), ("mpeg4mq", True, 0)):
        args, kw = testdata.recon_inputs(13, 120, 68, True, four_mv=True)
        args[1] = args[1].clip(1, 31)
        outs = []
        for d in (dev, torch.device("cpu")):
            prog = mpegvideo.recon(120, 68, kind, False, True, rounding,
                                   qpel=qpel, any_4mv=True, device=d)
            planes, padded = prog(*state_from_numpy(args, d),
                                  **state_from_numpy(kw, d))
            outs.append([p.cpu() for p in planes + padded])
        if not all(torch.equal(g, w) for g, w in zip(*outs)):
            raise AssertionError(f"4MV recon ({kind}, qpel={qpel}) on the "
                                 f"card differs from the CPU")
    log("phase 13 4MV: 1920x1088 recon with 8x8 vectors (h263 half-pel, "
        "mpeg4mq quarter-sample) identical on the card and the CPU")

    work = tempfile.mkdtemp()
    try:
        src = os.path.join(work, "asp.m4v")
        with open(src, "wb") as f:
            f.write(b"".join(streams["A"]))
        out = os.path.join(work, "asp.framecrc")
        idct.idct8x8_int.launches = 0
        _, err, seconds = run_cli(avconv, ["-benchmark", "-i", src, "-f",
                                           "framecrc", out], dev)
        launches = idct.idct8x8_int.launches
        with open(out, "rb") as f, open(framecrc, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("avconv -i asp.m4v: framecrc differs "
                                     "from the JAX CLI's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if launches != nvops:
        raise AssertionError(f"avconv -i asp.m4v: {launches} K2 launches")
    cli_fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
    log(f"phase 13 avconv -benchmark -i asp.m4v -f framecrc: byte-identical "
        f"to the JAX CLI's, {launches} K2 launches; CLI {cli_fps} fps "
        f"({seconds:.2f} s wall) [{card}]")
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": first_launches, "fps": fps}


def phase_config5_kernel(dev, card):
    """sws_yuv2rgb against its plain version on the 12 decoded 1080p
    frames (8 of the bench stream, limited range 4:2:0, and 4 of the
    MJPEG stream, full range), byte for byte; its times on the first."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.mjpeg import MJPEGDecoder
    from libav_tpu_torch.swscale import yuv2rgb as y2r
    host, _, _ = decode(dev, testdata.read_packets(testdata.SMOKE_STREAM))
    frames = [([torch.as_tensor(p).to(dev) for p in planes], False)
              for planes in host]
    mjpeg = MJPEGDecoder(device=dev).decode_all(
        Packet(data=d, pts=i) for i, d in enumerate(testdata.read_packets(
            testdata.stream_paths(testdata.MJPEG_SMOKE)[0])))
    frames += [(f.planes, True) for f in mjpeg]
    for i, ((y, u, v), full) in enumerate(frames):
        for bgr in (False, True):
            got = y2r.yuv2rgb(y, u, v, 1, 1, full, bgr)
            torch.cuda.synchronize(dev)
            want = y2r.yuv2rgb_plain(y, u, v, 1, 1, full, bgr)
            if not torch.equal(got, want):
                n = int((got != want).sum())
                raise AssertionError(f"sws_yuv2rgb frame {i} (full range "
                                     f"{full}, bgr {bgr}): {n} bytes differ "
                                     f"from the plain version")
    r = {"frames": len(frames), "max_abs_err": 0}
    for label, ((y, u, v), full) in (("limited", frames[0]),
                                     ("full", frames[-1])):
        out = torch.empty((y.shape[0], 3 * y.shape[1]), dtype=torch.uint8,
                          device=dev)
        bound, nbytes = bound_ms(y, u, v, out)
        t = {"ms": event_ms(lambda: y2r.yuv2rgb(y, u, v, 1, 1, full)),
             "plain_ms": event_ms(
                 lambda: y2r.yuv2rgb_plain(y, u, v, 1, 1, full)),
             "device_ms": kernel_device_ms(
                 lambda: y2r.yuv2rgb(y, u, v, 1, 1, full), "yuv2rgb_kernel",
                 y2r.yuv2rgb),
             "cold_device_ms": kernel_device_ms(
                 lambda: y2r.yuv2rgb(y, u, v, 1, 1, full), "yuv2rgb_kernel",
                 y2r.yuv2rgb, cold=True),
             "bound_ms": bound, "bytes": nbytes}
        r[label] = t
        log(f"phase 12 sws_yuv2rgb 1920x1080 yuv420p -> rgb24 ({label} "
            f"range): {t['ms']:.4f} ms per call, device {t['device_ms']:.4f}"
            f" ms warm, {t['cold_device_ms']:.4f} ms cold; bound "
            f"{t['bound_ms']:.5f} ms ({nbytes} bytes), "
            f"{100 * t['bound_ms'] / t['cold_device_ms']:.1f}% of it cold, "
            f"{100 * t['bound_ms'] / t['device_ms']:.1f}% warm; plain "
            f"{t['plain_ms']:.3f} ms [{card}]")
    log(f"phase 12 sws_yuv2rgb equal to its plain version on all "
        f"{len(frames)} decoded frames, rgb24 and bgr24")

    # RGB -> YUV on the card against the CPU (whose bytes the CPU tests
    # hold to XLA's) on frames built to split rounding orders
    from libav_tpu_torch import swscale as tsw
    h, w = 1080, 1920
    for fmt in ("yuv444p", "yuvj444p", "yuv422p", "yuvj422p", "yuv420p",
                "yuvj420p", "yuv440p", "yuv411p", "yuv410p"):
        rgb = torch.from_numpy(testdata.rgb2yuv_frame(h, w, fmt))
        got, want = (tsw.SwsContext(w, h, "rgb24", w, h, fmt, device=d)
                     ._rgb_to_yuv([rgb.to(d)], "rgb24", fmt)
                     for d in (dev, "cpu"))
        if got[0].device != dev:
            raise AssertionError(f"rgb24 -> {fmt} left the card")
        n = sum(int((a.cpu() != b).sum()) for a, b in zip(got, want))
        if n:
            raise AssertionError(f"rgb24 -> {fmt} on the card: {n} bytes "
                                 f"differ from the CPU's")
    log(f"phase 12 rgb24 -> yuv/yuvj 444/422/420p and yuv 440/411/410p "
        f"of the {w}x{h} "
        f"adversarial frames (testdata.rgb2yuv_frame): the card's bytes "
        f"equal the CPU's [{card}]")
    return r


def phase_config5(dev, card):
    """The config-5 chain through the port's avconv: -pix_fmt rgb24 and
    -s on the committed video streams, -ar 44100 [-ac 2] on the AC-3 and
    AAC streams; each against the JAX CLI's committed output. The counts
    of sws_yuv2rgb launches and AAC IMDCT calls are this run's."""
    import hashlib
    import zlib
    import numpy as np
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import fftmdct
    from libav_tpu_torch.swscale import yuv2rgb as y2r
    from libav_tpu_torch.tools import avconv
    gold = testdata.load_golden(testdata.config5_golden_path())
    nframes = {name: len(testdata.load_golden(
        testdata.stream_paths(name)[1])["frames"])
        for name, _ in testdata.VIDEO_RUNS.values()}
    work = tempfile.mkdtemp()
    r = {"audio": {}}
    try:
        y2r.yuv2rgb.launches = 0
        for run, (name, args) in testdata.VIDEO_RUNS.items():
            inp = testdata.write_cli_input(name, work)
            out = os.path.join(work, run + ".framecrc")
            before = y2r.yuv2rgb.launches
            _, err, seconds = run_cli(avconv, ["-benchmark", "-i", inp, *args,
                                               "-f", "framecrc", out], dev)
            with open(out, "rb") as f,                     open(testdata.video_run_path(run), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"avconv {run}: framecrc differs "
                                         f"from the JAX CLI's")
            launched = y2r.yuv2rgb.launches - before
            want = nframes[name] if "rgb24" in args else 0
            if launched != want:
                raise AssertionError(f"avconv {run}: {launched} sws_yuv2rgb "
                                     f"launches, expected {want}")
            fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
            r.setdefault("fps", {})[run] = fps
            log(f"phase 12 avconv -benchmark -i {os.path.basename(inp)} "
                f"{' '.join(args)} -f framecrc: byte-identical to the JAX "
                f"CLI's, {launched} sws_yuv2rgb launches; {fps} fps "
                f"({seconds:.2f} s wall) [{card}]")
        r["launches"] = y2r.yuv2rgb.launches
        for name, args in testdata.AUDIO_RUNS.items():
            codec, secs = testdata.AUDIO_STREAMS[name][:2]
            out = os.path.join(work, name + ".raw")
            fftmdct.imdct.calls = 0
            _, _, seconds = run_cli(avconv, ["-i", testdata.audio_path(name),
                                             *args, out], dev)
            calls = fftmdct.imdct.calls
            with open(out, "rb") as f:
                pcm = f.read()
            want = gold["audio"][name]
            line = (f"phase 12 avconv -i {os.path.basename(testdata.audio_path(name))}"
                    f" {' '.join(args)}: {len(pcm)} bytes")
            if name in testdata.AUDIO_PCM_KEPT:
                with open(testdata.pcm_golden_path(name), "rb") as f:
                    ref = np.frombuffer(zlib.decompress(f.read()), np.int16)
                got = np.frombuffer(pcm, np.int16)
                if got.shape != ref.shape:
                    raise AssertionError(f"avconv {name}: {got.size} "
                                         f"samples, the JAX CLI wrote "
                                         f"{ref.size}")
                diff = np.abs(got.astype(np.int32) - ref)
                ndiff = int((diff > 0).sum())
                if diff.max() > 1:
                    raise AssertionError(f"avconv {name}: a sample "
                                         f"{int(diff.max())} LSB from the "
                                         f"JAX CLI's")
                if calls == 0:
                    raise AssertionError(f"avconv {name}: no IMDCT call")
                line += (f", every s16 sample within 1 LSB of the JAX CLI's,"
                         f" {ndiff} of {ref.size} differ; {calls} IMDCT "
                         f"calls on the card")
                r["audio"][name] = {"differing": ndiff, "samples": ref.size,
                                    "imdct_calls": calls}
            else:
                if hashlib.md5(pcm).hexdigest() != want["md5"]:
                    raise AssertionError(f"avconv {name}: md5 differs from "
                                         f"the JAX CLI's")
                line += ", md5-identical to the JAX CLI's"
            r["audio"].setdefault(name, {})["realtime"] = secs / seconds
            log(f"{line}; {secs:g} s of {codec} audio in {seconds:.2f} s, "
                f"{secs / seconds:.2f}x realtime [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return r


@contextlib.contextmanager
def blend_timer():
    """Inside, each weighted blend of the H.264 recon (explicit or
    implicit, one call per weighted picture) runs synchronised and its
    ms are appended to the yielded list. Measurement only."""
    import torch
    from libav_tpu_torch.codecs.h264 import device as tdev
    cls = tdev.ReconH264
    saved = {k: cls.__dict__[k] for k in ("_explicit", "_implicit")}
    ms = []

    def timed(f):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return run
    cls._explicit = timed(saved["_explicit"])
    cls._implicit = staticmethod(timed(saved["_implicit"].__func__))
    try:
        yield ms
    finally:
        for k, v in saved.items():
            setattr(cls, k, v)


@contextlib.contextmanager
def field_deblock_capture(store):
    """Inside, the H.264 decoder's frame deblock of each field picture
    (a half-height picture filtered under the field rules) keeps a copy
    of its kernel inputs in store[0] before it launches K1, so the last
    one stays for a check against the plain version."""
    from libav_tpu_torch.codecs.h264 import device as tdev
    from libav_tpu_torch.ops import h264deblock as db
    build = tdev.recon_h264_sparse

    def run(*args):
        store[:] = [[t.clone() for t in args[:4]] + list(args[4:])]
        db.h264_deblock_frame(*args)

    def capturing(*key, **kw):
        module = build(*key, **kw)
        if module.deblock is None or not kw.get("field"):
            return module
        m = copy.copy(module)
        m.deblock = functools.partial(module.deblock, run=run)
        return m
    tdev.recon_h264_sparse = capturing
    try:
        yield store
    finally:
        tdev.recon_h264_sparse = build


def phase_h264_ext(dev, card):
    """The H.264 decoder's features past the bench stream on the card:
    each H264_EXT stream golden, K1 once per deblocked picture; K1 on a
    PAFF field picture's grids against the plain version; the PAFF
    stream through the port's avconv against the JAX CLI's framecrc."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.tools import avconv
    t_phase = time.perf_counter()
    names = {1: "I", 2: "P", 3: "B"}
    out = {"launches": {}}
    field = []
    for name, (w, h, _, opts) in testdata.H264_EXT.items():
        path, golden = testdata.stream_paths(name)
        datas = testdata.read_packets(path)
        gold = testdata.load_golden(golden)
        nframes = len(gold["frames"])
        # K1 once per deblocked picture: two field pictures per PAFF frame
        pictures = (nframes * (2 if opts.get("fieldpic") else 1)
                    if opts.get("deblock") else 0)
        db.h264_deblock_frame.launches = db.h264_deblock_wave.launches = 0
        with blend_timer() as blend_ms, field_deblock_capture(field):
            host, cold_s, recon_ms = decode(dev, datas, time_recon=True)
        launches = (db.h264_deblock_frame.launches,
                    db.h264_deblock_wave.launches)
        check_golden(host, gold, f"{name} first decode")
        if launches != (pictures, 0):
            raise AssertionError(f"{name}: h264_deblock_frame and "
                                 f"h264_deblock_wave launched {launches} "
                                 f"times, expected ({pictures}, 0)")
        out["launches"][name] = launches[0]
        # each stream is decoded once: its fps is the first,
        # synchronised pass's (the bench stream's warm decode, phase 4,
        # gives the decoder's warm rate)
        by_type = {}
        for pt, ms in recon_ms:
            by_type.setdefault(names.get(pt, pt), []).append(ms)
        per = "; ".join(f"{k} {', '.join(f'{x:.1f}' for x in v)}"
                        for k, v in by_type.items())
        blend = (f"; weighted blend {', '.join(f'{x:.2f}' for x in blend_ms)}"
                 f" ms per weighted picture" if blend_ms else "")
        log(f"phase 14 {name} ({w}x{h}, {len(recon_ms)} pictures): "
            f"{nframes} frames adler32+md5 identical to the golden, "
            f"{launches[0]} K1 frame launches, {cold_s:.2f} s first decode; "
            f"recon ms per picture (synchronised) {per}{blend}; "
            f"first pass {nframes / cold_s:.3f} fps [{card}]")

    # K1 on the last PAFF field picture's padded planes and grids
    pads, grids, args = field[0][:3], field[0][3], field[0][4:]
    mb_w, mb_h = args[:2]
    originals = [p.clone() for p in pads]

    def restore():
        for p, o in zip(pads, originals):
            p.copy_(o)

    def call():
        db.h264_deblock_frame(*pads, grids, *args)
    call()
    got = [p.clone() for p in pads]
    restore()
    t0 = time.perf_counter()
    db.deblock_frame_plain(*pads, grids, *args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for g, want in zip(got, pads):
        if not torch.equal(g, want):
            raise AssertionError("h264_deblock_frame differs from "
                                 "deblock_frame_plain on a field picture")
    max_err = max(int((g - p).abs().max()) for g, p in zip(got, pads))
    if torch.equal(got[0], originals[0]):
        raise AssertionError("the field deblock changed no luma sample")
    ms = event_ms(call, before=restore)
    warm = kernel_device_ms(call, "deblock_frame_kernel",
                            db.h264_deblock_frame, reps=10, before=restore)
    cold = kernel_device_ms(call, "deblock_frame_kernel",
                            db.h264_deblock_frame, reps=10, before=restore,
                            cold=True)
    bound, nbytes = bound_ms(*originals, *originals, grids)
    out["field"] = {"mb_w": mb_w, "mb_h": mb_h, "max_abs_err": max_err,
                    "ms": ms, "plain_ms": plain_ms, "device_ms": warm,
                    "cold_device_ms": cold, "bound_ms": bound,
                    "bytes": nbytes,
                    "is": "the frame kernel on the last field picture of "
                          "the PAFF stream's decode (its padded planes and "
                          "grids under the field rules), as the ms of the "
                          "entry above"}
    log(f"phase 14 K1 on a PAFF field picture ({mb_w}x{mb_h} MBs): equal to "
        f"deblock_frame_plain; {ms:.4f} ms per call by CUDA events, "
        f"{warm:.4f} ms on the device warm, {cold:.4f} cold; bound "
        f"{bound:.4f} ms ({nbytes} bytes); plain {plain_ms:.1f} ms [{card}]")

    name = "h264_1088i_paff"
    work = tempfile.mkdtemp()
    try:
        inp = testdata.write_cli_input(name, work)
        dst = os.path.join(work, "paff.framecrc")
        db.h264_deblock_frame.launches = 0
        _, err, seconds = run_cli(avconv, ["-benchmark", "-i", inp, "-f",
                                           "framecrc", dst], dev)
        with open(dst, "rb") as f, open(testdata.framecrc_path(name),
                                         "rb") as g:
            if f.read() != g.read():
                raise AssertionError("avconv paff.h264: framecrc differs "
                                     "from the JAX CLI's")
        if db.h264_deblock_frame.launches != out["launches"][name]:
            raise AssertionError(f"avconv paff.h264: "
                                 f"{db.h264_deblock_frame.launches} K1 "
                                 f"launches, expected "
                                 f"{out['launches'][name]}")
    finally:
        shutil.rmtree(work)
    fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
    log(f"phase 14 avconv -benchmark -i paff.h264 -f framecrc: "
        f"byte-identical to the JAX CLI's, {out['launches'][name]} K1 "
        f"launches, {fps} fps ({seconds:.2f} s wall) [{card}]")
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


def bench_frames(err):
    """{"frames", "fps"} of avconv -benchmark's report: the frames of
    every stream, audio included."""
    m = re.search(r"frames=(\d+) fps=([0-9.]+)", err)
    return {"frames": int(m.group(1)), "fps": float(m.group(2))}


def phase_containers(dev, card):
    """Phase 15: the container and audio-encode path through the port's
    avconv and codecs on the card, against the JAX package's committed
    goldens (libav_tpu_torch/testdata/containers.py)."""
    import zlib
    import numpy as np
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.frame import Frame, Packet
    from libav_tpu_torch.codecs import api
    from libav_tpu_torch.formats import FormatContext
    from libav_tpu_torch.ops import fftmdct, idct
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.testdata import containers as C
    from libav_tpu_torch.tools import avconv
    gold = testdata.load_golden(C.GOLDEN)
    nframes = len(testdata.load_golden()["frames"])
    r = {}

    def reset():
        db.h264_deblock_frame.launches = 0
        db.h264_deblock_wave.launches = 0
        idct.idct8x8_int.launches = 0
        fftmdct.mdct.calls = 0
        fftmdct.imdct.calls = 0

    def snr_bar(tag, src, par, port, jax_datas):
        """The §3 end-to-end bar of an AAC / AC-3 packet stream: count,
        packets differing, SNR of both decodes on the card."""
        codec = par.codec_id
        want = gold["transcode"]["audio_md5"] if codec == "aac" else \
            gold["ac3"]["packets"]
        if len(port) != len(want) or len(jax_datas) != len(want):
            raise AssertionError(f"{tag}: {len(port)} packets, the JAX "
                                 f"encoder's {len(want)}")
        differ = sum(C.md5(d) != w for d, w in zip(port, want))
        snr_port = C.snr_db(src, C.decode_pcm(
            api, par, [Packet(data=d) for d in port], device=dev),
            C.DELAY[codec])
        snr_jax = C.snr_db(src, C.decode_pcm(
            api, par, [Packet(data=d) for d in jax_datas], device=dev),
            C.DELAY[codec])
        if abs(snr_port - snr_jax) > C.SNR_TOLERANCE_DB or snr_jax < 10:
            raise AssertionError(f"{tag}: SNR {snr_port:.4f} dB against the "
                                 f"JAX packets' {snr_jax:.4f} dB")
        return {"packets": len(want), "differing": differ,
                "snr_db": snr_port, "jax_snr_db": snr_jax}

    work = tempfile.mkdtemp()
    try:
        C.write_inputs(work)

        def cli(*args):
            return run_cli(avconv, C.in_dir(args, work), dev)

        def at(name):
            return os.path.join(work, name)

        def read(name):
            with open(at(name), "rb") as f:
                return f.read()

        for out, args in C.MUX:
            _, _, seconds = cli(*args, out)
            if C.md5(read(out)) != gold["mux"][out]:
                raise AssertionError(f"avconv -c copy {out}: md5 differs "
                                     f"from the JAX CLI's")
            log(f"phase 15 avconv {' '.join(args)} {out}: "
                f"{len(read(out))} bytes, md5-identical to the JAX CLI's "
                f"({seconds:.2f} s)")

        reset()
        _, err, seconds = cli("-benchmark", "-i", "out.mp4", "-f",
                              "framecrc", at("out.mp4.framecrc"))
        k1 = (db.h264_deblock_frame.launches, db.h264_deblock_wave.launches)
        imdct_calls = fftmdct.imdct.calls
        with open(C.framecrc_path("out.mp4")) as f:
            want = f.read().splitlines()
        got = read("out.mp4.framecrc").decode().splitlines()
        video = [(a, b) for a, b in zip(got, want) if not b.startswith("1,")]
        audio = [(a, b) for a, b in zip(got, want) if b.startswith("1,")]
        if len(got) != len(want) or any(a != b for a, b in video):
            raise AssertionError("avconv -i out.mp4 -f framecrc: the video "
                                 "lines differ from the JAX CLI's")
        if k1 != (nframes, 0) or imdct_calls == 0:
            raise AssertionError(f"avconv -i out.mp4: {k1} K1 frame and "
                                 f"wave launches, {imdct_calls} IMDCT "
                                 f"calls; expected ({nframes}, 0), some")
        r["mp4_decode"] = {"k1": k1[0], "seconds": seconds,
                           **bench_frames(err)}
        _, _, pcm_seconds = cli("-i", "out.mp4", *C.MP4_PCM, at("mp4.s16"))
        got = np.frombuffer(read("mp4.s16"), np.int16)
        with open(testdata.pcm_golden_path("aac_lc_48k"), "rb") as f:
            ref = np.frombuffer(zlib.decompress(f.read()), np.int16)
        diff = np.abs(got.astype(np.int32) - ref) if got.shape == \
            ref.shape else None
        if diff is None or diff.max() > 1:
            raise AssertionError("avconv -i out.mp4 -vn -ar 44100: the AAC "
                                 "PCM is not within 1 LSB of the JAX CLI's")
        r["mp4_decode"]["pcm_differing"] = int((diff > 0).sum())
        log(f"phase 15 avconv -benchmark -i out.mp4 -f framecrc: video "
            f"lines byte-identical to the JAX CLI's, {k1[0]} K1 frame "
            f"launches and {k1[1]} wave launches, "
            f"{sum(a == b for a, b in audio)} of {len(audio)} AAC lines "
            f"identical, {imdct_calls} IMDCT calls on the card; CLI "
            f"{r['mp4_decode']['fps']} frames/s over "
            f"{r['mp4_decode']['frames']} video and audio frames "
            f"({seconds:.2f} s wall); -vn "
            f"{' '.join(C.MP4_PCM[1:])}: every s16 sample within 1 LSB of "
            f"the JAX CLI's, {int((diff > 0).sum())} of {ref.size} differ "
            f"({pcm_seconds:.2f} s) [{card}]")

        for out in ("out.mkv", "out.ts"):
            crc = out + ".framecrc"
            _, _, seconds = cli("-i", out, *C.FRAMECRC[out], "-f",
                                "framecrc", at(crc))
            with open(C.framecrc_path(out), "rb") as f:
                if read(crc) != f.read():
                    raise AssertionError(f"avconv -i {out} -f framecrc: "
                                         f"differs from the JAX CLI's")
            log(f"phase 15 avconv -i {out} {' '.join(C.FRAMECRC[out])} -f "
                f"framecrc: byte-identical to the JAX CLI's (AC-3 decoded "
                f"on the host, {C.SOURCE_SECONDS:g} s of audio in "
                f"{seconds:.2f} s, "
                f"{C.SOURCE_SECONDS / seconds:.2f}x realtime) [{card}]")

        reset()
        src_name, args, dst = C.TRANSCODE
        _, err, seconds = cli("-benchmark", "-i", src_name, *args, dst)
        k1 = (db.h264_deblock_frame.launches, db.h264_deblock_wave.launches)
        k2, mdct_calls = idct.idct8x8_int.launches, fftmdct.mdct.calls
        t = gold["transcode"]
        _, video = C.read_stream(FormatContext, os.path.join(work, dst),
                                 api.MediaType.VIDEO)
        apar, audio = C.read_stream(FormatContext, os.path.join(work, dst),
                                    api.MediaType.AUDIO)
        if [C.md5(bytes(p.data)) for p in video] != t["video_md5"]:
            raise AssertionError("avconv transcode: the MPEG-4 packets "
                                 "differ from the JAX CLI's")
        if k1 != (nframes, 0) or k2 != t["anchors"]:
            raise AssertionError(f"avconv transcode: {k1} K1 frame and wave"
                                 f" launches, {k2} K2; expected "
                                 f"({nframes}, 0), {t['anchors']}")
        if apar.extradata.hex() != t["audio_extradata"] or \
                mdct_calls < len(audio):
            raise AssertionError(f"avconv transcode: AAC config "
                                 f"{apar.extradata.hex()}, {mdct_calls} "
                                 f"MDCT calls for {len(audio)} packets")
        src = C.source_pcm(api, FormatContext,
                           os.path.join(work, "ac3_20_48k.ac3"), device=dev)
        aac = snr_bar("avconv transcode AAC", src, apar,
                      [bytes(p.data) for p in audio],
                      testdata.read_packets(C.JAX_PACKETS["aac"]))
        r["transcode"] = {"seconds": seconds, "k1": k1[0], "k2": k2,
                          "mdct_calls": mdct_calls, "aac": aac,
                          **bench_frames(err)}
        log(f"phase 15 avconv -benchmark -i {src_name} {' '.join(args)} "
            f"{dst}: {len(video)} MPEG-4 packets ({t['vop_types']}) "
            f"md5-identical to the JAX CLI's, {k1[0]} K1 frame launches, "
            f"{k1[1]} wave, {k2} K2 (one per anchor); AAC {aac['packets']} "
            f"packets, {aac['differing']} differ from the JAX CLI's, SNR "
            f"{aac['snr_db']:.4f} dB against the JAX packets' "
            f"{aac['jax_snr_db']:.4f} dB (both decoded by the port on the "
            f"card), {mdct_calls} MDCT calls on the card; CLI "
            f"{r['transcode']['fps']} frames/s over "
            f"{r['transcode']['frames']} video and audio frames "
            f"({seconds:.2f} s wall) [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = C.source_pcm(api, FormatContext, testdata.audio_path(C.SOURCE),
                       device=dev)
    if C.pcm_md5(src) != gold["source"]["md5"]:
        raise AssertionError("the AC-3 source PCM differs from the JAX "
                             "decoder's")
    secs = src.shape[1] / 48000
    r["encodes"] = {}
    for name, (codec, opts) in C.ENCODES.items():
        t0 = time.perf_counter()
        datas = C.encode(api, Frame, codec, opts, src)
        t1 = time.perf_counter()
        pcm = C.decode_back(api, Packet, codec, datas, device=dev)
        t2 = time.perf_counter()
        want = gold["encodes"][name]
        if [C.md5(d) for d in datas] != want["packets"]:
            raise AssertionError(f"{name} encode: packets differ from the "
                                 f"JAX encoder's")
        if C.pcm_md5(pcm) != want["pcm_md5"]:
            raise AssertionError(f"{name} decode: PCM differs from the JAX "
                                 f"decoder's")
        r["encodes"][name] = {"encode_realtime": secs / (t1 - t0),
                              "decode_realtime": secs / (t2 - t1)}
        log(f"phase 15 {name} {opts}: {len(datas)} packets md5-identical "
            f"to the JAX encoder's, decoded back md5-identical to the JAX "
            f"decoder's; {secs:g} s of audio encoded in {t1 - t0:.2f} s "
            f"({secs / (t1 - t0):.2f}x realtime), decoded in "
            f"{t2 - t1:.2f} s ({secs / (t2 - t1):.2f}x) [{card}]")
    fftmdct.mdct.calls = 0
    t0 = time.perf_counter()
    datas = C.encode(api, Frame, *C.AC3, src, device=dev)
    seconds = time.perf_counter() - t0
    calls = fftmdct.mdct.calls
    par = api.CodecParameters(codec_type=api.MediaType.AUDIO,
                              codec_id="ac3", sample_rate=48000, channels=2)
    ac3 = snr_bar("AC-3 encode", src, par, datas,
                  testdata.read_packets(C.JAX_PACKETS["ac3"]))
    if calls != len(datas):
        raise AssertionError(f"AC-3 encode: {calls} MDCT calls for "
                             f"{len(datas)} frames")
    r["ac3"] = dict(ac3, mdct_calls=calls, realtime=secs / seconds)
    log(f"phase 15 ac3 {C.AC3[1]}: {ac3['packets']} packets, "
        f"{ac3['differing']} differ from the JAX encoder's, SNR "
        f"{ac3['snr_db']:.4f} dB against the JAX packets' "
        f"{ac3['jax_snr_db']:.4f} dB (both decoded by the port); {calls} "
        f"MDCT calls on the card; {secs:g} s of audio in {seconds:.2f} s "
        f"({secs / seconds:.2f}x realtime) [{card}]")
    return r


# phase 16's card-against-CPU checks: each registered video filter with
# the option sets of tests/test_torch_filters_video.py, at the 1080p
# frames' sizes; "fld:" runs on three frames of the MPEG-2 field-picture
# stream (interlaced, top field first), the others on two of the bench
# stream's, "rgb:" after a conversion to rgb24, "notb:" on frames without
# a time base (settb raises on the others, as the JAX filter does);
# "src:" generates 1080p frames (movie: frames.mjpeg's 4)
FILTER_CHECKS = [
    "null", "copy", "fifo", "buffer", "buffersink", "split", "hwmap",
    "nullsink", "showinfo", "pixdesctest", "hwupload,hwdownload",
    "fps=12", "setpts=PTS*2+1", "trim=1:2", "select=mod(n\\,2)",
    "setdar=dar=16/9", "setsar=sar=3/2", "format=yuv444p",
    "noformat=yuv420p", "scale=1280:720",
    "crop=1280:720:320:180", "crop=640:360", "pad=1920:1088:0:4",
    "pad=2000:1200:40:60:16", "transpose=0", "transpose=1", "transpose=2",
    "transpose=3", "hflip", "vflip", "shuffleplanes=0:2:1",
    "drawbox=64:64:320:180:red", "drawbox=-2:-3:600:400:0x3366cc",
    "fade=in:0:3", "fade=out:1:2", "boxblur", "boxblur=2:1",
    "boxblur=5:2:1:1", "boxblur=0:3", "lut=c0=val*2:c1=negval",
    "lutyuv=y=negval", "lutyuv=u=clipval:v=gammaval(0.5)", "negate",
    "unsharp", "unsharp=13:13:1.5", "unsharp=3:5:-1.0:7:3:0.5", "hqdn3d",
    "hqdn3d=8:6:12:9", "gradfun", "gradfun=3.0:8",
    "delogo=x=100:y=100:w=200:h=80", "delogo=x=0:y=0:w=100:h=100:show=1",
    "delogo=x=100:y=100:w=200:h=80:band=1", "interlace", "interlace=bff:0",
    "blackframe", "blackframe=amount=0:threshold=100", "cropdetect",
    "cropdetect=limit=100:round=4:reset=2",
    "split[a][b];[a]crop=256:256:0:0[c];[b][c]overlay=x=640:y=360",
    "split[a][b];[b]hflip[c];[a][c]framepack=sbs",
    "split[a][b];[b]hflip[c];[a][c]framepack=tab",
    "split[a][b];[b]hflip[c];[a][c]framepack=lines",
    "split[a][b];[b]hflip[c];[a][c]framepack=columns",
    "split[a][b];[b]negate[c];[a][c]framepack=frameseq",
    "rgb:lutrgb=r=maxval-val:g=val/2", "rgb:negate", "rgb:hflip",
    "fld:yadif", "fld:yadif=1", "fld:yadif=2:0", "fld:yadif=3:1",
    "fld:yadif=0:-1:1", "fld:fieldorder=0", "fld:fieldorder=1",
    "notb:settb=1/90000", "src:testsrc=size=1920x1080:duration=2",
    "src:nullsrc=size=1920x1080:duration=2",
    "src:color=color=orange:size=1920x1080:duration=2",
    "src:rgbtestsrc=size=1920x1080:duration=2", "src:movie",
]
# the host loops and yadif: launches per frame printed
FILTER_LAUNCHES = ("hqdn3d", "gradfun", "fld:yadif", "fld:yadif=1")


def filter_frames(planes, dev, interlaced=False):
    """Frames (pts 0, 1, ...; time base 1/25) of host (Y, U, V) planes,
    their planes on dev."""
    import torch
    from libav_tpu_torch.avutil.frame import Frame
    from libav_tpu_torch.avutil.rational import Rational
    out = []
    for i, (y, u, v) in enumerate(planes):
        f = Frame(width=y.shape[1], height=y.shape[0], format="yuv420p",
                  pts=i, key_frame=i == 0, interlaced_frame=interlaced,
                  top_field_first=True, time_base=Rational(1, 25))
        f.planes = [torch.as_tensor(p).to(dev) for p in (y, u, v)]
        out.append(f)
    return out


def launch_count(fn):
    """Kernel launches of fn(): the cudaLaunchKernel calls that
    torch.profiler's CUDA activity records (runtime calls, which it does
    not lose as it loses device events), and the device kernels it
    holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = kernels = 0
    for e in prof.events():
        if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC"):
            calls += 1
        elif e.device_type == DeviceType.CUDA and "Memcpy" not in e.name \
                and "Memset" not in e.name:
            kernels += 1
    return calls, kernels


def phase_filter_checks(dev, card):
    """Every video filter on the card against the same torch code on the
    CPU, on decoded 1080p frames; its ms per frame on the card."""
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.rational import Rational
    from libav_tpu_torch.filters.graph import FilterGraph, get_filter
    cpu = torch.device("cpu")
    work = tempfile.mkdtemp()
    movie = "filename=" + testdata.write_cli_input(testdata.MJPEG_SMOKE, work)
    sources = {"": DECODED["h264_1080p_ipbb_cabac"][:2],
               "fld:": DECODED["mpeg2_1080i_fieldpic"][:3]}
    rgb = {}
    for d in (dev, cpu):
        g = FilterGraph("format=rgb24", device=d)
        rgb[d.type] = [g.push(f)[0] for f in filter_frames(sources[""], d)]

    def frames(kind, d):
        if kind == "rgb:":
            return [f.clone_props() for f in rgb[d.type]]
        if kind == "src:":
            return [None, None]          # the count the ms are over
        out = filter_frames(sources.get(kind, sources[""]), d,
                            interlaced=kind == "fld:")
        for f in out:
            if kind == "notb:":
                f.time_base = Rational(0, 1)
        return out

    def run(desc, d, inputs):
        if inputs[0] is None:            # a source
            name, _, args = desc.partition("=")
            return list(get_filter(name)(args or movie, device=d)
                        .generate())
        g = FilterGraph(desc, device=d)
        out = [o for f in inputs for o in g.push(f)]
        return out + g.push_eof()

    results = {}
    for check in FILTER_CHECKS:
        kind = next((k for k in ("fld:", "rgb:", "notb:", "src:")
                     if check.startswith(k)), "")
        desc = check[len(kind):]
        t0 = time.perf_counter()
        want = run(desc, cpu, frames(kind, cpu))
        inputs = frames(kind, dev)
        run(desc, dev, inputs[:1])                   # warm: tables, LUTs
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        got = run(desc, dev, inputs)
        stop.record()
        torch.cuda.synchronize()
        # a source's ms are per frame it generates
        ms = start.elapsed_time(stop) / (len(got) if kind == "src:"
                                         else len(inputs))
        if len(got) != len(want):
            raise AssertionError(f"filter {check}: {len(got)} frames on the "
                                 f"card, {len(want)} on the CPU")
        for k, (g, w) in enumerate(zip(got, want)):
            if (g.pts, g.width, g.height, g.format) != \
                    (w.pts, w.width, w.height, w.format) or \
                    len(g.planes) != len(w.planes):
                raise AssertionError(f"filter {check}: frame {k}'s "
                                     f"properties differ")
            for gp, wp in zip(g.planes, w.planes):
                gp, wp = torch.as_tensor(gp).cpu(), torch.as_tensor(wp)
                if gp.shape != wp.shape or not torch.equal(gp, wp):
                    raise AssertionError(f"filter {check}: frame {k} on "
                                         f"the card differs from the CPU")
        line = (f"phase 16 filter {check}: card equal to CPU over "
                f"{len(want)} frames, {ms:.3f} ms per input 1080p frame")
        entry = {"ms_per_frame": ms}
        if check in FILTER_LAUNCHES:
            calls, kernels = launch_count(lambda: run(desc, dev, inputs))
            entry["launches_per_frame"] = calls / len(inputs)
            line += (f", {calls / len(inputs):.0f} launches per input "
                     f"frame ({kernels} of {calls} kernels held by the "
                     f"profile)")
        results[check] = entry
        log(line + f"; {time.perf_counter() - t0:.1f} s [{card}]")
    shutil.rmtree(work, ignore_errors=True)
    return results


def phase_filters(dev, card, cli_fps, config5):
    """Phase 16: the filter path. Runs A-E of testdata.FILTER_RUNS through
    the port's avconv on the card against the JAX CLI's committed
    outputs, with K1, K2 and sws_yuv2rgb launch counts and fps beside the
    same run without filters; then every video filter, card against
    CPU."""
    import hashlib
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.swscale import yuv2rgb as y2r
    from libav_tpu_torch.tools import avconv
    gold = testdata.load_golden(testdata.filters_golden_path())
    h264_frames = len(testdata.load_golden()["frames"])
    # the same work without a filter: -> (argv after the inputs, input)
    plain = {"A_yadif": testdata.MPEG4_CLI_ARGS,
             "E_fps": ("-f", "framecrc"), "E_af": ("-f", "s16le")}
    base_fps = {"B_pixel": cli_fps["h264_1080p_ipbb_cabac"],
                "D_overlay": cli_fps["h264_1080p_ipbb_cabac"],
                "E_interlace": cli_fps["h264_1080p_ipbb_cabac"],
                "C_rgb": config5["fps"]["h264_rgb24"]}
    work = tempfile.mkdtemp()
    r = {"runs": {}}
    t_phase = time.perf_counter()
    try:
        bench = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        mp4 = os.path.join(work, testdata.FILTER_MP4)
        run_cli(avconv, ["-i", bench, *testdata.FILTER_MP4_ARGS, mp4], dev)
        with open(mp4, "rb") as f:
            if hashlib.md5(f.read()).hexdigest() != gold["mp4"]["md5"]:
                raise AssertionError("avconv -c copy bench.mp4 differs from "
                                     "the JAX CLI's")
        for run, (names, args) in testdata.FILTER_RUNS.items():
            inputs = [a for path in testdata.filter_inputs(run, work)
                      for a in ("-i", path)]
            want = gold["runs"][run]
            framecrc = "frames" in want
            out = os.path.join(work, run + ".out")
            db.h264_deblock_frame.launches = 0
            idct.idct8x8_int.launches = 0
            y2r.yuv2rgb.launches = 0
            _, err, seconds = run_cli(avconv, ["-benchmark", *inputs, *args,
                                               out], dev)
            counts = {"K1": db.h264_deblock_frame.launches,
                      "K2": idct.idct8x8_int.launches,
                      "sws_yuv2rgb": y2r.yuv2rgb.launches}
            with open(out, "rb") as f:
                data = f.read()
            if framecrc:
                with open(testdata.filter_run_path(run), "rb") as g:
                    same = data == g.read()
            else:
                same = hashlib.md5(data).hexdigest() == want["md5"]
            if not same:
                raise AssertionError(f"filter run {run}: the output differs "
                                     f"from the JAX CLI's")
            h264 = "h264_1080p_ipbb_cabac" in names or \
                testdata.FILTER_MP4 in names
            if counts["K1"] != (h264_frames if h264 else 0):
                raise AssertionError(f"filter run {run}: {counts['K1']} K1 "
                                     f"launches, expected "
                                     f"{h264_frames if h264 else 0}")
            if run == "C_rgb" and counts["sws_yuv2rgb"] != want["frames"]:
                raise AssertionError(f"filter run C: {counts['sws_yuv2rgb']}"
                                     f" sws_yuv2rgb launches, expected "
                                     f"{want['frames']}")
            if run in ("A_yadif", "D_overlay") and not counts["K2"]:
                raise AssertionError(f"filter run {run}: no K2 launch")
            entry = {"seconds": seconds, **counts}
            line = (f"phase 16 run {run}: avconv {' '.join(args)}: "
                    f"{'framecrc' if framecrc else 'md5'}-identical to the "
                    f"JAX CLI's; {counts['K1']} K1, {counts['K2']} K2, "
                    f"{counts['sws_yuv2rgb']} sws_yuv2rgb launches")
            if run in plain:
                # the same inputs and output without the filter
                _, err0, seconds0 = run_cli(
                    avconv, ["-benchmark", *inputs, *plain[run],
                             os.path.join(work, run + ".plain")], dev)
            if run == "E_af":
                secs = testdata.AUDIO_STREAMS["ac3_20_48k"][1]
                entry.update(realtime=secs / seconds,
                             plain_realtime=secs / seconds0)
                line += (f"; {secs / seconds:.2f}x realtime, "
                         f"{secs / seconds0:.2f}x without -af")
            else:
                fps = bench_frames(err)["fps"]
                fps0 = bench_frames(err0)["fps"] if run in plain else \
                    base_fps[run]
                entry.update(fps=fps, plain_fps=fps0)
                line += (f"; CLI {fps} fps ({seconds:.2f} s wall), "
                         f"{fps0} fps without the filter")
            r["runs"][run] = entry
            log(line + f" [{card}]")
        r["cli_s"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r["filters"] = phase_filter_checks(dev, card)
    r["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {r['seconds']:.1f} s ({r['cli_s']:.1f} s of CLI runs)")
    return r


def mpeg_picture_count(data: bytes, types=(1, 2)) -> int:
    """The pictures of picture_coding_type in types (1 I, 2 P, 3 B) in
    MPEG-1/2 video bytes; by default the I and P pictures, those an
    encoder reconstructs, one K2 launch each (a field picture counts as
    one)."""
    n, i = 0, data.find(b"\x00\x00\x01\x00")
    while 0 <= i < len(data) - 5:
        n += ((data[i + 5] >> 3) & 7) in types
        i = data.find(b"\x00\x00\x01\x00", i + 4)
    return n


def demux_file(path):
    """(codec parameters of stream 0, its packets' bytes) of a file,
    through the port's demuxer."""
    from libav_tpu_torch.avutil.error import AVError
    from libav_tpu_torch.formats.api import FormatContext
    ic = FormatContext.open_input(path)
    datas = []
    try:
        while True:
            try:
                pkt = ic.read_frame()
            except AVError:
                break
            if pkt.stream_index == 0:
                datas.append(bytes(pkt.data))
        return ic.streams[0].codecpar, datas
    finally:
        ic.close()


def decode_legacy(dev, par, datas, timed=False):
    """Decode a legacy stream (H.263, FLV1, MSMPEG4) with the port's
    decoder on dev: (host (Y, U, V) per frame, seconds, K2 launches, the
    synchronised ms of each picture's Recon module if timed)."""
    import torch
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs import mpegvideo
    from libav_tpu_torch.codecs.api import find_decoder
    from libav_tpu_torch.ops import idct
    recon_ms = []
    forward = mpegvideo.Recon.forward

    def timed_forward(*args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = forward(*args, **kw)
        torch.cuda.synchronize(dev)
        recon_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    if timed:
        mpegvideo.Recon.forward = timed_forward
    idct.idct8x8_int.launches = 0
    dec = find_decoder(par.codec_id)(par, device=dev)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        dec.close()
        mpegvideo.Recon.forward = forward
    launches = idct.idct8x8_int.launches
    if not all(p.device == dev for f in frames for p in f.planes):
        raise AssertionError(f"{par.codec_id}: frames not on the card")
    return [f.to_host().planes for f in frames], seconds, launches, recon_ms


def phase_mpeg12(dev, card):
    """Phase 17: the MPEG-1/2 encoders on the card (the committed MPEG-2
    streams re-encoded from the pattern byte for byte, runs M1, M2aq and
    M2rc against the JAX encoders' golden, K2 once per reconstructed
    anchor or field picture, warm fps and stage ms, the CLI's .m2v and
    .ts outputs against the JAX CLI's md5) and the legacy decoders
    (H.263, FLV1, MSMPEG4 v3/v2, WMV1 streams against the JAX decoders'
    digests, K2 once per picture, fps and host share, the CLI's framecrc
    against the JAX CLI's)."""
    import hashlib
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import h264deblock, idct
    from libav_tpu_torch.tools import avconv
    from libav_tpu_torch.tools import encode_probe as ep
    t_phase = time.perf_counter()
    gold = testdata.load_golden(testdata.mpeg12_golden_path())
    n, width, height = gold["frames"], gold["width"], gold["height"]
    for t, want in enumerate(gold["source"]):
        got = testdata.plane_adler32(testdata.pattern(width, height, t))
        if got != want:
            raise AssertionError(f"the pattern's frame {t} planes {got} "
                                 f"differ from the golden's source {want}:"
                                 f" numpy's sin/cos differ here")
    frames = ep.pattern_frames(dev, width, height, n)
    k2 = {}

    def encode(tag, codec, settings, nframes, anchors=None):
        idct.idct8x8_int.launches = 0
        datas, seconds = ep.encode(dev, frames[:nframes], settings,
                                   anchors, codec=codec)
        k2[tag] = idct.idct8x8_int.launches
        want = mpeg_picture_count(b"".join(datas))
        if k2[tag] != want:
            raise AssertionError(f"{tag}: {k2[tag]} K2 launches, {want} "
                                 f"anchors or field pictures coded")
        return datas, seconds

    for name, (nf, settings) in testdata.MPEG2_STREAMS.items():
        if gold["streams"][name] != settings:
            raise AssertionError(f"{name}: settings differ from the golden")
        want = testdata.read_packets(testdata.stream_paths(name)[0])
        got, seconds = encode(f"mpeg2 encode {name}", "mpeg2video",
                              settings, nf)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise AssertionError(f"{name}: packet {i} differs from the "
                                     f"committed stream's")
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} packets, the stream "
                                 f"has {len(want)}")
        log(f"phase 17 MPEG-2 encode of {nf} pattern frames {settings}: "
            f"{len(got)} packets ({sum(map(len, got))} bytes) byte-identical"
            f" to {name}.m2vpkts (the JAX encoder's), "
            f"{k2['mpeg2 encode ' + name]} K2 launches, {seconds:.2f} s")

    for run, want in gold["runs"].items():
        codec, settings = testdata.MPEG12_RUNS[run]
        if (codec, settings) != (want["codec"], want["settings"]):
            raise AssertionError(f"run {run}: settings differ from the "
                                 f"golden's")
        anchors = []
        got, seconds = encode(f"run {run}", codec, settings, n, anchors)
        if ep.packet_digests(got) != want["packets"]:
            raise AssertionError(f"run {run}: packets differ from the JAX "
                                 f"encoder's golden")
        if testdata.digest(anchors)["frames"] != want["anchors"]:
            raise AssertionError(f"run {run}: anchors differ from the JAX "
                                 f"encoder's golden")
        log(f"phase 17 run {run} ({codec} {settings}): {len(got)} packets "
            f"({sum(map(len, got))} bytes) md5-identical to the JAX "
            f"encoder's, {len(anchors)} anchors adler32-identical, "
            f"{k2['run ' + run]} K2 launches, {seconds:.2f} s")

    fps = {}
    for name, (nf, settings) in testdata.MPEG2_STREAMS.items():
        _, seconds = ep.encode(dev, frames[:nf], settings,
                               codec="mpeg2video")
        fps[name] = nf / seconds
    name = "mpeg2_1080p_ipbb"
    nf, settings = testdata.MPEG2_STREAMS[name]
    with ep.stages(dev, "mpeg2video") as stages:
        _, staged_s = ep.encode(dev, frames[:nf], settings,
                                codec="mpeg2video")
    log(f"phase 17 warm MPEG-2 encode: {name} {fps[name]:.3f} fps "
        f"({1e3 / fps[name]:.1f} ms/frame), mpeg2_1080i_fieldpic "
        f"{fps['mpeg2_1080i_fieldpic']:.3f} fps [{card}]")
    log(f"phase 17 stages of the {name} encode (synchronised, ms per call, "
        f"{staged_s:.2f} s pass):")
    for label, ms in stages.items():
        log(f"phase 17   {label}: {', '.join(f'{x:.2f}' for x in ms)} "
            f"(sum {sum(ms):.1f})")

    cli_fps = {}
    work = tempfile.mkdtemp()
    try:
        src = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        for out, args in testdata.MPEG12_CLI.items():
            dst = os.path.join(work, out)
            idct.idct8x8_int.launches = 0
            h264deblock.h264_deblock_frame.launches = 0
            _, err, seconds = run_cli(avconv, ["-benchmark", "-i", src,
                                               *args, dst], dev)
            k2[f"cli {out}"] = idct.idct8x8_int.launches
            k1 = h264deblock.h264_deblock_frame.launches
            with open(dst, "rb") as f:
                data = f.read()
            if hashlib.md5(data).hexdigest() != gold["cli"][out]["md5"]:
                raise AssertionError(f"avconv {' '.join(args)} {out}: the "
                                     f"output differs from the JAX CLI's")
            video = data if out.endswith(".m2v") else \
                b"".join(demux_file(dst)[1])
            frames_in = mpeg_picture_count(video, (1, 2, 3))
            if k2[f"cli {out}"] != mpeg_picture_count(video) or \
                    k1 != frames_in:
                raise AssertionError(f"avconv {out}: {k2['cli ' + out]} K2 "
                                     f"and {k1} K1 launches")
            cli_fps[out] = float(re.search(r"fps=([0-9.]+)", err).group(1))
            log(f"phase 17 avconv -benchmark -i bench.h264 {' '.join(args)} "
                f"{out}: {len(data)} bytes md5-identical to the JAX CLI's, "
                f"{k1} K1 and {k2['cli ' + out]} K2 launches; CLI "
                f"{cli_fps[out]} fps ({seconds:.2f} s wall) [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    legacy = testdata.load_golden(testdata.legacy_golden_path())
    dec_fps = {}
    for name, (fname, codec, w, h, npic) in testdata.LEGACY.items():
        path, framecrc = testdata.legacy_paths(name)
        par, datas = demux_file(path)
        if par.codec_id != codec or len(datas) != npic:
            raise AssertionError(f"{fname}: {par.codec_id}, {len(datas)} "
                                 f"packets")
        host, first_s, launches, _ = decode_legacy(dev, par, datas)
        check_golden(host, legacy[name], f"{name} decode")
        if launches != npic:
            raise AssertionError(f"{name}: {launches} K2 launches, "
                                 f"expected {npic}")
        k2[f"{name} decode"] = launches
        host, warm_s, _, _ = decode_legacy(dev, par, datas)
        check_golden(host, legacy[name], f"{name} warm decode")
        dec_fps[name] = npic / warm_s
        # a third, warm pass with each Recon.forward synchronised: the
        # share of its wall time spent outside the Recon module
        host, timed_s, _, recon_ms = decode_legacy(dev, par, datas, True)
        check_golden(host, legacy[name], f"{name} timed decode")
        share = 100 * (1 - sum(recon_ms) / (1e3 * timed_s))
        work = tempfile.mkdtemp()
        try:
            out = os.path.join(work, "out.framecrc")
            idct.idct8x8_int.launches = 0
            _, err, seconds = run_cli(avconv, ["-benchmark", "-i", path,
                                               "-f", "framecrc", out], dev)
            cli_launches = idct.idct8x8_int.launches
            with open(out, "rb") as f, open(framecrc, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"avconv -i {fname}: framecrc "
                                         f"differs from the JAX CLI's")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if cli_launches != npic:
            raise AssertionError(f"avconv -i {fname}: {cli_launches} K2 "
                                 f"launches")
        log(f"phase 17 {codec} decode of {fname} ({w}x{h}, {npic} pictures,"
            f" {os.path.getsize(path)} bytes): frames identical to the JAX "
            f"decoder's golden, {launches} K2 launches; warm "
            f"{dec_fps[name]:.3f} fps; first pass {first_s:.2f} s; warm "
            f"timed pass {timed_s:.2f} s, recon module ms "
            f"{', '.join(f'{x:.2f}' for x in recon_ms)}, host share "
            f"{share:.1f}% outside Recon.forward; avconv -benchmark -f framecrc "
            f"byte-identical to the JAX CLI's, {cli_launches} K2 launches, "
            f"{float(re.search(r'fps=([0-9.]+)', err).group(1))} fps "
            f"[{card}]")
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {"k2": k2, "encode_fps": fps, "cli_fps": cli_fps,
            "decode_fps": dec_fps}


def h264_ref_pictures(datas) -> int:
    """The coded pictures (one per packet) whose first slice has a
    nonzero nal_ref_idc: the H.264 encoder's closed loop reconstructs,
    and with deblocking deblocks, each of them."""
    n = 0
    for d in datas:
        for m in re.finditer(b"\x00\x00\x01", d):
            hdr = d[m.end()]
            if hdr & 0x1F in (1, 5):
                n += (hdr >> 5) & 3 != 0
                break
    return n


def stage_lines(tag, stages):
    for label, ms in stages.items():
        log(f"phase 18   {tag} {label}: "
            f"{', '.join(f'{x:.2f}' for x in ms)} (sum {sum(ms):.1f})")


def phase_h264_encode(dev, card):
    """Phase 18: the H.264 and MJPEG encoders on the card (the pattern's
    planes against the golden's adler32; the bench stream and the PAFF
    stream re-encoded from the pattern byte for byte, with K1 once per
    reference picture in the closed loop, and decoded by the port to the
    JAX decoder's golden; the MJPEG stream byte for byte through the
    native packer; K1 against deblock_frame_plain on the first reference
    picture's closed-loop deblock; the CLI encodes against the JAX CLI's
    md5; warm fps, stage ms per picture, K1's device time)."""
    import hashlib
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.codecs.h264 import device as h264device
    from libav_tpu_torch.codecs.mjpeg import enc as mjpeg_enc
    from libav_tpu_torch.native import jpeg_enc
    from libav_tpu_torch.ops import h264deblock
    from libav_tpu_torch.tools import avconv
    from libav_tpu_torch.tools import encode_probe as ep
    t_phase = time.perf_counter()
    gold = testdata.load_golden(testdata.encode_cli_golden_path())
    for w, h, n in testdata.ENCODE_SOURCES:
        for t, want in enumerate(gold["source"][f"{w}x{h}"]):
            got = testdata.plane_adler32(testdata.pattern(w, h, t))
            if got != want:
                raise AssertionError(f"the pattern's {w}x{h} frame {t} "
                                     f"planes {got} differ from the "
                                     f"golden's {want}: numpy's sin/cos "
                                     f"differ here")
    k1, fps, seconds = {}, {}, {}

    def encode(tag, frames, settings, want, codec="h264", encoders=None):
        h264deblock.h264_deblock_frame.launches = 0
        datas, secs = ep.encode(dev, frames, settings, codec=codec,
                                encoders=encoders)
        launches = h264deblock.h264_deblock_frame.launches
        if len(datas) != len(want):
            raise AssertionError(f"{tag}: {len(datas)} packets, the "
                                 f"committed stream has {len(want)}")
        for i, (g, w) in enumerate(zip(datas, want)):
            if g != w:
                raise AssertionError(f"{tag}: packet {i} differs from the "
                                     f"committed stream's")
        if codec == "h264":
            refs = h264_ref_pictures(datas) if settings.get("deblock") \
                else 0
            if launches != refs:
                raise AssertionError(f"{tag}: {launches} K1 launches, "
                                     f"{refs} reference pictures deblocked")
        return datas, secs, launches

    # (a) the bench stream; the first closed-loop deblock's padded planes
    # and grids kept as K1 found them, and the planes the loop kept
    captured = []
    forward = h264device.ReconH264Deblock.forward

    def capture(self, *args, run=h264deblock.h264_deblock_frame, **kw):
        def kept(*k1_args):
            captured.append([a.clone() if isinstance(a, torch.Tensor)
                             else a for a in k1_args])
            return run(*k1_args)
        result = forward(self, *args, run=kept if not captured else run,
                         **kw)
        if len(captured) == 1:
            captured.append([p.clone() for p in result[0]])
        return result
    frames = ep.pattern_frames(dev, 1920, 1080, testdata.BENCH_FRAMES)
    want = testdata.read_packets(testdata.SMOKE_STREAM)
    # one pass, staged: every stage synchronised, which costs little
    # where the host packer holds the card idle
    h264device.ReconH264Deblock.forward = capture
    try:
        with ep.stages(dev, "h264") as stages:
            datas, staged_s, k1["h264 encode"] = encode(
                "bench encode", frames, testdata.BENCH_SETTINGS, want)
    finally:
        h264device.ReconH264Deblock.forward = forward
    host, _, _ = decode(dev, datas)
    check_golden(host, testdata.load_golden(testdata.SMOKE_GOLDEN),
                 "bench encode's decode")
    fps["h264_1080p_ipbb_cabac"] = len(frames) / staged_s
    pack = sum(stages["host packing (slice headers + entropy)"])
    log(f"phase 18 H.264 encode of {len(frames)} pattern frames 1920x1080 "
        f"{testdata.BENCH_SETTINGS}: {len(datas)} packets "
        f"({sum(map(len, datas))} bytes) byte-identical to "
        f"h264_1080p_ipbb_cabac.h264pkts (the JAX encoder's), decoded by "
        f"the port to its golden, {k1['h264 encode']} K1 launches (one per "
        f"reference picture); one staged pass "
        f"{fps['h264_1080p_ipbb_cabac']:.3f} fps ({staged_s:.2f} s), host "
        f"packing {pack / 1e3:.2f} s ({100 * pack / (1e3 * staged_s):.1f}%) "
        f"[{card}]")
    stage_lines("bench", stages)
    seconds["h264_1080p_ipbb_cabac"] = {"staged": staged_s,
                                        "packing_ms": pack}

    # (d) K1 against its plain version inside the encoder's loop: the
    # first reference picture's deblock again through deblock_frame_plain
    k1_args, kept_planes = captured
    plain = [a.clone() for a in k1_args[:3]]
    h264deblock.deblock_frame_plain(*plain, *k1_args[3:])
    max_err = max(int((p[4:, 4:] - q.to(torch.int32)).abs().max())
                  for p, q in zip(plain, kept_planes))
    if max_err:
        raise AssertionError(f"closed-loop deblock: K1 differs from "
                             f"deblock_frame_plain by {max_err}")
    work_planes = [a.clone() for a in k1_args[:3]]

    def restore():
        for w, a in zip(work_planes, k1_args[:3]):
            w.copy_(a)

    def launch():
        h264deblock.h264_deblock_frame(*work_planes, *k1_args[3:])
    k1_dev = kernel_device_ms(launch, "deblock_frame_kernel",
                              h264deblock.h264_deblock_frame, reps=10,
                              before=restore)
    k1_sync = stages[ep.K1_LABEL]
    log(f"phase 18 K1 in the encoder's closed loop (the I_8x8 picture's "
        f"deblock, 120x68 MBs): equal to deblock_frame_plain, max_abs_err "
        f"{max_err}; device {k1_dev:.4f} ms per launch on its padded "
        f"planes and grids (profiler); "
        f"synchronised per launch in the staged pass "
        f"{', '.join(f'{x:.3f}' for x in k1_sync)} ms [{card}]")

    # (b) PAFF: field pictures, K1 on field rules
    name = "h264_1088i_paff"
    w, h, n, settings = testdata.H264_EXT[name]
    path, golden = testdata.stream_paths(name)
    pframes = ep.pattern_frames(dev, w, h, n)
    # one pass, staged: the bench encode above warmed every program but
    # the I_4x4 wavefront's and the field deblock's
    with ep.stages(dev, "h264") as pstages:
        datas, cold_s, k1["paff encode"] = encode(
            "paff encode", pframes, settings, testdata.read_packets(path))
    host, _, _ = decode(dev, datas)
    check_golden(host, testdata.load_golden(golden), "paff encode's decode")
    fps[name] = n / cold_s
    log(f"phase 18 H.264 PAFF encode of {n} pattern frames {w}x{h} "
        f"{settings}: {len(datas)} field packets byte-identical to "
        f"{name}.h264pkts, decoded by the port to its golden, "
        f"{k1['paff encode']} K1 launches (field rules); one staged pass "
        f"{fps[name]:.3f} fps ({cold_s:.2f} s) [{card}]")
    stage_lines("paff", pstages)

    # (c) MJPEG through the native packer
    if not jpeg_enc.available():
        raise AssertionError("the native JPEG packer did not build")
    mframes = ep.pattern_frames(dev, 1920, 1080, 4, "yuvj420p")
    mwant = testdata.read_packets(
        testdata.stream_paths(testdata.MJPEG_SMOKE)[0])
    encoders = []
    encode("mjpeg encode", mframes, {"quality": 90}, mwant, "mjpeg",
           encoders)
    if encoders[0].packer != "native":
        raise AssertionError(f"mjpeg: the {encoders[0].packer} packer ran")
    mj = {}
    timed = [(mjpeg_enc.EncodePlane, "forward", "planes (device, ms)"),
             (mjpeg_enc.MJPEGEncoder, "_encode_scan", "native pack (ms)")]
    saved = [(c, a, getattr(c, a)) for c, a, _ in timed]
    for cls, attr, label in timed:
        def wrap(*a, _f=getattr(cls, attr), _l=label, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = _f(*a, **k)
            torch.cuda.synchronize(dev)
            mj.setdefault(_l, []).append(1e3 * (time.perf_counter() - t0))
            return r
        setattr(cls, attr, wrap)
    try:
        encoders = []
        _, warm_s, _ = encode("mjpeg warm encode", mframes,
                              {"quality": 90}, mwant, "mjpeg", encoders)
    finally:
        for cls, attr, inner in saved:
            setattr(cls, attr, inner)
    fps[testdata.MJPEG_SMOKE] = len(mframes) / warm_s
    log(f"phase 18 MJPEG encode of 4 yuvj420p pattern frames 1920x1080 at "
        f"quality 90: byte-identical to mjpeg_1080p.mjpegpkts, packer "
        f"{encoders[0].packer}; warm (timed) {fps['mjpeg_1080p']:.3f} fps; "
        + "; ".join(f"{k} {', '.join(f'{x:.2f}' for x in v)}"
                    for k, v in mj.items()) + f" [{card}]")

    # (e) the CLI encodes against the JAX CLI's md5
    work = tempfile.mkdtemp()
    cli_fps = {}
    try:
        for out, (src_name, args) in testdata.ENCODE_CLI.items():
            src = testdata.write_cli_input(src_name, work)
            dst = os.path.join(work, out)
            h264deblock.h264_deblock_frame.launches = 0
            _, err, secs = run_cli(avconv, ["-benchmark", "-i", src, *args,
                                            dst], dev)
            launches = h264deblock.h264_deblock_frame.launches
            with open(dst, "rb") as f:
                data = f.read()
            if hashlib.md5(data).hexdigest() != gold["cli"][out]["md5"]:
                raise AssertionError(f"avconv -i {os.path.basename(src)} "
                                     f"{' '.join(args)} {out}: the output "
                                     f"differs from the JAX CLI's")
            cli_fps[out] = float(re.search(r"fps=([0-9.]+)", err).group(1))
            k1[f"cli {out}"] = launches
            log(f"phase 18 avconv -benchmark -i {os.path.basename(src)} "
                f"{' '.join(args)} {out}: {len(data)} bytes md5-identical "
                f"to the JAX CLI's, {launches} K1 launches; CLI "
                f"{cli_fps[out]} fps ({secs:.2f} s wall) [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if k1["cli out.avi"] != testdata.BENCH_FRAMES or not k1["cli out.h264"]:
        raise AssertionError(f"CLI K1 launches {k1}")

    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"k1": k1, "fps": fps, "cli_fps": cli_fps, "seconds": seconds,
            "k1_closed_loop": {"max_abs_err": max_err,
                               "device_ms": k1_dev,
                               "synchronised_ms": k1_sync}}


def prores_ffv1_sources(gold_p, gold_f):
    """Phase 19's source frames as host planes, each checked against its
    golden's adler32 before any encode: -> (10-bit, 8-bit) per frame."""
    from libav_tpu_torch import testdata
    w, h = testdata.PRORES_SIZE
    src10, src8 = [], []
    for t in range(testdata.PRORES_FRAMES):
        src10.append(testdata.pattern10(w, h, t))
        src8.append(testdata.pattern(w, h, t))
        for tag, planes, want, dt in (
                ("pattern10", src10[-1], gold_p["source"][t], "<u2"),
                ("pattern", src8[-1], gold_f["source"][t], "u1")):
            got = testdata.plane_adler32(planes, dt)
            if got != want:
                raise AssertionError(f"the {tag} {w}x{h} frame {t} planes "
                                     f"{got} differ from the golden's "
                                     f"{want}: numpy differs here")
    return src10, src8


def check_packets(tag, datas, want, flags=None):
    import hashlib
    got = [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
           for d in datas]
    if flags is not None:
        for g, f in zip(got, flags):
            g["key"] = bool(f & 1)
    if got != want:
        raise AssertionError(f"{tag}: packets {got} differ from the JAX "
                             f"encoder's golden {want}")


@contextlib.contextmanager
def timed_calls(dev, patches, out, keep=None):
    """Each (cls, attr, label) method synchronised and timed into
    out[label] (ms per call) while inside; with keep, the arguments of
    each call of a `forward` are kept there too (keep[label]).
    Measurement only."""
    import torch
    saved = [(c, a, getattr(c, a)) for c, a, _ in patches]
    for cls, attr, label in patches:
        def wrap(*args, _f=getattr(cls, attr), _l=label, _a=attr, **kw):
            if keep is not None and _a == "forward":
                keep.setdefault(_l, []).append(args)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = _f(*args, **kw)
            torch.cuda.synchronize(dev)
            out.setdefault(_l, []).append(1e3 * (time.perf_counter() - t0))
            return r
        setattr(cls, attr, wrap)
    try:
        yield out
    finally:
        for cls, attr, inner in saved:
            setattr(cls, attr, inner)


def phase_prores_ffv1(dev, card):
    """Phase 19: ProRes and FFV1 on the card. prores_idct and fdct10
    against the numpy goldens on 65,280 blocks (a 1080p 4:2:2 picture),
    exact, with their device ms by CUDA events, launches and byte bound;
    two 1920x1080 yuv422p10le frames of testdata.pattern10 through the
    port's ProresEncoder (standard profile, rate-controlled) on the card,
    packets equal to the JAX encoder's golden, then through its
    ProresDecoder, frames equal to the JAX decoder's; the same frames'
    8-bit source through FFV1 (range coder, 5-gradient context, the
    second frame a non-key frame), packets golden and the decode equal to
    the source; the CLI to .mov from 10-bit rawvideo and to .avi from
    ipbb.m2v against the JAX CLI's md5 and framecrc; stage ms per picture
    and each run's fps."""
    import hashlib
    import numpy as np
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.avutil.frame import Frame, Packet
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.codecs.ffv1.dec import FFV1Decoder
    from libav_tpu_torch.codecs.ffv1.enc import FFV1Encoder
    from libav_tpu_torch.codecs.prores import dec as pdec
    from libav_tpu_torch.codecs.prores import enc as penc
    from libav_tpu_torch.ops import prores_dct
    from libav_tpu_torch.tools import avconv
    t_phase = time.perf_counter()
    gold_p = testdata.load_golden(testdata.prores_golden_path())
    gold_f = testdata.load_golden(testdata.ffv1_golden_path())
    w, h = testdata.PRORES_SIZE
    src10, src8 = prores_ffv1_sources(gold_p, gold_f)
    out = {"fps": {}}

    # (a) the transforms on a 1080p 4:2:2 picture's 8,160 x 8 blocks
    B = 65280
    coeffs, qrows = testdata.prores_idct_inputs(19, B)
    samples = testdata.prores_fdct_inputs(20, B)
    c_d, q_d, s_d = (torch.tensor(a, device=dev)
                     for a in (coeffs, qrows, samples))
    checks = (
        ("prores_idct", lambda: prores_dct.prores_idct(c_d, q_d),
         prores_dct.prores_idct_ref(coeffs, qrows),
         "coefficients and quant rows (int16) in, samples (uint16) out",
         "dequant products past int16, DC-only blocks, row sums past "
         "int32"),
        ("fdct10", lambda: prores_dct.fdct10(s_d),
         prores_dct.fdct10_ref(samples),
         "samples (uint16) in, coefficients (int16) out",
         "flat, checkerboard and noisy blocks with samples at 0 and "
         "1023"))
    for name, fn, want, what, cases in checks:
        got = fn().cpu().numpy().astype(np.int64)
        err = int(np.abs(got - want.astype(np.int64)).max())
        if err:
            raise AssertionError(f"{name} on the card differs from the "
                                 f"numpy golden by {err}")
        ms = event_ms(fn, reps=10)
        calls, kernels = launch_count(fn)
        nbytes = B * 64 * 2 * (3 if name == "prores_idct" else 2)
        bound = nbytes / HBM_BYTES_PER_MS
        out[name] = {"ms": ms, "launches": calls, "kernels": kernels,
                     "bound_ms": bound, "bytes": nbytes, "max_abs_err": err}
        log(f"phase 19 {name} on {B} blocks: exact against the numpy "
            f"golden ({cases}); {ms:.4f} ms by CUDA "
            f"events, {calls} launches ({kernels} device kernels held); "
            f"bound {bound:.5f} ms ({nbytes} bytes: {what}), "
            f"{100 * bound / ms:.2f}% of it [{card}]")

    # (b) ProRes encode on the card
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="prores",
                          width=w, height=h, pix_fmt="yuv422p10le")
    frames = []
    for t, planes in enumerate(src10):
        f = Frame(width=w, height=h, format="yuv422p10le")
        f.planes = [torch.tensor(p, device=dev) for p in planes]
        f.pts = t
        frames.append(f)
    enc = penc.ProresEncoder(par, device=dev)
    stages, kept = {}, {}
    with timed_calls(dev, [(penc.FdctPlane, "forward", "fdct"),
                           (penc.ProresEncoder, "_find_quants", "rate"),
                           (penc.ProresEncoder, "_pack_frame", "pack"),
                           (penc.ProresEncoder, "_encode", "picture")],
                     stages, kept):
        t0 = time.perf_counter()
        pkts = enc.encode_all(frames)
        enc_s = time.perf_counter() - t0
    datas = [p.data for p in pkts]
    check_packets("prores encode", datas, gold_p["packets"])
    fdct = [sum(stages["fdct"][3 * i:3 * i + 3]) for i in range(len(pkts))]
    host = [p - f for p, f in zip(stages["picture"], fdct)]
    planes = kept["fdct"][-3:]
    fdct_pic = event_ms(lambda: [m(x) for m, x in planes], reps=5)
    fdct_launches = launch_count(lambda: [m(x) for m, x in planes])[0]
    out["fps"]["prores encode"] = len(pkts) / enc_s
    log(f"phase 19 ProRes encode of {len(pkts)} pattern10 frames {w}x{h} "
        f"yuv422p10le (standard profile, rate-controlled) on the card: "
        f"packets ({sum(map(len, datas))} bytes) md5-identical to the JAX "
        f"encoder's golden; {out['fps']['prores encode']:.3f} fps; per "
        f"picture FDCT (pad, block, fdct10; synchronised) "
        f"{', '.join(f'{x:.2f}' for x in fdct)} ms, host rate control "
        f"{', '.join(f'{x:.0f}' for x in stages['rate'])} ms and packing "
        f"{', '.join(f'{x:.0f}' for x in stages['pack'])} ms (host "
        f"{100 * sum(host) / (1e3 * enc_s):.1f}% of the encode); the "
        f"FDCT programs of one picture {fdct_pic:.3f} ms by CUDA events, "
        f"{fdct_launches} launches [{card}]")

    # (c) ProRes decode on the card
    dec = pdec.ProresDecoder(CodecParameters(codec_type=MediaType.VIDEO,
                                             codec_id="prores"), device=dev)
    stages, kept = {}, {}
    with timed_calls(dev, [(pdec.ReconPlane, "forward", "recon"),
                           (pdec.ProresDecoder, "_decode", "picture")],
                     stages, kept):
        t0 = time.perf_counter()
        decoded = dec.decode_all(Packet(data=d, pts=i)
                                 for i, d in enumerate(datas))
        dec_s = time.perf_counter() - t0
    for f in decoded:
        if any(p.device != dev or p.dtype != torch.uint16
               for p in f.planes):
            raise AssertionError("prores decode: planes not uint16 on the "
                                 "card")
    got = testdata.digest([f.to_host().planes for f in decoded], "<u2")
    if got != gold_p["decode"]:
        raise AssertionError("prores decode: frames differ from the JAX "
                             "decoder's golden")
    recon = [sum(stages["recon"][3 * i:3 * i + 3])
             for i in range(len(decoded))]
    entropy = [p - r for p, r in zip(stages["picture"], recon)]
    planes = kept["recon"][-3:]
    recon_pic = event_ms(lambda: [m(*a) for m, *a in planes], reps=5)
    recon_launches = launch_count(lambda: [m(*a) for m, *a in planes])[0]
    out["fps"]["prores decode"] = len(decoded) / dec_s
    log(f"phase 19 ProRes decode on the card: {len(decoded)} frames "
        f"(uint16 planes on the card) adler32+md5 identical to the JAX "
        f"decoder's golden; {out['fps']['prores decode']:.3f} fps; per "
        f"picture host entropy {', '.join(f'{x:.0f}' for x in entropy)} ms, "
        f"recon (synchronised) {', '.join(f'{x:.2f}' for x in recon)} ms "
        f"(host {100 * sum(entropy) / (1e3 * dec_s):.1f}% of the decode); "
        f"the recon programs of one picture (dequant, prores_idct, "
        f"scatter) {recon_pic:.3f} ms by CUDA events, {recon_launches} "
        f"launches; prores_idct alone {out['prores_idct']['ms']:.4f} ms "
        f"against its bound {out['prores_idct']['bound_ms']:.5f} ms "
        f"[{card}]")

    # (d) FFV1, lossless, from planes on the card
    fpar = CodecParameters(codec_type=MediaType.VIDEO, codec_id="ffv1",
                           width=w, height=h, pix_fmt="yuv420p")
    fenc = FFV1Encoder(fpar)
    for k, v in testdata.FFV1_SETTINGS.items():
        fenc.set_opt(k, v)
    ff = []
    for t, planes in enumerate(src8):
        f = Frame(width=w, height=h, format="yuv420p")
        f.planes = [torch.tensor(p, device=dev) for p in planes]
        f.pts = t
        ff.append(f)
    t0 = time.perf_counter()
    fpkts = fenc.encode_all(ff)
    fenc_s = time.perf_counter() - t0
    fdatas = [p.data for p in fpkts]
    check_packets("ffv1 encode", fdatas, gold_f["packets"],
                  [p.flags for p in fpkts])
    fdec = FFV1Decoder(CodecParameters(codec_type=MediaType.VIDEO,
                                       codec_id="ffv1", width=w, height=h),
                       device=dev)
    t0 = time.perf_counter()
    fout = fdec.decode_all(Packet(data=d, pts=i)
                           for i, d in enumerate(fdatas))
    torch.cuda.synchronize(dev)
    fdec_s = time.perf_counter() - t0
    for f, g in zip(fout, ff):
        if not all(p.device == dev and torch.equal(p, q)
                   for p, q in zip(f.planes, g.planes)):
            raise AssertionError("ffv1 decode: not the source planes")
    if len(fout) != len(ff):
        raise AssertionError(f"ffv1 decode: {len(fout)} frames")
    out["fps"]["ffv1 encode"] = len(fpkts) / fenc_s
    out["fps"]["ffv1 decode"] = len(fout) / fdec_s
    log(f"phase 19 FFV1 {testdata.FFV1_SETTINGS} of {len(fpkts)} pattern "
        f"frames {w}x{h} yuv420p from planes on the card: packets "
        f"({', '.join(str(len(d)) for d in fdatas)} bytes; key "
        f"{[bool(p.flags & 1) for p in fpkts]}) md5-identical to the JAX "
        f"encoder's golden; the decode on the card equal to the source "
        f"(lossless); encode {out['fps']['ffv1 encode']:.3f} fps, decode "
        f"{out['fps']['ffv1 decode']:.3f} fps (host Python per sample) "
        f"[{card}]")

    # (e) the CLI, one run each
    work = tempfile.mkdtemp()
    try:
        yuv = testdata.write_pattern10_yuv(work)
        argv = [yuv if a == testdata.PRORES_CLI_INPUT else a
                for a in testdata.PRORES_CLI]
        m2v = testdata.write_cli_input(testdata.FFV1_CLI_SOURCE, work)
        runs = (("out.mov", gold_p, argv),
                ("out.avi", gold_f, ["-i", m2v, *testdata.FFV1_CLI]))
        for name, gold, args in runs:
            want = gold["cli"][name]
            dst = os.path.join(work, name)
            _, err, secs = run_cli(avconv, ["-benchmark", *args, dst], dev)
            with open(dst, "rb") as f:
                data = f.read()
            if hashlib.md5(data).hexdigest() != want["md5"]:
                raise AssertionError(f"avconv {' '.join(want['args'])} "
                                     f"{name}: differs from the JAX CLI's")
            enc_fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
            crc = dst + ".crc"
            _, err, crc_s = run_cli(avconv, ["-benchmark", "-i", dst, "-f",
                                             "framecrc", crc], dev)
            with open(crc) as f:
                text = f.read()
            if text != want["framecrc"]:
                raise AssertionError(f"avconv -i {name} -f framecrc: "
                                     f"differs from the JAX CLI's")
            dec_fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
            out["fps"][f"cli {name}"] = enc_fps
            out["fps"][f"cli {name} framecrc"] = dec_fps
            log(f"phase 19 avconv -benchmark {' '.join(want['args'])} "
                f"{name}: {len(data)} bytes md5-identical to the JAX CLI's, "
                f"CLI {enc_fps} fps ({secs:.2f} s wall); -i {name} -f "
                f"framecrc identical to the JAX CLI's, {dec_fps} fps "
                f"({crc_s:.2f} s wall) [{card}]")
        # lossless: the .avi's frames are the MPEG-2 stream's first two
        with open(testdata.framecrc_path(testdata.FFV1_CLI_SOURCE)) as f:
            src_lines = [[x.strip() for x in ln.split(",")[-2:]]
                         for ln in f if ln.startswith("0,")][:2]
        avi_lines = [[x.strip() for x in ln.split(",")[-2:]] for ln in
                     gold_f["cli"]["out.avi"]["framecrc"].splitlines()
                     if ln.startswith("0,")]
        if avi_lines != src_lines:
            raise AssertionError("out.avi: its frames' size and adler32 "
                                 "differ from ipbb.m2v's first two")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return out


def rtp_receive(url, count, ready_timeout=10.0):
    """Open url (rtp://, .sdp or rtsp://) with the port's demuxer in a
    thread and read count packets: -> (the thread, its state dict, which
    holds the receiver's port, the packets, or its error)."""
    import threading
    from libav_tpu_torch.formats import FormatContext
    state = {"packets": [], "ready": threading.Event()}

    def rx():
        try:
            ic = FormatContext.open_input(url)
            state["port"] = getattr(ic.iformat, "port", None)
            state["ready"].set()
            try:
                for _ in range(count):
                    state["packets"].append(ic.read_frame())
            finally:
                ic.close()
        except Exception as e:  # raised in the phase's thread below
            state["error"] = e
            state["ready"].set()
    t = threading.Thread(target=rx, daemon=True)
    t.start()
    if not state["ready"].wait(ready_timeout) or "error" in state:
        raise AssertionError(f"{url}: receiver failed to open: "
                             f"{state.get('error')!r}")
    return t, state


def rtp_send(port, codec, datas, width, height):
    """The port's RTPMuxer to udp://127.0.0.1:port, 1 ms between
    datagrams so a loopback burst stays inside the receive buffer: ->
    datagrams sent."""
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.avutil.rational import Rational
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.formats import Stream
    from libav_tpu_torch.formats.io import url_open
    from libav_tpu_torch.formats.rtp import RTPMuxer
    mux = RTPMuxer()
    mux.streams = [Stream(index=0, codecpar=CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=width,
        height=height), time_base=Rational(1, 25))]
    sock = url_open(f"udp://127.0.0.1:{port}", "w")
    sent = [0]

    class Paced:
        def write(self, data):
            time.sleep(0.001)
            sent[0] += 1
            return sock.write(data)
    try:
        mux.write_header(Paced())
        for i, d in enumerate(datas):
            mux.write_packet(Packet(data=d, pts=i, dts=i,
                                    time_base=Rational(1, 25)))
    finally:
        sock.close()
    return sent[0]


def rtp_join(t, state, url, count):
    t.join(timeout=60)
    if t.is_alive() or "error" in state or \
            len(state["packets"]) != count:
        raise AssertionError(f"{url}: {len(state['packets'])} of {count} "
                             f"packets received: {state.get('error')!r}")
    return state["packets"]


def phase_protocols_parallel(dev, card):
    """Phase 20: the last modules on the card. The bench stream over RTP
    (UDP loopback) decoded to its golden with its 90 kHz timestamps (K1);
    an MPEG-2 RTP session announced by an SDP file; the IPB MPEG-2 stream
    muxed to MPEG-TS, cut into HLS segments, read as a VOD playlist on
    disk (decoded to its golden, K2) and through a master playlist over
    a loopback http server; the testsrc and sine devices through avconv
    against the JAX CLI's framecrc; avplay -vo null on the bench stream
    (the JAX avplay's frame count) and its A/V path on phase 15's MP4
    (the PCM written equal to the port's own decode of the AAC track);
    GOP-parallel decode of two streams that the port encodes on the card
    (MPEG-2 1080p and H.264 640x352 with deblocking, GOP 2, packets equal
    to the JAX encoders'): serial and with two workers on the card,
    frame-identical to each other and the JAX decoders' golden, the same
    K1/K2 launches; entry() on the card against the CPU and
    dryrun_multichip(2) on two copies of the card."""
    import http.server
    import socket
    import threading
    import numpy as np
    import torch
    from libav_tpu_torch import entry, testdata
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.avutil.rational import Rational
    from libav_tpu_torch.codecs import api
    from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                            find_decoder)
    from libav_tpu_torch.formats import FormatContext
    from libav_tpu_torch.formats.rtp import sdp_create
    from libav_tpu_torch.ops import h264deblock as db
    from libav_tpu_torch.ops import idct
    from libav_tpu_torch.parallel.gop import GOPParallelDecoder, split_gops
    from libav_tpu_torch.testdata import containers as C
    from libav_tpu_torch.tools import avconv, avplay
    from libav_tpu_torch.tools import encode_probe as ep
    t_phase = time.perf_counter()
    gold = testdata.load_golden(testdata.devices_gop_golden_path())
    out = {"k1": {}, "k2": {}}

    def reset():
        db.h264_deblock_frame.launches = db.h264_deblock_wave.launches = 0
        idct.idct8x8_int.launches = 0

    def counts():
        return (db.h264_deblock_frame.launches, db.h264_deblock_wave.launches,
                idct.idct8x8_int.launches)

    def decode_host(codec, datas, **kw):
        dec = find_decoder(codec)(CodecParameters(
            codec_type=MediaType.VIDEO, codec_id=codec, **kw), device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        host = [f.to_host().planes for f in frames]
        return host, time.perf_counter() - t0

    def line(tag, n, seconds, k, unit="frames"):
        log(f"phase 20 {tag}: {n} {unit} in {seconds:.2f} s "
            f"({n / seconds:.3f} fps), K1 frame {k[0]} / wave {k[1]}, "
            f"K2 {k[2]} launches [{card}]")

    os.environ["no_proxy"] = ",".join(
        x for x in (os.environ.get("no_proxy"), "127.0.0.1", "localhost")
        if x)
    work = tempfile.mkdtemp()
    try:
        # (a) the bench stream over RTP into the rtp:// demuxer
        bench = testdata.read_packets(testdata.SMOKE_STREAM)
        bench_gold = testdata.load_golden()
        url = "rtp://127.0.0.1:0?codec=h264"
        t, state = rtp_receive(url, len(bench))
        t0 = time.perf_counter()
        sent = rtp_send(state["port"], "h264", bench, 1920, 1080)
        got = rtp_join(t, state, url, len(bench))
        rtp_s = time.perf_counter() - t0
        if [p.pts for p in got] != [3600 * k for k in range(len(bench))]:
            raise AssertionError(f"rtp: 90 kHz timestamps "
                                 f"{[p.pts for p in got]}")
        reset()
        host, dec_s = decode_host("h264", [p.data for p in got])
        k = counts()
        check_golden(host, bench_gold, "rtp bench decode")
        if k[:2] != (len(host), 0):
            raise AssertionError(f"rtp bench decode: K1 {k[:2]}")
        out["k1"]["rtp bench decode"] = k[0]
        log(f"phase 20 RTP: bench.h264 ({len(bench)} AUs, "
            f"{sum(map(len, bench))} bytes) in {sent} datagrams over UDP "
            f"loopback in {rtp_s:.2f} s, 90 kHz timestamps k * 3600; "
            f"decoded on the card to the golden")
        line("RTP bench decode", len(host), dec_s, k)

        # (b) an MPEG-2 RTP session announced by an SDP file
        m2v = testdata.read_packets(
            testdata.stream_paths("mpeg2_1080p_ipbb")[0])
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.bind(("127.0.0.1", 0))
        sdp_port = probe.getsockname()[1]
        probe.close()
        sdp = os.path.join(work, "s.sdp")
        with open(sdp, "w") as f:
            f.write(sdp_create("127.0.0.1", sdp_port, "mpeg2video"))
        t, state = rtp_receive(sdp, len(m2v))
        t0 = time.perf_counter()
        sent = rtp_send(sdp_port, "mpeg2video", m2v, 1920, 1080)
        got = rtp_join(t, state, sdp, len(m2v))
        if b"".join(bytes(p.data) for p in got) != b"".join(m2v):
            raise AssertionError("sdp: the elementary stream differs")
        log(f"phase 20 SDP: ipbb.m2v ({len(m2v)} pictures) as an RFC 2250 "
            f"session announced by s.sdp, {sent} datagrams in "
            f"{time.perf_counter() - t0:.2f} s: the elementary stream "
            f"byte-identical")

        # (c) HLS: ipbb.m2v in MPEG-TS segments, VOD on disk and a master
        # playlist over http
        ts = os.path.join(work, "all.ts")
        oc = FormatContext.open_output(ts, "mpegts")
        st = oc.new_stream(CodecParameters(
            codec_type=MediaType.VIDEO, codec_id="mpeg2video", width=1920,
            height=1080, pix_fmt="yuv420p"), time_base=Rational(1, 25))
        st.avg_frame_rate = Rational(25, 1)
        oc.write_header()
        for i, d in enumerate(m2v):
            oc.write_packet(Packet(data=d, pts=i, dts=i, duration=1,
                                   stream_index=0))
        oc.write_trailer()
        with open(ts, "rb") as f:
            data = f.read()
        nseg = 3
        per = (len(data) // 188 // nseg) * 188
        for j in range(nseg):
            with open(os.path.join(work, f"seg{j}.ts"), "wb") as f:
                f.write(data[j * per:(j + 1) * per if j < nseg - 1
                             else len(data)])
        with open(os.path.join(work, "media.m3u8"), "w") as f:
            f.write("#EXTM3U\n#EXT-X-VERSION:3\n#EXT-X-TARGETDURATION:1\n" +
                    "".join(f"#EXTINF:0.3,\nseg{j}.ts\n"
                            for j in range(nseg)) + "#EXT-X-ENDLIST\n")
        with open(os.path.join(work, "master.m3u8"), "w") as f:
            f.write("#EXTM3U\n#EXT-X-STREAM-INF:BANDWIDTH=20000000\n"
                    "media.m3u8\n#EXT-X-STREAM-INF:BANDWIDTH=1000\n"
                    "missing.m3u8\n")

        def hls_packets(u):
            ic = FormatContext.open_input(u)
            try:
                if ic.iformat.NAME != "hls":
                    raise AssertionError(f"{u}: opened as {ic.iformat.NAME}")
                return [bytes(p.data) for p in ic.packets()]
            finally:
                ic.close()
        t0 = time.perf_counter()
        vod = hls_packets(os.path.join(work, "media.m3u8"))
        vod_s = time.perf_counter() - t0

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=work, **kw)

            def log_message(self, *a):
                pass
        srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            t0 = time.perf_counter()
            master = hls_packets(f"http://127.0.0.1:{srv.server_port}/"
                                 f"master.m3u8")
            http_s = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
        if master != vod or len(vod) != len(m2v):
            raise AssertionError(f"hls: {len(vod)} packets on disk, "
                                 f"{len(master)} over http")
        reset()
        host, dec_s = decode_host("mpeg2video", vod)
        k = counts()
        check_golden(host, testdata.load_golden(
            testdata.stream_paths("mpeg2_1080p_ipbb")[1]), "hls decode")
        if k[2] != len(m2v):
            raise AssertionError(f"hls decode: {k[2]} K2 launches")
        out["k2"]["hls decode"] = k[2]
        log(f"phase 20 HLS: ipbb.m2v muxed to MPEG-TS ({len(data)} bytes) "
            f"in {nseg} segments: the VOD playlist on disk ({vod_s:.2f} s) "
            f"and the master playlist over a loopback http server "
            f"({http_s:.2f} s) give the same {len(vod)} packets")
        line("HLS decode", len(host), dec_s, k)

        # (d) the capture devices through avconv
        for name, want in gold["devices"].items():
            dst = os.path.join(work, name + ".crc")
            reset()
            _, err, seconds = run_cli(avconv, ["-benchmark", *want["args"],
                                               "-f", "framecrc", dst], dev)
            with open(dst) as f:
                text = f.read()
            if text != want["framecrc"]:
                raise AssertionError(f"avconv {' '.join(want['args'])}: "
                                     f"framecrc differs from the JAX CLI's")
            bf = bench_frames(err)
            log(f"phase 20 avconv -benchmark {' '.join(want['args'])} -f "
                f"framecrc: identical to the JAX CLI's, {bf['frames']} "
                f"frames, CLI {bf['fps']} fps ({seconds:.2f} s wall), "
                f"launches {counts()} [{card}]")

        # (e) avplay: null video on the bench stream, then the A/V path
        bench_h264 = testdata.write_cli_input("h264_1080p_ipbb_cabac", work)
        err = io.StringIO()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = avplay.play(bench_h264, vo="null", device=dev)
        play_s = time.perf_counter() - t0
        k = counts()
        shown = err.getvalue().strip().splitlines()[-1]
        if rc != 0 or shown != gold["avplay_null"]:
            raise AssertionError(f"avplay -vo null bench.h264: rc {rc}, "
                                 f"{shown!r}; the JAX avplay's "
                                 f"{gold['avplay_null']!r}")
        nshown = int(shown.split()[1])
        out["k1"]["avplay null"] = k[0]
        log(f"phase 20 avplay -vo null bench.h264: {shown!r} as the JAX "
            f"avplay")
        line("avplay -vo null", nshown, play_s, k, "frames shown")

        C.write_inputs(work)
        mux_out, mux_args = C.MUX[0]
        run_cli(avconv, C.in_dir(mux_args, work) + [os.path.join(
            work, mux_out)], dev)
        mp4 = os.path.join(work, mux_out)
        pcm_path = os.path.join(work, "av.pcm")
        reset()
        t0 = time.perf_counter()
        player = avplay.Player(mp4, vo="null", ao="file", ao_path=pcm_path,
                               device=dev)
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc = player.run()
        av_s = time.perf_counter() - t0
        k = counts()
        pcm = np.fromfile(pcm_path, "<i2")
        par, pkts = C.read_stream(FormatContext, mp4, MediaType.AUDIO)
        ref = C.decode_pcm(api, par, pkts, device=dev)[:2]
        ref = np.clip(ref.T.reshape(-1).astype(np.float32) * 32767.0,
                      -32768, 32767).astype(np.int16)
        if rc != 0 or pcm.size < 48000 or \
                not np.array_equal(pcm, ref[:pcm.size]):
            raise AssertionError(f"avplay A/V {mux_out}: rc {rc}, "
                                 f"{pcm.size} samples written, not the "
                                 f"port's decode of the AAC track")
        out["k1"]["avplay A/V"] = k[0]
        log(f"phase 20 avplay -vo null -ao file {mux_out}: "
            f"{err.getvalue().strip().splitlines()[-1]!r}, {pcm.size // 2} "
            f"stereo samples ({pcm.size / 96000:.2f} s of the "
            f"{ref.size / 96000:.2f} s track) written, equal to the port's "
            f"own decode of the AAC track; {av_s:.2f} s, K1 frame {k[0]} "
            f"launches [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (f) GOP-parallel decode at 1080p (MPEG-2) and 640x352 (H.264)
    for codec, (w, h, n, settings) in testdata.GOP_STREAMS.items():
        want = gold["gop"][codec]
        for t, src in enumerate(want["source"]):
            if testdata.plane_adler32(testdata.pattern(w, h, t)) != src:
                raise AssertionError(f"the pattern's {w}x{h} frame {t} "
                                     f"differs from the golden's source")
        frames = ep.pattern_frames(dev, w, h, n)
        reset()
        datas, enc_s = ep.encode(dev, frames, settings, codec=codec)
        k_enc = counts()
        check_packets(f"gop {codec} encode", datas, want["packets"])
        gops = split_gops([Packet(data=d) for d in datas], codec)
        reset()
        serial, serial_s = decode_host(codec, datas)
        k_serial = counts()
        check_golden(serial, want["decode"], f"gop {codec} serial decode")
        reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        par_frames = GOPParallelDecoder(codec, devices=[dev, dev]).decode(
            [Packet(data=d, pts=i) for i, d in enumerate(datas)])
        par_s = time.perf_counter() - t0
        k_par = counts()
        check_golden([f.planes for f in par_frames], want["decode"],
                     f"gop {codec} parallel decode")
        if k_par != k_serial or k_serial[1] != 0:
            raise AssertionError(f"gop {codec}: launches {k_par} with two "
                                 f"workers, {k_serial} serial")
        kind = 0 if codec == "h264" else 2
        if k_serial[kind] != len(serial):
            raise AssertionError(f"gop {codec}: {k_serial} launches for "
                                 f"{len(serial)} pictures")
        tag = "k1" if codec == "h264" else "k2"
        out[tag][f"gop {codec} encode"] = k_enc[kind]
        out[tag][f"gop {codec} serial"] = k_serial[kind]
        out[tag][f"gop {codec} two workers"] = k_par[kind]
        log(f"phase 20 GOP {codec} {w}x{h}: {n} pattern frames {settings} "
            f"encoded on the card in {enc_s:.2f} s ({n / enc_s:.3f} fps), "
            f"packets md5-identical to the JAX encoder's, {len(gops)} GOPs; "
            f"serial and two-worker decodes frame-identical to the JAX "
            f"decoder's golden")
        line(f"GOP {codec} encode", n, enc_s, k_enc)
        line(f"GOP {codec} serial decode", len(serial), serial_s, k_serial)
        line(f"GOP {codec} decode, two workers on {dev}", len(par_frames),
             par_s, k_par)

    # (g) entry and the dry run
    fn, args = entry.entry(dev)
    got = [p.cpu() for p in fn(*args)]
    cfn, cargs = entry.entry("cpu")
    if not all(torch.equal(a, b) for a, b in zip(got, cfn(*cargs))):
        raise AssertionError("entry: the card's recon differs from the CPU's")
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(2, dev)
    log(f"phase 20 entry(): the 8x6-MB recon on the card equal to the "
        f"CPU's; dryrun_multichip(2) on two copies of {dev}: {summary} in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20 took {out['seconds']:.1f} s")
    return out


def probe_record(name, source, line, what, probe, l2, library):
    """The kernels-line entry of P1 or P2 from phase 7's results."""
    times = probe["times"]
    return {
        "name": name,
        "route": "cuda",
        "source": f"libav_tpu_torch/csrc/{source}",
        "replaces": f"libav_tpu/tools/pallas_probe.py:{line}",
        "launches": probe["launches"],
        "max_abs_err": probe["max_abs_err"],
        "ms": times["probe"].ms,
        "plain_ms": times["plain"].ms,
        "device_ms": times["probe"].device_ms,
        "cold_device_ms": l2["cold_device_ms"],
        "bound_ms": l2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library": library,
        "production_ms": times["production"].ms,
        "production_device_ms": times["production"].device_ms,
        "ms_is": f"{what} in kernel_probe: median per call by CUDA events; "
                 f"device_ms by torch.profiler (cold_device_ms with the L2 "
                 f"flushed between launches); production_* is "
                 f"{times['production'].label} on the same inputs",
    }


def p2_record(probe, k1_big):
    """P2's kernels-line entry: phase 7's times at 49,152 and 2^20 lines,
    K1's line kernel beside them (phase 2 at 2^20)."""
    rec = probe_record("h264_edge_filter_pm", "h264_deblock.cu", 114,
                       "49,152 lines as (8, B), qp 30", probe["deblock"],
                       probe["l2"]["P2"], NO_LIBRARY["deblock"])
    big, k1 = probe["l2"]["P2 2^20"], probe["l2"]["K1 lines"]
    rec["lines_2_20"] = {"device_ms": big["device_ms"],
                         "cold_device_ms": big["cold_device_ms"],
                         "bound_ms": big["bound_ms"],
                         "k1_lines_device_ms": k1_big["device_ms"],
                         "k1_lines_cold_device_ms": k1_big["cold_device_ms"]}
    rec["k1_lines_49152"] = {"device_ms": k1["device_ms"],
                             "cold_device_ms": k1["cold_device_ms"]}
    rec["ms_is"] += (f"; lines_2_20: phase 2's 2^20 lines transposed, "
                     f"device ms warm and cold (bound {big['bytes']} "
                     f"bytes), K1's line kernel on the same lines (phase "
                     f"2); k1_lines_49152: K1's line kernel on phase 7's "
                     f"49,152 lines")
    return rec


def deblock_record(name, kernel, launches, max_err, d):
    """The kernels-line entry of K1's frame or wave kernel from phase 3's
    part=True case."""
    k = d[kernel]
    launched = "one launch" if kernel == "frame" else "254 wave launches"
    return {
        "name": name,
        "route": "cuda",
        "source": "libav_tpu_torch/csrc/h264_deblock.cu",
        "replaces": "libav_tpu/ops/h264deblock.py:150",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k["ms"],
        "plain_ms": d["plain_ms"],
        "device_ms": k["device_ms"],
        "cold_device_ms": k["cold_device_ms"],
        "bound_ms": d["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library": NO_LIBRARY["deblock"],
        "frame_deblock_ms": k["whole"],
        "grids_ms": d["grids_ms"],
        "ms_is": f"one 1920x1088 frame's edges ({launched}) on built "
                 f"grids, per call by CUDA events; frame_deblock_ms adds the "
                 f"grid "
                 f"build (grids_ms alone); device_ms by torch.profiler; "
                 f"plain_ms is deblock_frame_plain; bound: {d['bytes']} "
                 f"bytes of padded planes in and out and grids in",
    }


def main():
    sys.meta_path.insert(0, RefuseJax())
    loaded = [m for m in sys.modules if m.split(".")[0] in RefuseJax.REFUSED]
    if loaded:
        raise AssertionError(f"imported before the guard: {loaded}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from libav_tpu_torch import _kernels
    from libav_tpu_torch.avutil import hwdevice
    from libav_tpu_torch.codecs.h264 import dec as h264dec
    from libav_tpu_torch.tools import kernel_probe

    # phase 0
    t_run = time.perf_counter()
    dev = hwdevice.device("cuda")
    info = hwdevice.describe(dev)
    card = info.pop("nvidia_smi")
    log(card)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s), native CABAC host layer "
        f"{h264dec.native_cabac_available()}")

    # phase 1
    t0 = time.perf_counter()
    path, compile_s, report = _kernels.build()
    _kernels.library()
    log(f"phase 1 build: {path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {compile_s:.2f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    lines = phase_lines(dev)
    deblock = phase_deblock(dev)
    launches, h264_fps, intra = phase_decode(dev, card)
    k2 = phase_idct(dev)
    k2_launches, mpeg2_fps = phase_mpeg2(dev, card)
    phase_interlace(dev)
    probe = phase_probe(dev, card, lines)
    mjpeg_launches, mjpeg_fps = phase_mjpeg(dev, card)
    cli_fps = phase_cli(dev, card, {"h264_1080p_ipbb_cabac": h264_fps,
                                    **mpeg2_fps, "mjpeg_1080p": mjpeg_fps})
    mpeg4 = phase_mpeg4(dev, card)
    phase_transcode(dev, card, mpeg4)
    y2r = phase_config5_kernel(dev, card)
    config5 = phase_config5(dev, card)
    m4dec = phase_mpeg4_decode(dev, card, mpeg4)
    ext = phase_h264_ext(dev, card)
    cont = phase_containers(dev, card)
    filters = phase_filters(dev, card, cli_fps, config5)
    mpeg12 = phase_mpeg12(dev, card)
    encode18 = phase_h264_encode(dev, card)
    phase_prores_ffv1(dev, card)
    last = phase_protocols_parallel(dev, card)
    runs = filters["runs"]
    k2_paths = {"mpeg2 decodes": k2_launches, "mjpeg decode": mjpeg_launches,
                "mpeg4 encode": mpeg4["launches"],
                "mpeg4 decode": m4dec["launches"],
                "mkv to mp4 transcode": cont["transcode"]["k2"],
                "filter run A_yadif": runs["A_yadif"]["K2"],
                "filter run D_overlay": runs["D_overlay"]["K2"],
                **mpeg12["k2"], **last["k2"]}

    max_err = max(lines["max_abs_err"], deblock["max_abs_err"])
    k1_49k, p2_49k = probe["l2"]["K1 lines"], probe["l2"]["P2"]
    k2_encode = f"{mpeg4['k2_device_ms']} ms"
    d = deblock["part=True"]
    frame_entry = deblock_record(
        "h264_deblock_frame", "frame", launches[0],
        max(max_err, ext["field"]["max_abs_err"],
            encode18["k1_closed_loop"]["max_abs_err"]), d)
    frame_entry["launches_by_path"] = {
        "bench decode": launches[0], **ext["launches"],
        "mp4 decode": cont["mp4_decode"]["k1"],
        "mkv to mp4 transcode": cont["transcode"]["k1"],
        **{f"filter run {run}": runs[run]["K1"]
           for run in ("B_pixel", "C_rgb", "D_overlay", "E_interlace",
                       "E_fps")},
        **encode18["k1"], **last["k1"]}
    frame_entry["field_picture"] = ext["field"]
    frame_entry["encoder_closed_loop"] = encode18["k1_closed_loop"]
    record = {"kernels": [
        frame_entry,
        deblock_record("h264_deblock_wave", "wave", launches[1], max_err, d),
        {
            "name": "h264_edge_filter_lines",
            "route": "cuda",
            "source": "libav_tpu_torch/csrc/h264_deblock.cu",
            "replaces": "libav_tpu/ops/h264deblock.py:150",
            "launches": launches[2],
            "max_abs_err": lines["max_abs_err"],
            "ms": lines["ms"],
            "plain_ms": lines["plain_ms"],
            "device_ms": lines["device_ms"],
            "cold_device_ms": lines["cold_device_ms"],
            "bound_ms": lines["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "library": NO_LIBRARY["deblock"],
            "ms_is": f"2^20 (B, 8) luma lines, per-line qp and bS, per call "
                     f"back to back by CUDA events; device_ms by "
                     f"torch.profiler (cold_device_ms with the L2 flushed "
                     f"between launches); bound: {lines['bytes']} bytes of "
                     f"lines in and out, qp and bS in; launches: the bench "
                     f"decode (its deblock is h264_deblock_frame); at "
                     f"{kernel_probe.DEBLOCK_BATCH} lines (phase 7): device "
                     f"{k1_49k['device_ms']} ms warm, "
                     f"{k1_49k['cold_device_ms']} ms cold, bound "
                     f"{k1_49k['bound_ms']} ms; P2 on the same lines "
                     f"transposed {p2_49k['device_ms']} ms warm, "
                     f"{p2_49k['cold_device_ms']} ms cold",
        },
        {
            "name": "mpv_idct8x8",
            "route": "cuda",
            "source": "libav_tpu_torch/csrc/mpv_idct.cu",
            "replaces": "libav_tpu/ops/idct.py:167",
            "launches": k2_launches,
            "launches_by_path": k2_paths,
            "max_abs_err": k2["max_abs_err"],
            "ms": k2[48960][0],
            "plain_ms": k2[48960][1],
            "device_ms": k2[48960][2],
            "cold_device_ms": k2[48960][3],
            "bound_ms": k2[48960][4],
            "bound_by": "bytes",
            "library_ms": None,
            "library": NO_LIBRARY["idct"],
            "ms_is": "48,960 blocks (a 1080-line frame picture), per call "
                     "back to back; device_ms is the kernel alone, by the "
                     "profiler (cold_device_ms with the L2 flushed between "
                     "launches); launches: the two MPEG-2 streams' decodes; "
                     "launches_by_path: each path's first run (those "
                     "decodes, the MJPEG decode, the MPEG-4 encode's "
                     "anchors, the MPEG-4 decode of its 7 VOPs, phase "
                     "15's transcode anchors, phase 16's filter runs A "
                     "and D, phase 17's MPEG-1/2 encodes' anchors and "
                     "field pictures, its CLI encodes and its legacy "
                     "decodes, one per picture; phase 20's HLS decode "
                     "and GOP-parallel MPEG-2 encode and decodes, "
                     "serial and with two workers); in the "
                     "MPEG-4 encode "
                     f"{k2_encode} on the device per launch; "
                     f"at 24,480 (a field): {k2[24480][0]} ms, device "
                     f"{k2[24480][2]} ms, plain {k2[24480][1]} ms; at "
                     f"38,016 (16CIF): {k2[38016][0]} ms, plain "
                     f"{k2[38016][1]} ms; at 21,600 (720p): "
                     f"{k2[21600][0]} ms, plain {k2[21600][1]} ms",
        },
        {
            "name": "h264_intra_frame",
            "route": "cuda",
            "source": "libav_tpu_torch/csrc/h264_intra.cu",
            "replaces": None,
            "replaces_is": "no TPU kernel: the port's host-launched "
                           "wavefront ReconH264._wavefront, its plain twin",
            "launches": intra["launches"],
            "max_abs_err": 0,
            "ms": intra["ms"],
            "plain_ms": intra["plain_ms"],
            "device_ms": intra["device_ms"],
            "cold_device_ms": intra["cold_device_ms"],
            "bound_ms": intra["bound_ms"],
            "bound_by": "bytes (the time is the dependency chain's)",
            "library_ms": None,
            "library": "none: I_4x4/I_8x8 chains and availability rules "
                       "per macroblock",
            "ms_is": f"the bench stream's I picture ({intra['mb_w']}x"
                     f"{intra['mb_h']} MBs), per call by CUDA events; "
                     f"device_ms by torch.profiler (cold_device_ms with "
                     f"the L2 flushed between launches); plain_ms is "
                     f"ReconH264._wavefront, synchronised; bound: "
                     f"{intra['bytes']} bytes of inputs read as int32 and "
                     f"bordered planes written; launches: per bench decode",
        },
        probe_record("mpv_idct8x8_cm", "mpv_idct.cu", 30,
                     "48,896 blocks as (64, B)", probe["idct"],
                     probe["l2"]["P1"], NO_LIBRARY["idct"]),
        p2_record(probe, lines),
        {
            "name": "sws_yuv2rgb",
            "route": "cuda",
            "source": "libav_tpu_torch/csrc/sws_yuv2rgb.cu",
            "replaces": "libav_tpu/swscale/__init__.py:236",
            "replaces_is": "an XLA-fused jit (_yuv_rgb_jit), not a Pallas "
                           "kernel",
            "launches": config5["launches"],
            "launches_by_path": {"config-5 CLI runs": config5["launches"],
                                 "filter run C_rgb":
                                     runs["C_rgb"]["sws_yuv2rgb"]},
            "max_abs_err": y2r["max_abs_err"],
            "ms": y2r["limited"]["ms"],
            "plain_ms": y2r["limited"]["plain_ms"],
            "device_ms": y2r["limited"]["device_ms"],
            "cold_device_ms": y2r["limited"]["cold_device_ms"],
            "bound_ms": y2r["limited"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "library": NO_LIBRARY["yuv2rgb"],
            "ms_is": f"one 1920x1080 yuv420p frame of the bench stream to "
                     f"rgb24 (limited range), per call by CUDA events; "
                     f"device_ms by torch.profiler (cold_device_ms with the "
                     f"L2 flushed between launches); bound: "
                     f"{y2r['limited']['bytes']} bytes of planes in and "
                     f"rgb24 out; launches: the config-5 CLI runs; full "
                     f"range (MJPEG frame): {y2r['full']['ms']} ms, device "
                     f"{y2r['full']['device_ms']} ms warm, "
                     f"{y2r['full']['cold_device_ms']} ms cold",
        }],
        "card": card}
    log(f"chip_smoke: phases 0-20 took {time.perf_counter() - t_run:.1f} s")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
