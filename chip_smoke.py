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
     and the line kernel never, then times a warm second decode; then decodes it six more
     times, the deblock in turns through the wave kernel and the frame
     kernel (wave, frame, frame, wave, wave, frame), each
     golden-identical, with the I and P/B frames' recon ms beside each
     other;
  5. K2: idct8x8_int against the plain idct8x8_int_plain on the card over
     48,960 blocks (DC-only rows, all-zero blocks, values outside int16,
     rows whose sums overflow int32), exact; kernel and plain times at
     48,960 blocks (a 1080-line frame picture) and 24,480 (a field), by
     CUDA events, and the kernel's device time by torch.profiler;
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
     reconstruction, K2 launched once per coded VOP; a warm decode (fps)
     and one with each VOP's recon program synchronised (the upload of
     its MB arrays and the Recon module, ms by VOP type; host share);
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
     per weighted picture (synchronised), a warm decode's fps; K1 on the
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
     torch.profiler).
Profiled windows (the kernels' device times, phases 6 and 10's busy
shares, kernel_probe in phase 7) count the launches of the hand kernel
they hold against its wrapper's count: torch.profiler on the card loses
device events, so the times are per held launch, a busy share from a
window that lost some is logged as a low reading, and a window that holds
none is taken again and then fails the run.
The last two lines are the kernels' JSON record and the result JSON.
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
def deblock_path(path):
    """Decodes inside run the frame deblock through the frame kernel
    ("frame", the decoder's path) or the 254-wave loop ("wave"): the
    H.264 decoder's programs are wrapped so their deblock passes
    run=deblock_frame_waves. Measurement only."""
    from libav_tpu_torch.codecs.h264 import device as tdev
    from libav_tpu_torch.ops import h264deblock as db
    if path == "frame":
        yield
        return
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
    datas = testdata.read_packets(testdata.SMOKE_STREAM)
    gold = testdata.load_golden()
    nframes = len(gold["frames"])

    db.h264_deblock_frame.launches = db.h264_deblock_wave.launches = 0
    db.h264_edge_filter_lines.launches = 0
    host, cold_s, recon_ms = decode(dev, datas, time_recon=True)
    launches = (db.h264_deblock_frame.launches,
                db.h264_deblock_wave.launches,
                db.h264_edge_filter_lines.launches)
    check_golden(host, gold, "first decode")
    if launches != (nframes, 0, 0):
        raise AssertionError(f"h264_deblock_frame, h264_deblock_wave and "
                             f"h264_edge_filter_lines launched {launches} "
                             f"times, expected ({nframes}, 0, 0)")
    names = {1: "I", 2: "P", 3: "B"}
    per = ", ".join(f"{names.get(pt, pt)} {ms:.1f}" for pt, ms in recon_ms)
    log(f"phase 4 first decode: {nframes} frames adler32+md5 identical to "
        f"the golden, {launches[0]} frame deblock launches and "
        f"{launches[1]} wave launches, {cold_s:.2f} s; per-frame recon ms "
        f"(synchronised): {per}")

    n0, s0 = h264dec.host_entropy_stats()
    host, warm_s, _ = decode(dev, datas)
    n1, s1 = h264dec.host_entropy_stats()
    check_golden(host, gold, "second decode")
    DECODED["h264_1080p_ipbb_cabac"] = host[:2]
    fps = nframes / warm_s
    entropy_ms = 1e3 * (s1 - s0) / max(1, n1 - n0)
    log(f"phase 4 warm decode: {fps:.3f} fps ({1e3 * warm_s / nframes:.1f} "
        f"ms/frame), host entropy {entropy_ms:.1f} ms/frame over "
        f"{n1 - n0} access units, native CABAC "
        f"{h264dec.native_cabac_available()} [{card}]")

    # the same decode with the deblock through the wave kernel, in turns:
    # per-frame recon synchronised, the I frame apart
    recon = {"wave": [], "frame": []}
    for path in ("wave", "frame", "frame", "wave", "wave", "frame"):
        with deblock_path(path):
            host, seconds, per = decode(dev, datas, time_recon=True)
        check_golden(host, gold, f"decode through the {path} kernel")
        pb = [ms for pt, ms in per if pt != 1]
        i_ms = sum(ms for pt, ms in per if pt == 1)
        recon[path].append((sum(pb) / len(pb), i_ms, seconds))
        log(f"phase 4 decode, deblock through the {path} kernel: golden; "
            f"{seconds:.3f} s, I recon {i_ms:.1f} ms, P/B recon ms "
            f"(synchronised): {', '.join(f'{ms:.1f}' for ms in pb)}")
    for path, runs in recon.items():
        log(f"phase 4 {path} kernel: mean P/B recon "
            f"{', '.join(f'{r[0]:.2f}' for r in runs)} ms, I recon "
            f"{', '.join(f'{r[1]:.1f}' for r in runs)} ms, decode "
            f"{', '.join(f'{r[2]:.3f}' for r in runs)} s")
    return launches, fps


def phase_idct(dev):
    import torch
    from libav_tpu_torch import testdata
    from libav_tpu_torch.ops import idct
    out = {"max_abs_err": 0}
    for n in (48960, 24480):
        x = torch.as_tensor(testdata.idct_blocks(5, n)).to(dev)
        got = idct.idct8x8_int(x)
        want = idct.idct8x8_int_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"idct8x8_int differs from "
                                 f"idct8x8_int_plain on {n} blocks")
        out["max_abs_err"] = max(out["max_abs_err"],
                                 int((got - want).abs().max()))
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
    host, warm_s, launches, _ = decode_mpeg4(dev, pkts)
    check(host, gold["phase10_decode"], "mpeg4 warm decode", launches)
    _, timed_s, _, spans = decode_mpeg4(dev, pkts, True)
    fps = nvops / warm_s
    pct = {k: sum(ms) / (10 * timed_s) for k, ms in spans.items()}
    log(f"phase 13 warm decode: {fps:.3f} fps ({1e3 * warm_s / nvops:.1f} "
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
        host, warm_s, _ = decode(dev, datas)
        check_golden(host, gold, f"{name} second decode")
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
            f"recon ms per picture (synchronised) {per}{blend}; warm "
            f"{nframes / warm_s:.3f} fps [{card}]")

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
    launches, h264_fps = phase_decode(dev, card)
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
    runs = filters["runs"]
    k2_paths = {"mpeg2 decodes": k2_launches, "mjpeg decode": mjpeg_launches,
                "mpeg4 encode": mpeg4["launches"],
                "mpeg4 decode": m4dec["launches"],
                "mkv to mp4 transcode": cont["transcode"]["k2"],
                "filter run A_yadif": runs["A_yadif"]["K2"],
                "filter run D_overlay": runs["D_overlay"]["K2"]}

    max_err = max(lines["max_abs_err"], deblock["max_abs_err"])
    k1_49k, p2_49k = probe["l2"]["K1 lines"], probe["l2"]["P2"]
    k2_encode = f"{mpeg4['k2_device_ms']} ms"
    d = deblock["part=True"]
    frame_entry = deblock_record("h264_deblock_frame", "frame", launches[0],
                                 max(max_err, ext["field"]["max_abs_err"]),
                                 d)
    frame_entry["launches_by_path"] = {
        "bench decode": launches[0], **ext["launches"],
        "mp4 decode": cont["mp4_decode"]["k1"],
        "mkv to mp4 transcode": cont["transcode"]["k1"],
        **{f"filter run {run}": runs[run]["K1"]
           for run in ("B_pixel", "C_rgb", "D_overlay", "E_interlace",
                       "E_fps")}}
    frame_entry["field_picture"] = ext["field"]
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
                     "and D); in the "
                     "MPEG-4 encode "
                     f"{k2_encode} on the device per launch; "
                     f"at 24,480 (a field): {k2[24480][0]} ms, device "
                     f"{k2[24480][2]} ms, plain {k2[24480][1]} ms",
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
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
