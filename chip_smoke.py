#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libav_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:
  0. setup: needs torch.cuda.is_available(); prints the card's nvidia-smi
     name and power limit, torch/CUDA versions and whether the native
     CABAC host layer is built;
  1. build: compiles libav_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  2. K1 lines: h264_edge_filter_lines against the plain filter_edge_qp on
     the card over 6 x 2^20 random lines (bS 0-4, qp 0-51, luma and
     chroma, three offset pairs), exact;
  3. frame deblock: deblock_frame_exact on random 1920x1088 planes through
     the h264_deblock_wave kernel and through the plain wave step, with
     part=False and part=True inputs and the 8x8-transform edge rule,
     exact;
  4. main path: decodes the committed 1080p bench stream (CABAC, I_8x8,
     IPBB, 4 slices, deblock) with the port's H264Decoder on the card
     (send_packet / receive_frame / drain), holds every frame's adler32
     and md5 against the golden that the JAX package produced, checks
     that the deblock wave kernel ran 8 x 254 times, then times a warm
     second decode;
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
     and at B = 1 and 127 (P1) or 1 and 513 (P2);
  8. MJPEG: decodes the committed 1080p stream (4 JPEGs) with the port's
     MJPEGDecoder on the card, one frame at a time and as one batch
     (decode_jpeg_batch); every frame's adler32 and md5 equal the golden,
     with K2 launched 3 times per frame, and 3 times for the batch;
  9. the CLI: writes the four committed streams as bench.h264, ipbb.m2v,
     fld.m2v and frames.mjpeg and runs the port's avconv on each with
     `-benchmark -f framecrc`: each output byte-identical to the JAX CLI's
     committed framecrc, with K1's wave kernel launched 8 x 254 times for
     the H.264 input and K2 once per coded MPEG-2 picture and 3 times per
     JPEG; prints the CLI's fps beside the direct decode's; then `-prof
     DIR` on bench.h264 and ipbb.m2v (each torch.profiler trace names its
     kernel, the H.264 timer report holds h264.entropy) and avprobe
     `-show_frames` on ipbb.m2v (its frame section equals the JAX
     avprobe's: 7 frames, I B B P B B P).
The last two lines are the kernels' JSON record and the result JSON.
"""

import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

# one x+2y deblock wave per launch: 120 + 2 * (68 - 1) at 1080p
WAVES_1080P = 254
# stream -> the kernel its `avconv -prof` trace must name
PROF_KERNELS = {"h264_1080p_ipbb_cabac": "deblock_wave_kernel",
                "mpeg2_1080p_ipbb": "idct8x8_kernel"}


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


def kernel_device_ms(fn, kernel, reps=20):
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains `kernel`, over reps calls of fn(), by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.key_averages()
          if kernel in e.key]
    if not us:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    return sum(us) / reps / 1e3


def device_busy(fn):
    """Run fn() once under torch.profiler: -> (device ops, device ms,
    wall ms), the device ms summed over every kernel and copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.count for e in ops),
            sum(e.self_device_time_total for e in ops) / 1e3, 1e3 * wall)


def phase_lines(dev):
    import numpy as np
    import torch
    from libav_tpu_torch.ops import h264deblock as db
    rng = np.random.default_rng(2)
    n = 1 << 20
    lines = rng.integers(0, 256, (n, 8)).astype(np.int32)
    lines[::2] = np.clip(lines[::2, :1] +
                         rng.integers(-6, 7, (n // 2, 8)), 0, 255)
    lines = torch.as_tensor(lines).to(dev)
    qp = torch.as_tensor(rng.integers(0, 52, n).astype(np.int32)).to(dev)
    bs = torch.as_tensor(rng.integers(0, 5, n).astype(np.int32)).to(dev)
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
    ms = cuda_ms(lambda: db.h264_edge_filter_lines(lines, qp, bs))
    plain_ms = cuda_ms(lambda: db.filter_edge_qp(lines, qp, bs))
    log(f"phase 2 K1 lines: 6 x {n} lines exact, {changed} lines filtered; "
        f"luma 2^20 lines kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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

        def kernel():
            return fn(*args, t8=t8)

        def plain():
            return fn(*args, t8=t8, step=db.deblock_wave_plain)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"deblock wave kernel differs from the "
                                     f"plain step ({name})")
            out["max_abs_err"] = max(out["max_abs_err"],
                                     int((g - w).abs().max()))
        if torch.equal(got[0], planes[0]):
            raise AssertionError("the deblock changed no luma sample")
        out[name] = (cuda_ms(kernel), cuda_ms(plain, reps=1))
        log(f"phase 3 deblock 1920x1088 {name}: exact; frame deblock "
            f"through the wave kernel {out[name][0]:.3f} ms, through the "
            f"plain step {out[name][1]:.3f} ms")
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

    db.h264_deblock_wave.launches = 0
    host, cold_s, recon_ms = decode(dev, datas, time_recon=True)
    launches = db.h264_deblock_wave.launches
    check_golden(host, gold, "first decode")
    if launches != nframes * WAVES_1080P:
        raise AssertionError(f"h264_deblock_wave launched {launches} times, "
                             f"expected {nframes} x {WAVES_1080P}")
    names = {1: "I", 2: "P", 3: "B"}
    per = ", ".join(f"{names.get(pt, pt)} {ms:.1f}" for pt, ms in recon_ms)
    log(f"phase 4 first decode: {nframes} frames adler32+md5 identical to "
        f"the golden, {launches} deblock wave launches, {cold_s:.2f} s; "
        f"per-frame recon ms (synchronised): {per}")

    n0, s0 = h264dec.host_entropy_stats()
    host, warm_s, _ = decode(dev, datas)
    n1, s1 = h264dec.host_entropy_stats()
    check_golden(host, gold, "second decode")
    fps = nframes / warm_s
    entropy_ms = 1e3 * (s1 - s0) / max(1, n1 - n0)
    log(f"phase 4 warm decode: {fps:.3f} fps ({1e3 * warm_s / nframes:.1f} "
        f"ms/frame), host entropy {entropy_ms:.1f} ms/frame over "
        f"{n1 - n0} access units, native CABAC "
        f"{h264dec.native_cabac_available()} [{card}]")
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
                                   "idct8x8_kernel"))
        log(f"phase 5 K2: {n} blocks exact; kernel {out[n][0]:.4f} ms per "
            f"call back to back ({out[n][2]:.4f} ms of it on the device, "
            f"by the profiler), plain {out[n][1]:.4f} ms")
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
        fps[name] = nframes / warm_s
        log(f"phase 6 {name} warm decode: {nframes / warm_s:.3f} fps "
            f"({1e3 * warm_s / nframes:.1f} ms/frame), host slice entropy "
            f"{1e3 * entropy_s / nframes:.1f} ms/frame, other "
            f"{1e3 * (warm_s - entropy_s) / nframes:.1f} ms/frame [{card}]")
        ops, busy_ms, wall_ms = device_busy(lambda: decode_mpeg2(dev, datas))
        log(f"phase 6 {name} profiled decode: {ops} device ops, "
            f"{busy_ms:.3f} ms on the device in {wall_ms:.1f} ms of wall "
            f"(device busy {100 * busy_ms / wall_ms:.2f}%)")
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


def phase_probe(dev, card):
    """P1 and P2 through their tool, then against their plain versions."""
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
            log(f"phase 7 kernel_probe {name}: {t.label} {t.ms:.4f} ms/call "
                f"(median of 50, CUDA events), {t.device_ms:.4f} ms on the "
                f"device (torch.profiler), bit-exact [{card}]")

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
            db.h264_deblock_wave.launches = 0
            idct.idct8x8_int.launches = 0
            _, err, seconds = run_cli(avconv, [*opts, "-i", inputs[name],
                                               "-f", "framecrc", out], dev)
            with open(out, "rb") as f, \
                    open(testdata.framecrc_path(name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"avconv {name}: framecrc differs "
                                         f"from the JAX CLI's")
            waves = db.h264_deblock_wave.launches
            k2 = idct.idct8x8_int.launches
            nframes = len(testdata.load_golden(
                testdata.stream_paths(name)[1])["frames"])
            want_waves = (nframes * WAVES_1080P
                          if name == "h264_1080p_ipbb_cabac" else 0)
            want_k2 = k2_expected.get(name, 3 * nframes)
            if (waves, k2) != (want_waves, want_k2):
                raise AssertionError(
                    f"avconv {name}: {waves} wave and {k2} K2 launches, "
                    f"expected {want_waves} and {want_k2}")
            return err, seconds, waves, k2

        for name in testdata.CLI_INPUTS:
            err, seconds, waves, k2 = framecrc(name, "-benchmark")
            fps = float(re.search(r"fps=([0-9.]+)", err).group(1))
            log(f"phase 9 avconv -benchmark {os.path.basename(inputs[name])}"
                f" -f framecrc: byte-identical to the JAX CLI's framecrc, "
                f"{waves} K1 wave and {k2} K2 launches; CLI {fps} fps "
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


def probe_record(name, source, line, what, probe):
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
        "production_ms": times["production"].ms,
        "production_device_ms": times["production"].device_ms,
        "ms_is": f"{what} in kernel_probe: median per call by CUDA events; "
                 f"device_ms by torch.profiler; production_* is "
                 f"{times['production'].label} on the same inputs",
    }


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from libav_tpu_torch import _kernels
    from libav_tpu_torch.avutil import hwdevice
    from libav_tpu_torch.codecs.h264 import dec as h264dec

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
    probe = phase_probe(dev, card)
    _, mjpeg_fps = phase_mjpeg(dev, card)
    phase_cli(dev, card, {"h264_1080p_ipbb_cabac": h264_fps, **mpeg2_fps,
                          "mjpeg_1080p": mjpeg_fps})

    ms, plain_ms = deblock["part=True"]
    record = {"kernels": [{
        "name": "h264_deblock_wave",
        "route": "cuda",
        "source": "libav_tpu_torch/csrc/h264_deblock.cu",
        "replaces": "libav_tpu/ops/h264deblock.py:150",
        "launches": launches,
        "max_abs_err": max(lines["max_abs_err"], deblock["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_is": "one 1920x1088 frame deblock (254 waves), bS build "
                 "included",
    }, {
        "name": "mpv_idct8x8",
        "route": "cuda",
        "source": "libav_tpu_torch/csrc/mpv_idct.cu",
        "replaces": "libav_tpu/ops/idct.py:167",
        "launches": k2_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2[48960][0],
        "plain_ms": k2[48960][1],
        "device_ms": k2[48960][2],
        "ms_is": "48,960 blocks (a 1080-line frame picture), per call back "
                 "to back; device_ms is the kernel alone, by the profiler; "
                 f"at 24,480 (a field): {k2[24480][0]} ms, device "
                 f"{k2[24480][2]} ms, plain {k2[24480][1]} ms",
    }, probe_record("mpv_idct8x8_cm", "mpv_idct.cu", 30,
                    "48,896 blocks as (64, B)", probe["idct"]),
       probe_record("h264_edge_filter_pm", "h264_deblock.cu", 114,
                    "49,152 lines as (8, B), qp 30", probe["deblock"])],
        "card": card}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
