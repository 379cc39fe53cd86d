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
     not use, on random 1080p inputs on the card and on the CPU, exact.
The last two lines are the kernels' JSON record and the result JSON.
"""

import json
import sys
import time

# one x+2y deblock wave per launch: 120 + 2 * (68 - 1) at 1080p
WAVES_1080P = 254


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
    return launches


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
    for name, pictures in testdata.MPEG2_SMOKE.items():
        path, golden = testdata.mpeg2_paths(name)
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
        log(f"phase 6 {name} warm decode: {nframes / warm_s:.3f} fps "
            f"({1e3 * warm_s / nframes:.1f} ms/frame), host slice entropy "
            f"{1e3 * entropy_s / nframes:.1f} ms/frame, other "
            f"{1e3 * (warm_s - entropy_s) / nframes:.1f} ms/frame [{card}]")
        ops, busy_ms, wall_ms = device_busy(lambda: decode_mpeg2(dev, datas))
        log(f"phase 6 {name} profiled decode: {ops} device ops, "
            f"{busy_ms:.3f} ms on the device in {wall_ms:.1f} ms of wall "
            f"(device busy {100 * busy_ms / wall_ms:.2f}%)")
    return launches


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
    launches = phase_decode(dev, card)
    k2 = phase_idct(dev)
    k2_launches = phase_mpeg2(dev, card)
    phase_interlace(dev)

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
    }], "card": card}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
