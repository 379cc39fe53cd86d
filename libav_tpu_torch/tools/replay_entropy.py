"""Capture-and-replay microbenchmark for the native CABAC slice decoder
(counterpart of `libav_tpu/tools/replay_entropy.py`).

Captures every decode_slice(...) call made while the port's H264Decoder
decodes a stream, then replays just the native calls in a tight loop —
isolating the C entropy time from recon/device/Python glue.

Usage: python -m libav_tpu_torch.tools.replay_entropy [reps] [stream]
       python -m libav_tpu_torch.tools.replay_entropy 1 [stream] \\
           --dump DIR        (calls.bin for tools/cabac_prof.c)

The decoder runs on the card; `main(argv, device="cpu")` runs it on the
CPU. The stream is profile_entropy's: the committed bench stream unless
a path is given. Also verifies output equivalence run-to-run (arena
checksum).
"""

from __future__ import annotations

import os
import struct
import sys
import time
import zlib
from typing import Optional

import numpy as np

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.tools.profile_entropy import (bench_stream_path,
                                                   load_packets)


def capture(path: Optional[str] = None, device="cuda"):
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.codecs.h264 import H264Decoder
    from libav_tpu_torch.native import h264_cabac_host as CN

    calls = []
    orig = CN.decode_slice

    def spy(arena, coeffs, data, *a, **kw):
        calls.append((arena.shape, coeffs.shape, bytes(data), a,
                      {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                       for k, v in kw.items()}))
        return orig(arena, coeffs, data, *a, **kw)

    dec = H264Decoder(CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="h264"),
                      device=hwdevice.device(device)).open()
    datas = load_packets(bench_stream_path(path))
    CN.decode_slice = spy
    try:
        for i, d in enumerate(datas):
            dec.send_packet(Packet(data=d, pts=i))
            dec._pump()
    finally:
        CN.decode_slice = orig
    return calls


def dump(calls, outdir):
    """Write the captured calls as flat binary files for the standalone
    C gprof harness (tools/cabac_prof.c)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "calls.bin"), "wb") as f:
        f.write(struct.pack("<i", len(calls)))
        for ash, csh, data, a, kw in calls:
            col = kw.get("col")
            ycap = kw.get("ycap", 0)
            has_sctx = 1 if kw.get("sctx") is not None else 0
            params = list(a[:10]) + [0 if col is None else 1, ycap,
                                     kw.get("t8mode", 0),
                                     kw.get("d8x8inf", 1)]
            params[9] = 1 if params[9] else 0
            f.write(struct.pack("<14i", *[int(x) for x in params]))
            f.write(struct.pack("<iq", has_sctx, len(data)))
            f.write(data)
            if col is not None:
                cc = np.ascontiguousarray(col, dtype=np.int32)
                f.write(struct.pack("<q", cc.size))
                f.write(cc.tobytes())
            else:
                f.write(struct.pack("<q", 0))
    print(f"dumped {len(calls)} calls to {outdir}/calls.bin")


def main(argv: Optional[list] = None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 20
    path = argv[1] if len(argv) > 1 and argv[1] != "--dump" else None
    calls = capture(path, device)
    if "--dump" in argv:
        k = argv.index("--dump")
        dump(calls, argv[k + 1] if len(argv) > k + 1 else ".bench_cache")
        return 0
    from libav_tpu_torch.native import h264_cabac_host as CN

    nbytes = sum(len(c[2]) for c in calls)
    print(f"{len(calls)} slice calls captured, {nbytes} CABAC bytes")

    # one shared arena (all slices of an AU share it, like dec.py);
    # reset per AU exactly as the real path does (cur_slice == 0)
    a0 = calls[0]
    mb_w, mb_h = a0[3][0], a0[3][1]
    nmb = mb_w * mb_h
    arena, _c = CN.alloc(nmb)
    views = CN.views(arena, _c, nmb, mb_w, mb_h)
    coeffs = {csh: np.zeros(csh, np.int16) for _, csh, _, _, _ in calls}
    naus = sum(1 for c in calls if c[3][8] == 0)

    def run_all():
        for ash, csh, data, a, kw in calls:
            if a[8] == 0:               # cur_slice == 0: new AU
                CN.reset_arena(views)
            kw2 = dict(kw)
            if kw2.get("sctx") is not None:
                kw2["sctx"] = np.array(kw2["sctx"])
            r = CN.decode_slice(arena, coeffs[csh], data, *a, **kw2)
            if r not in (0,):
                raise RuntimeError(f"native rc={r}")

    run_all()
    ck = zlib.crc32(arena.tobytes())
    t0 = time.perf_counter()
    for _ in range(reps):
        run_all()
    dt = time.perf_counter() - t0
    ck2 = zlib.crc32(arena.tobytes())
    per_call = dt * 1000 / (reps * len(calls))
    per_frame = dt * 1000 / (reps * naus)
    print(f"entropy-only: {per_call:.3f} ms/call, {per_frame:.2f} ms/frame "
          f"({nbytes * reps / dt / 1e6:.1f} MB/s) "
          f"checksum={'stable' if ck == ck2 else 'UNSTABLE!'} {ck:08x}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
