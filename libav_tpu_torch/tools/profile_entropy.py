"""Host-entropy profiler of the port (counterpart of
`libav_tpu/tools/profile_entropy.py`): times ONLY the native CABAC slice
decode (the port's `native/cabac.c`) while the port's H264Decoder decodes
a stream, by wrapping native decode_slice with a timer.

Usage: python -m libav_tpu_torch.tools.profile_entropy [reps] [stream]

The decoder runs on the card; `main(argv, device="cpu")` runs it on the
CPU. The stream is the committed 1080p bench stream
(`libav_tpu_torch/testdata/h264_1080p_ipbb_cabac.h264pkts`, 8 AUs, the
encoder settings bench.py times) unless a path is given: 4-byte
big-endian length-prefixed AUs, or an Annex-B `.h264`/`.264` file, which
is split into AUs as the raw H.264 demuxer splits it.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from libav_tpu_torch.avutil import hwdevice


def bench_stream_path(path: Optional[str] = None) -> str:
    """path, or the committed bench stream."""
    if path:
        return path
    from libav_tpu_torch import testdata
    return testdata.SMOKE_STREAM


def load_packets(path: str) -> List[bytes]:
    """The AUs of a length-prefixed packet file or an Annex-B file."""
    if path.lower().endswith((".h264", ".264")):
        from libav_tpu_torch.formats.h264raw import split_access_units
        with open(path, "rb") as f:
            return list(split_access_units(f.read()))
    datas = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            datas.append(f.read(int.from_bytes(hdr, "big")))
    return datas


def main(argv: Optional[list] = None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 4
    datas = load_packets(bench_stream_path(argv[1] if len(argv) > 1
                                           else None))
    dev = hwdevice.device(device)

    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.codecs.h264 import H264Decoder
    from libav_tpu_torch.native import h264_cabac_host as CN

    ent = [0.0, 0]
    orig = CN.decode_slice

    def timed(*a, **kw):
        t1 = time.perf_counter()
        r = orig(*a, **kw)
        ent[0] += time.perf_counter() - t1
        ent[1] += 1
        return r

    dec = H264Decoder(CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="h264"), device=dev).open()

    def run_gop():
        dec._init()
        out = None
        for i, d in enumerate(datas):
            dec.send_packet(Packet(data=d, pts=i))
            out = dec._pump()
        return out

    run_gop()                      # warm up (builds the device programs)
    CN.decode_slice = timed
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_gop()
        dt = time.perf_counter() - t0
    finally:
        CN.decode_slice = orig
    nframes = reps * len(datas)
    print(f"entropy: {ent[0] * 1000 / nframes:.2f} ms/frame "
          f"({ent[1]} slice calls, "
          f"{ent[0] * 1000 / max(ent[1], 1):.2f} ms/call) | "
          f"wall total: {dt * 1000 / nframes:.2f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
